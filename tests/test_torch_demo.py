"""The port's demo servers and ``run_demo`` against the JAX package's: the
tornado apps and the port's ``http.server`` apps on one store and one set
of weights, each served in a thread on a free port and queried over real
sockets; the two-process mode, the reader, the benchmark client, the
driver's modes, and one request at a time."""

import dataclasses
import json
import os
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from densephrases_tpu.cli import run_demo as jax_run_demo
from densephrases_tpu.data.tokenization import WordPieceTokenizer as JaxTokenizer
from densephrases_tpu.dump import dump_phrases as jax_dump
from densephrases_tpu.index.search import MIPS as JaxMIPS
from densephrases_tpu.index.store import PhraseStore as JaxPhraseStore
from densephrases_tpu.model import DensePhrases as JaxDensePhrases
from densephrases_tpu.models.bert import BertConfig as JaxBertConfig
from densephrases_tpu.models.encoder import init_encoder_params as jax_init
from densephrases_tpu.serve import server as jax_server
from densephrases_tpu.train.cross_encoder import init_cross_params as jax_init_cross
from densephrases_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from densephrases_tpu_torch.cli import run_demo
from densephrases_tpu_torch.cli.common import save_encoder
from densephrases_tpu_torch.data.tokenization import SPECIAL_TOKENS, WordPieceTokenizer
from densephrases_tpu_torch.data.truecase import TrueCaser
from densephrases_tpu_torch.eval.reader import read_passages
from densephrases_tpu_torch.index.flat import FlatIndex
from densephrases_tpu_torch.index.search import MIPS
from densephrases_tpu_torch.index.store import PhraseStore
from densephrases_tpu_torch.model import DensePhrases
from densephrases_tpu_torch.models.bert import BertConfig
from densephrases_tpu_torch.models.from_jax import cross_from_jax, encoder_from_jax
from densephrases_tpu_torch.parallel import make_mesh
from densephrases_tpu_torch.serve import server
from densephrases_tpu_torch.serve.fused import FusedServer
from densephrases_tpu_torch.utils.checkpoint import save_checkpoint
from tests.test_serve import _free_port, _serve_in_thread

WORDS = [f"w{i}" for i in range(120)] + ["paris", "river", "tower"]
UNITS = ["phrase", "sentence", "paragraph", "document"]
QUERIES = ["w3 w4 paris", "river w9", "end of para w2 w7"]
SCORE_RTOL = 2e-2  # chip_smoke.py's kernel-vs-plain serve tolerance


def _docs(n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [{"doc_id": 10 + i, "title": f"Title {i}", "paragraphs": [
        " ".join(rng.choice(WORDS, int(rng.integers(20, 60)))) + ". End, of para."
        for _ in range(int(rng.integers(1, 3)))]} for i in range(n)]


def _qa(docs, n, seed):
    rng = np.random.default_rng(seed)
    pairs = []
    for i in range(n):
        words = docs[i % len(docs)]["paragraphs"][0].split(" ")[:-3]
        s = int(rng.integers(0, len(words) - 2))
        pairs.append((" ".join(rng.choice(words, 4)), [words[s]]))
    return pairs


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}") as r:
        return r.status, r.read()


def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req) as r:
        return json.loads(r.read())


class _Served:
    """The port's app on a free port in a thread, shut down on exit."""

    def __init__(self, app):
        self.server = server.make_server(app, 0)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()


def _jax_served(app):
    port = _free_port()
    _serve_in_thread(app, port)
    return port


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("demo")
    toks = SPECIAL_TOKENS + WORDS + ["end", "of", "para", "title", ".", ","] \
        + [str(i) for i in range(10)]
    vocab = {t: i for i, t in enumerate(toks)}
    docs = _docs()
    jcfg = JaxBertConfig.tiny(vocab_size=len(vocab))
    cfg = BertConfig.tiny(vocab_size=len(vocab))
    jparams = jax_init(jax.random.PRNGKey(0), jcfg)
    params = encoder_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                              device="cpu")
    path = str(tmp / "dump" / "phrase")
    jax_dump(jparams, jcfg, JaxTokenizer(vocab), docs, path,
             max_seq_length=64, batch_size=4, attn_impl="xla")
    jmodel = JaxDensePhrases(jparams, jcfg, JaxTokenizer(vocab),
                             JaxMIPS(JaxPhraseStore.load(path)),
                             max_query_length=16)
    tok = WordPieceTokenizer(vocab)
    model = DensePhrases(params, cfg, tok,
                         MIPS(PhraseStore.load(path), device="cpu"),
                         max_query_length=16)
    save_encoder(str(tmp / "enc"), params, cfg, tok)
    # the reader pads to the reference's 384 tokens
    jxcfg = dataclasses.replace(jcfg, max_position_embeddings=384)
    xcfg = dataclasses.replace(cfg, max_position_embeddings=384)
    jcross = jax_init_cross(jax.random.PRNGKey(1), jxcfg)
    cross = cross_from_jax(jax.tree.map(np.asarray, jcross), xcfg,
                           device="cpu")
    return {"tmp": tmp, "vocab": vocab, "docs": docs, "jcfg": jcfg,
            "cfg": cfg, "jmodel": jmodel, "model": model, "tok": tok,
            "jxcfg": jxcfg, "xcfg": xcfg, "jcross": jcross, "cross": cross,
            "path": path}


@pytest.fixture(scope="module")
def apps(demo):
    """Each package's index app over the same store and weights, serving."""
    jport = _jax_served(jax_server.make_index_app(
        demo["jmodel"], examples=["where is paris"]))
    with _Served(server.make_index_app(
            demo["model"], examples=["where is paris"])) as served:
        yield {"jax": jport, "port": served.port}


def _hits(ret):
    return [(h["answer"], h["title"], h["context"], h["start_pos"],
             h["end_pos"]) for h in ret]


def _same_results(got, want):
    assert got["answers"] == want["answers"]
    for g, w in zip(got["ret"], want["ret"]):
        assert _hits(g) == _hits(w)
        np.testing.assert_allclose([h["score"] for h in g],
                                   [h["score"] for h in w], rtol=SCORE_RTOL)


@pytest.mark.parametrize("unit", UNITS)
def test_index_app_matches_reference(apps, unit):
    # phrase: each package's fused route; the other units: the modular one
    for q in QUERIES[:2]:
        path = (f"/api?query={urllib.request.quote(q)}&top_k=3"
                f"&retrieval_unit={unit}")
        got, want = (json.loads(_get(apps[k], path)[1]) for k in ("port", "jax"))
        assert got.keys() == want.keys() == {"ret", "answers", "time"}
        _same_results({"answers": [got["answers"]], "ret": [got["ret"]]},
                      {"answers": [want["answers"]], "ret": [want["ret"]]})
        assert got["answers"]
    body = {"query": QUERIES, "top_k": 3, "retrieval_unit": unit}
    got, want = (_post(apps[k], "/batch_api", body) for k in ("port", "jax"))
    assert got.keys() == want.keys() and len(got["ret"]) == len(QUERIES)
    for ret in got["ret"]:
        assert {k for h in ret for k in h} == {
            "answer", "context", "title", "score", "start_pos", "end_pos"}
    _same_results(got, want)


def test_index_app_routes(apps):
    status, page = _get(apps["port"], "/")
    assert status == 200 and b"/api?query=" in page
    assert _get(apps["port"], "/index.html")[1] == page
    assert json.loads(_get(apps["port"], "/get_examples")[1]) == \
        json.loads(_get(apps["jax"], "/get_examples")[1])
    for path in ("/no_such_file", "/../server.py"):
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(apps["port"], path)
        assert err.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as err:
        _get(apps["port"], "/batch_api")  # POST only, as in tornado
    assert err.value.code == 405


def test_query2vec_api_matches_reference(demo):
    jport = _jax_served(jax_server.make_query_encoder_app(demo["jmodel"]))
    with _Served(server.make_query_encoder_app(demo["model"])) as served:
        got = _post(served.port, "/query2vec_api", {"query": QUERIES})
        want = _post(jport, "/query2vec_api", {"query": QUERIES})
        one = json.loads(_get(served.port,
                              "/query2vec_api?query=river+w9")[1])
        single = _post(served.port, "/query2vec_api", {"query": "river w9"})
    got, want = np.asarray(got["vec"]), np.asarray(want["vec"])
    assert got.shape == want.shape == (3, 2 * demo["cfg"].hidden_size)
    # the bound of test_torch_bert.py::test_embed_query_matches_bf16: bf16
    # towers in both packages, a value one bf16 ulp apart carried onward
    diff = np.abs(got - want)
    assert diff.max() < 0.05 and diff.mean() < 1e-2, (diff.max(), diff.mean())
    local = demo["model"].query2vec(QUERIES).float().numpy()
    np.testing.assert_array_equal(got, local)  # fp32 through JSON exactly
    np.testing.assert_array_equal(one["vec"], single["vec"])
    np.testing.assert_array_equal(np.asarray(one["vec"])[0], got[1])


@pytest.mark.parametrize("unit", UNITS)
def test_two_process_mode_equals_the_modular_route(demo, unit):
    model = demo["model"]
    with _Served(server.make_query_encoder_app(model)) as q_serve:
        remote = server.RemoteQueryEncoder("127.0.0.1", q_serve.port)
        with _Served(server.make_index_app(model, remote_encoder=remote)) \
                as p_serve, \
                _Served(server.make_index_app(model, fused=False)) as modular:
            body = {"query": QUERIES, "top_k": 4, "retrieval_unit": unit}
            got = _post(p_serve.port, "/batch_api", body)
            want = _post(modular.port, "/batch_api", body)
    got.pop("time"), want.pop("time")
    assert got == want


def test_mips_search_takes_numpy_queries(demo):
    mips = demo["model"].mips
    q = np.random.default_rng(5).standard_normal(
        (2, 2 * demo["cfg"].hidden_size)).astype(np.float32)
    a = mips.search(q, q_texts=["a", "b"], top_k=4, aggregate=True)
    b = mips.search(torch.from_numpy(q), q_texts=["a", "b"], top_k=4,
                    aggregate=True)
    assert a == b and all(a)


def test_reader_app_matches_reference(demo):
    docs = demo["docs"]
    passages = [d["paragraphs"][0] for d in docs[:3]]
    questions = ["w3 w4 ?", "where is the river", "w10"]
    jport = _jax_served(jax_server.make_reader_app(
        demo["jcross"], demo["jxcfg"], JaxTokenizer(demo["vocab"]),
        attn_impl="xla"))
    with _Served(server.make_reader_app(demo["cross"], demo["xcfg"],
                                       demo["tok"])) as served:
        body = {"question": questions, "passage": passages}
        got = _post(served.port, "/single_api", body)
        want = _post(jport, "/single_api", body)
        one = _post(served.port, "/single_api",
                    {"question": questions[0], "passage": passages[0]})
    assert got.keys() == want.keys() == {"ret", "time"}
    for g, w in zip(got["ret"], want["ret"]):
        assert {k: g[k] for k in g if k != "score"} == \
            {k: w[k] for k in w if k != "score"}
        np.testing.assert_allclose(g["score"], w["score"], rtol=SCORE_RTOL,
                                   atol=1e-3)
    assert one["ret"] == got["ret"][:1]


def test_eval_request_same_em_on_both_servers(demo, apps):
    pairs = _qa(demo["docs"], 14, 3)
    got = server.eval_request("127.0.0.1", apps["port"], pairs, batch_size=2,
                              top_k=3)
    want = jax_server.eval_request("127.0.0.1", apps["jax"], pairs,
                                   batch_size=2, top_k=3)
    for key in ("em_top1", "em_topk", "f1_top1", "n"):
        assert got[key] == want[key], key
    assert np.isfinite(got["qps"]) and got["qps"] > 0  # 2 of 7 batches timed
    few = server.eval_request("127.0.0.1", apps["port"], pairs[:4],
                              batch_size=2, top_k=3)
    assert np.isnan(few["qps"])  # every batch is warmup


def test_requests_are_served_one_after_the_other():
    spans, lock = [], threading.Lock()

    class Slow:
        def query2vec(self, queries):
            t0 = time.perf_counter()
            time.sleep(0.2)
            with lock:
                spans.append((t0, time.perf_counter()))
            return torch.zeros(len(queries), 4)

    with _Served(server.make_query_encoder_app(Slow())) as served:
        outs = []
        threads = [threading.Thread(target=lambda: outs.append(_post(
            served.port, "/query2vec_api", {"query": ["q"]})))
            for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in threads)
    assert len(outs) == 3 and all(o["vec"] == [[0.0] * 4] for o in outs)
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:])), spans


def test_served_results_hold_json_values_only(demo):
    """What the apps serialize: every value of the port's result dicts is a
    JSON type as it stands (``_json_default`` is never needed for them), and
    numpy values convert as in the reference."""
    model = demo["model"]
    for unit in UNITS:
        _, rets = model.search(QUERIES, retrieval_unit=unit, top_k=3,
                               return_meta=True)
        json.dumps(rets)  # raises on any non-JSON value
    json.dumps(FusedServer(model).search(QUERIES, top_k=3))
    json.dumps(read_passages(demo["cross"], demo["xcfg"], demo["tok"],
                             ["w3"], [demo["docs"][0]["paragraphs"][0]]))
    values = {"i": np.int32(3), "f": np.float32(0.5), "a": np.arange(3)}
    assert json.dumps(values, default=server._json_default) == \
        json.dumps(values, default=jax_server._json_default)
    with pytest.raises(TypeError):
        json.dumps({"x": object()}, default=server._json_default)


def test_handler_error_answers_500_and_keeps_serving():
    def fail(req):
        raise RuntimeError("boom")

    app = server.App({"/fail": {"GET": fail},
                      "/ok": {"GET": lambda req: json.dumps({
                          "q": req.get_argument("q", "none")})}})
    with _Served(app) as served:
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(served.port, "/fail")
        assert err.value.code == 500
        assert json.loads(_get(served.port, "/ok?q=+a+b+&q=c+d")[1]) == {
            "q": "c d"}  # tornado's rule: the last value, stripped


# ------------------------------------------------------- FusedServer repairs
def test_fused_route_truecases_like_the_modular_route(demo):
    model = demo["model"]
    caser = TrueCaser()
    caser.train(["the River W9 flows .", "a River and W9 ."])
    cased = DensePhrases(model.params, model.config, model.tokenizer,
                         model.mips, 16, caser)
    fused = FusedServer(cased)
    queries = ["river w9", "w3 w4 paris"]
    seen = []
    encode = cased.query2vec
    cased.query2vec = lambda qs: (seen.extend(qs), encode(qs))[1]
    out_f = fused.search(queries, top_k=3)
    _, out_m = cased.search(queries, top_k=3, return_meta=True)
    assert seen[:2] == seen[2:] and seen[0] == "River W9"
    key = lambda rr: [[(r["doc_idx"], r["start_idx"], r["end_idx"])
                       for r in r_[:3]] for r_ in rr]
    assert key(out_f) == key(out_m)
    seen.clear()
    fused.search(queries, top_k=3, truecase=False)
    assert seen == queries


def test_fused_server_refuses_a_mesh_index(demo):
    store = demo["model"].mips.store
    index = FlatIndex(store.vecs, store.offset, store.scale,
                      mesh=make_mesh(axis="shard", devices=["cpu"]))
    model = demo["model"]
    meshed = DensePhrases(model.params, model.config, model.tokenizer,
                          MIPS(store, index=index), 16)
    with pytest.raises(AssertionError, match="single-device"):
        FusedServer(meshed)
    # the index app takes the modular route for it
    app = server.make_index_app(meshed)
    with _Served(app) as served:
        out = _post(served.port, "/batch_api", {"query": QUERIES, "top_k": 3})
    _, want = model.search(QUERIES, top_k=3, return_meta=True)
    assert out["answers"] == [[r["answer"] for r in w] for w in want]


# ------------------------------------------------------------- run_demo
@pytest.fixture
def demo_main(monkeypatch):
    """``run_demo.main`` in a thread, its server handed back for shutdown."""
    started = []
    real = server.serve
    monkeypatch.setattr(run_demo, "serve",
                        lambda app, port: real(app, port,
                                               started=started.append))
    threads = []

    def start(argv):
        t = threading.Thread(target=run_demo.main, args=(argv,),
                             kwargs={"device": "cpu"}, daemon=True)
        t.start()
        threads.append(t)
        for _ in range(200):
            if len(started) == len(threads):
                return started[-1].server_address[1]
            time.sleep(0.05)
        raise AssertionError("run_demo did not start serving")

    yield start
    for s in started:
        s.shutdown()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()


def _flags(demo, mode, *extra):
    return ["--demo_mode", mode, "--load_dir", str(demo["tmp"] / "enc"),
            "--dump_dir", str(demo["tmp"] / "dump"), "--max_query_length",
            "16", *extra]


@pytest.mark.parametrize("mode", ["single_serve", "serve"])
def test_run_demo_single_serve_on_the_cpu(demo, demo_main, mode):
    port = _free_port()
    assert demo_main(_flags(demo, mode, "--index_port", str(port),
                            "--top_k", "3")) == port
    got = json.loads(_get(port, "/api?query=river+w9")[1])
    _, want = demo["model"].search("river w9", top_k=3, return_meta=True)
    assert got["answers"] == [r["answer"] for r in want]
    pairs = _qa(demo["docs"], 8, 1)
    qa = demo["tmp"] / f"qa_{mode}.json"
    qa.write_text(json.dumps({"data": [
        {"id": f"q{i}", "question": q, "answers": a}
        for i, (q, a) in enumerate(pairs)]}))
    metrics = run_demo.main(
        ["--demo_mode", "eval_request", "--index_port", str(port),
         "--test_path", str(qa), "--eval_batch_size", "1", "--top_k", "3"],
        device="cpu")
    direct = server.eval_request("127.0.0.1", port, pairs, batch_size=1,
                                 top_k=3)
    for key in ("em_top1", "em_topk", "n"):
        assert metrics[key] == direct[key]


def test_run_demo_two_process_modes(demo, demo_main):
    q_port, p_port = _free_port(), _free_port()
    assert demo_main(_flags(demo, "q_serve", "--query_port",
                            str(q_port))) == q_port
    assert demo_main(_flags(demo, "p_serve", "--query_port", str(q_port),
                            "--index_port", str(p_port), "--top_k",
                            "3")) == p_port
    got = _post(p_port, "/batch_api", {"query": QUERIES,
                                       "retrieval_unit": "document"})
    want, _ = demo["model"].search(QUERIES, retrieval_unit="document",
                                   top_k=3, return_meta=True)
    assert got["answers"] == want


def test_run_demo_serve_bert_reads_the_teacher_save(demo, demo_main):
    """The port serves a teacher saved as ``train_cross_encoder`` saves it;
    the reference's ``serve_bert`` loads the directory as an encoder first
    and fails on that save (ROADMAP Queue 3)."""
    tmp = demo["tmp"]
    # train_cross_encoder's layout: config.json, vocab.txt, params/ of the
    # cross-encoder
    os.makedirs(tmp / "teacher")
    (tmp / "teacher" / "config.json").write_text(json.dumps(
        demo["xcfg"].__dict__))
    demo["tok"].save_vocab(str(tmp / "teacher" / "vocab.txt"))
    save_checkpoint(str(tmp / "teacher" / "params"), demo["cross"], step=0)
    port = _free_port()
    assert demo_main(["--demo_mode", "serve_bert", "--load_dir",
                      str(tmp / "teacher"), "--index_port", str(port)]) == port
    body = {"question": ["w3 w4 ?"], "passage": [demo["docs"][0]["paragraphs"][0]]}
    got = _post(port, "/single_api", body)
    want = read_passages(demo["cross"], demo["xcfg"], demo["tok"],
                         body["question"], body["passage"])
    assert got["ret"] == json.loads(json.dumps(want))

    jdir = tmp / "jax_teacher"
    os.makedirs(jdir)
    (jdir / "config.json").write_text(json.dumps(demo["jxcfg"].__dict__))
    JaxTokenizer(demo["vocab"]).save_vocab(str(jdir / "vocab.txt"))
    jax_save_checkpoint(str(jdir / "params"), demo["jcross"], step=0)
    with pytest.raises(ValueError, match="tree structures do not match"):
        jax_run_demo.main(["--demo_mode", "serve_bert", "--load_dir",
                           str(jdir), "--index_port", str(_free_port())])


def test_run_demo_unknown_mode_exits_as_the_reference():
    with pytest.raises(SystemExit, match="unknown demo_mode nope") as port:
        run_demo.main(["--demo_mode", "nope"], device="cpu")
    with pytest.raises(SystemExit, match="unknown demo_mode nope") as ref:
        jax_run_demo.main(["--demo_mode", "nope"])
    assert str(port.value) == str(ref.value)
