"""The port's offline workflow against the JAX reference: ``dump_phrases``'
driver options, the truecaser, the passage eval, and the three drivers
(dump → build index → evaluate, on the device or the host tier) on one
corpus and one set of weights,
mirroring tests/test_cli_pipeline.py:50-120. Each package gets its own
encoder directory, saved from the same weights through
``models/from_jax.py``."""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

from densephrases_tpu.cli import build_phrase_index as jax_build
from densephrases_tpu.cli import eval_phrase_retrieval as jax_eval
from densephrases_tpu.cli import generate_phrase_vecs as jax_gen
from densephrases_tpu.cli.common import save_encoder as jax_save_encoder
from densephrases_tpu.data.tokenization import WordPieceTokenizer as JaxTokenizer
from densephrases_tpu.data.truecase import TrueCaser as JaxTrueCaser
from densephrases_tpu.dump import dump_phrases as jax_dump
from densephrases_tpu.eval import passage as jax_passage
from densephrases_tpu.index.ivf import IVFIndex as JaxIVFIndex
from densephrases_tpu.models.bert import BertConfig as JaxBertConfig
from densephrases_tpu.models.encoder import init_encoder_params as jax_init
from densephrases_tpu_torch.cli import (
    build_phrase_index,
    eval_phrase_retrieval,
    generate_phrase_vecs,
)
from densephrases_tpu_torch.cli.common import save_encoder
from densephrases_tpu_torch.data.tokenization import SPECIAL_TOKENS, WordPieceTokenizer
from densephrases_tpu_torch.data.truecase import TrueCaser
from densephrases_tpu_torch.dump import dump_phrases
from densephrases_tpu_torch.eval import passage
from densephrases_tpu_torch.index.ivf import IVFIndex
from densephrases_tpu_torch.index.store import PhraseStore
from densephrases_tpu_torch.models.bert import BertConfig
from densephrases_tpu_torch.models.from_jax import encoder_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = [f"w{i}" for i in range(200)] + ["paris", "river", "ecole"]
SEQ, QUERY = "64", "16"


def _docs(n=8, seed=0):
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        paras = [" ".join(rng.choice(WORDS, int(rng.integers(20, 70))))
                 + " ." for _ in range(int(rng.integers(1, 4)))]
        docs.append({"doc_id": i, "title": f"Title {i}", "paragraphs": paras})
    return docs


def _same_store(port, ref):
    """Stores of the same docs from the same weights: the same layout and
    metadata, and int8 codes at most one step apart. Both towers run in
    bf16 (as test_torch_slice.py::test_dump_matches_reference holds): an
    element one bf16 ulp apart may round to the neighbouring int8 code,
    never further, for a small share of the elements."""
    np.testing.assert_array_equal(port.doc_bases, ref.doc_bases)
    np.testing.assert_array_equal(port.doc_ids, ref.doc_ids)
    for i in range(ref.num_docs):
        assert port.metas[i] == ref.metas[i]
    diff = np.abs(port.vecs.astype(np.int16) - ref.vecs.astype(np.int16))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() < 0.15


@pytest.fixture(scope="module")
def vocab():
    toks = SPECIAL_TOKENS + WORDS + ["title", "."] + [str(i) for i in range(10)]
    return {t: i for i, t in enumerate(toks)}


@pytest.fixture(scope="module")
def weights(vocab):
    jcfg = JaxBertConfig.tiny(vocab_size=len(vocab))
    cfg = BertConfig.tiny(vocab_size=len(vocab))
    jparams = jax_init(jax.random.PRNGKey(0), jcfg)
    params = encoder_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                              device="cpu")
    return jparams, jcfg, params, cfg


# ------------------------------------------------------ dump's options
def test_dump_options_match_reference(tmp_path, vocab, weights):
    jparams, jcfg, params, cfg = weights
    docs = _docs(seed=1)
    kw = dict(max_seq_length=64, batch_size=4, append_title=False,
              first_passage=True, tokenize_ahead=1)
    ref = jax_dump(jparams, jcfg, JaxTokenizer(vocab), docs,
                   str(tmp_path / "jax"), attn_impl="xla", **kw)
    stats = {}
    port = dump_phrases(params, cfg, WordPieceTokenizer(vocab), docs,
                        str(tmp_path / "port"), attn_impl="plain",
                        _stats=stats, **kw)
    _same_store(port, ref)
    for i, doc in enumerate(docs):  # the first paragraph alone, no title
        assert port.meta(i).context == doc["paragraphs"][0]
    assert stats["peak_open_docs"] >= 1


# --------------------------------------------------------- truecaser
SENTS = ["The River Paris flows past the Ecole .",
         "We saw Paris and the River today .",
         "a trip to Paris , then the River W3 ."]


def test_truecaser_matches_reference(tmp_path):
    port, ref = TrueCaser(), JaxTrueCaser()
    port.train(SENTS)
    ref.train(SENTS)
    texts = ["the river paris", "paris w3", "unknown words here",
             "to the ecole today"]
    for oov in ("title", "lower", "as-is"):
        assert [port.get_true_case(t, oov) for t in texts] == \
            [ref.get_true_case(t, oov) for t in texts]
    # each package loads the other's distribution file
    ref.save(str(tmp_path / "ref.pkl"))
    port.save(str(tmp_path / "port.pkl"))
    for a, b in ((TrueCaser(str(tmp_path / "ref.pkl")), ref),
                 (JaxTrueCaser(str(tmp_path / "port.pkl")), port)):
        assert [a.get_true_case(t) for t in texts] == \
            [b.get_true_case(t) for t in texts]


# ------------------------------------------------------- passage eval
def _results(rng, n_q=5, k=6):
    out = []
    for _ in range(n_q):
        ret = []
        for j in range(k):
            words = list(rng.choice(WORDS, 12))
            s = int(rng.integers(0, 40))
            ret.append({"context": " ".join(words), "title": [f"T{j}"],
                        "start_pos": s, "end_pos": s + 5,
                        "score": float(rng.normal())})
        out.append(ret)
    return out


@pytest.mark.parametrize("regex", [False, True])
def test_passage_eval_matches_reference(tmp_path, regex):
    rng = np.random.default_rng(3)
    results = _results(rng)
    answers = [[str(rng.choice(WORDS))] for _ in results]
    answers[0] = ["w1[0-9]"] if regex else [results[0][2]["context"][:2]]
    for ks in ((1, 5, 20, 100), (2, 3)):
        assert passage.evaluate_passages(results, answers, ks, regex) == \
            jax_passage.evaluate_passages(results, answers, ks, regex)
    assert passage.has_answer("The w1 River", ["river"]) == \
        jax_passage.has_answer("The w1 River", ["river"]) is True
    qs = [f"q{i}" for i in range(len(results))]
    rows = passage.to_fid_format(qs, answers, results, mark_phrase=True,
                                 out_path=str(tmp_path / "fid.json"))
    assert rows == jax_passage.to_fid_format(qs, answers, results,
                                             mark_phrase=True)
    assert json.load(open(tmp_path / "fid.json")) == rows


# ----------------------------------------------------- the three drivers
def _squad(docs):
    return {"data": [{"title": d["title"],
                      "paragraphs": [{"context": p} for p in d["paragraphs"]]}
                     for d in docs]}


def _qa(docs, rng, n=12):
    """Questions whose answers are corpus phrases."""
    rows = []
    for i in range(n):
        doc = docs[i % len(docs)]
        words = rng.choice(doc["paragraphs"]).split(" ")[:-1]
        s = int(rng.integers(0, len(words) - 3))
        ans = " ".join(words[s:s + int(rng.integers(1, 3))])
        q = " ".join(rng.choice(words, 5))
        rows.append({"id": f"q{i}", "question": q + "?", "answers": [ans]})
    return {"data": rows}


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory, vocab, weights):
    """Both packages' drivers: the dump from each package's encoder
    directory, the reference's index over its own dump, and the port's
    index over a copy of that dump."""
    ws = tmp_path_factory.mktemp("offline")
    jparams, jcfg, params, cfg = weights
    docs = _docs(n=10, seed=2)
    (ws / "corpus").mkdir()
    for i, part in enumerate((docs[:6], docs[6:])):  # a 2-file corpus
        json.dump(_squad(part), open(ws / "corpus" / f"part{i}.json", "w"))
    json.dump(_qa(docs, np.random.default_rng(4)), open(ws / "qa.json", "w"))
    jax_save_encoder(str(ws / "enc_jax"), jparams, jcfg, JaxTokenizer(vocab))
    save_encoder(str(ws / "enc_port"), params, cfg, WordPieceTokenizer(vocab))

    def gen_args(enc, dump):
        return ["--load_dir", str(ws / enc), "--data_dir", str(ws / "corpus"),
                "--predict_file", "0:2", "--dump_dir", str(ws / dump),
                "--max_seq_length", SEQ]
    out = {"ws": ws, "docs": docs}
    out["jstore"] = jax_gen.main(gen_args("enc_jax", "dump_jax"))
    out["pstore"] = generate_phrase_vecs.main(gen_args("enc_port", "dump_port"),
                                              device="cpu")
    shutil.copytree(ws / "dump_jax" / "phrase", ws / "dump_shared" / "phrase")
    build = ["--num_clusters", "16", "--fine_quant", "SQ8"]
    out["jindex"] = jax_build.main(["--dump_dir", str(ws / "dump_jax")]
                                   + build)
    out["pindex"] = build_phrase_index.main(
        ["--dump_dir", str(ws / "dump_shared")] + build, device="cpu")
    return out


def test_generate_phrase_vecs_matches_reference(pipeline):
    jstore, pstore = pipeline["jstore"], pipeline["pstore"]
    assert pstore.num_docs == len(pipeline["docs"])  # both files, in order
    _same_store(pstore, jstore)
    again = PhraseStore.load(str(pipeline["ws"] / "dump_port" / "phrase"))
    np.testing.assert_array_equal(again.vecs, pstore.vecs)


def test_build_phrase_index_matches_reference(pipeline):
    ws, ref, port = pipeline["ws"], pipeline["jindex"], pipeline["pindex"]
    name = os.path.join("start", "16_flat_SQ8")  # ref naming (:19-44)
    assert os.path.exists(ws / "dump_shared" / name / "ivf.pkl")
    assert port.n_total == ref.n_total == pipeline["jstore"].n_vecs
    np.testing.assert_allclose(port.centroids.numpy(),
                               np.asarray(ref.centroids), atol=1e-4)
    np.testing.assert_array_equal(port.codes.numpy(), np.asarray(ref.codes))
    # an existing index is loaded, not rebuilt
    again = build_phrase_index.main(
        ["--dump_dir", str(ws / "dump_shared"), "--num_clusters", "16",
         "--fine_quant", "SQ8"], device="cpu")
    np.testing.assert_array_equal(again.codes.numpy(), port.codes.numpy())


def _same_predictions(port, ref):
    """The same top prediction for every question, and the same top-k
    answers (in any order) for all but one."""
    assert [p[:1] for p in port] == [r[:1] for r in ref]
    same = [sorted(p) == sorted(r) for p, r in zip(port, ref)]
    assert sum(same) >= len(same) - 1, same


def _eval_args(ws, enc, index_name, save_dir, *extra):
    return ["--load_dir", str(ws / enc), "--dump_dir", str(ws / "dump_jax"),
            "--index_name", index_name, "--test_path", str(ws / "qa.json"),
            "--top_k", "5", "--eval_batch_size", "4",
            "--save_dir", str(ws / save_dir), "--max_seq_length", SEQ,
            "--max_query_length", QUERY, *extra]


@pytest.mark.parametrize("index_name", ["start/16_flat_SQ8", "start/none"])
def test_eval_phrase_retrieval_matches_reference(pipeline, index_name):
    # the same store and saved index under both packages' drivers; without
    # an index directory both serve a flat index
    ws = pipeline["ws"]
    tag = index_name.replace("/", "_")
    ref = jax_eval.main(_eval_args(ws, "enc_jax", index_name, f"j_{tag}"))
    out = eval_phrase_retrieval.main(
        _eval_args(ws, "enc_port", index_name, f"p_{tag}"), device="cpu")
    for key in ("em_top1", "em_topk", "f1_top1", "n"):
        assert out[key] == ref[key], key
    # the query towers' bf16 sums run in another order, so spans whose
    # scores nearly tie may trade places below the top one
    _same_predictions(out["predictions"], ref["predictions"])
    pred = "pred_qa.json_5.json"
    got = json.load(open(ws / f"p_{tag}" / pred))
    want = json.load(open(ws / f"j_{tag}" / pred))
    assert got.keys() == want.keys()
    _same_predictions([got[k]["prediction"] for k in want],
                      [want[k]["prediction"] for k in want])
    assert (ws / f"p_{tag}" / "eval_logger.txt").read_text() == \
        (ws / f"j_{tag}" / "eval_logger.txt").read_text()


def test_eval_psg_matches_reference(pipeline):
    ws = pipeline["ws"]
    extra = ("--eval_psg", "--psg_top_k", "10")
    ref = jax_eval.main(_eval_args(ws, "enc_jax", "start/16_flat_SQ8",
                                   "j_psg", *extra))
    out = eval_phrase_retrieval.main(
        _eval_args(ws, "enc_port", "start/16_flat_SQ8", "p_psg", *extra),
        device="cpu")
    assert out == ref and any(k.startswith("recall@") for k in out)
    fid = "fid_qa.json.json"
    got = json.load(open(ws / "p_psg" / fid))
    want = json.load(open(ws / "j_psg" / fid))
    assert [(r["question"], r["answers"]) for r in got] == \
        [(r["question"], r["answers"]) for r in want]
    _same_predictions([[(c["title"], c["text"]) for c in r["ctxs"]]
                       for r in got],
                      [[(c["title"], c["text"]) for c in r["ctxs"]]
                       for r in want])
    # span scores of O(100) from the queries of bf16 towers whose sums run
    # in another order: within a bf16 ulp (2^-8) of each other
    for g, w in zip(got, want):
        np.testing.assert_allclose(sorted(c["score"] for c in g["ctxs"]),
                                   sorted(c["score"] for c in w["ctxs"]),
                                   rtol=2 ** -8)


def test_eval_truecases_lowercase_questions(pipeline, tmp_path):
    ws = pipeline["ws"]
    caser = TrueCaser()
    caser.train(["a Paris and River ."])
    caser.save(str(tmp_path / "tc.pkl"))
    model = eval_phrase_retrieval.load_model(
        eval_phrase_retrieval.Options().parse(_eval_args(
            ws, "enc_port", "start/16_flat_SQ8", "p_tc", "--truecase_path",
            str(tmp_path / "tc.pkl")), groups=["model", "index", "retrieval",
                                              "data"]), device="cpu")
    assert isinstance(model.truecase, TrueCaser)
    assert model.truecase.get_true_case("the paris river") == "The Paris River"


@pytest.mark.parametrize("index_name", ["start/16_flat_SQ8", "start/none"])
def test_index_tier_host_matches_reference(pipeline, index_name):
    # --index_tier host in both packages: the memmapped store with a
    # TieredIVF over the saved index, or a TieredFlatIndex without one
    ws = pipeline["ws"]
    tag = "host_" + index_name.replace("/", "_")
    extra = ("--index_tier", "host")
    ref = jax_eval.main(_eval_args(ws, "enc_jax", index_name, f"j_{tag}",
                                   *extra))
    out = eval_phrase_retrieval.main(
        _eval_args(ws, "enc_port", index_name, f"p_{tag}", *extra),
        device="cpu")
    for key in ("em_top1", "em_topk", "f1_top1", "n"):
        assert out[key] == ref[key], key
    _same_predictions(out["predictions"], ref["predictions"])
    # and the device tier of the same driver, on the same index
    dev = eval_phrase_retrieval.main(
        _eval_args(ws, "enc_port", index_name, f"pd_{tag}"), device="cpu")
    _same_predictions(out["predictions"], dev["predictions"])


def test_opq_index_from_the_port_serves_three_ways(pipeline):
    # the port's driver builds OPQ8 over its own dump; the index serves
    # with the device refine, in decode mode and with the host refine
    ws = pipeline["ws"]
    build_phrase_index.main(["--dump_dir", str(ws / "dump_port"),
                             "--num_clusters", "16", "--fine_quant", "OPQ8"],
                            device="cpu")
    path = str(ws / "dump_port" / "start" / "16_flat_OPQ8")
    assert JaxIVFIndex.load(path).pq.m == 8  # the reference reads the save
    q = np.random.default_rng(5).standard_normal((6, 64)).astype(np.float32)
    ids = {}
    for mode in ("device", "none", "host"):
        index = IVFIndex.load(path, refine_mode=mode, device="cpu")
        ids[mode] = index.search(q, top_k=5, nprobe=16)[1]
    # the host refine re-ranks the same candidates as the device refine,
    # with fp32 queries where the device rounds them to bf16
    assert (ids["host"] == ids["device"]).mean() >= 0.9
    # no refine: the PQ ranking alone, still mostly the same rows
    assert np.mean([len(set(a) & set(b)) / 5 for a, b in
                    zip(ids["none"].tolist(), ids["device"].tolist())]) >= 0.5


def test_drivers_import_no_jax():
    code = ("import sys\n"
            "import densephrases_tpu_torch.cli.generate_phrase_vecs, "
            "densephrases_tpu_torch.cli.build_phrase_index, "
            "densephrases_tpu_torch.cli.eval_phrase_retrieval, "
            "densephrases_tpu_torch.data.truecase, "
            "densephrases_tpu_torch.eval.passage\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'densephrases_tpu' or m.startswith('densephrases_tpu.')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
