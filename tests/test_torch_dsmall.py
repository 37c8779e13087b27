"""The port's trained-vector tools against the JAX package's, on the CPU at
a small size: ``dsmall`` (the local corpus, the document-held-out split,
cloze QA, the nested corpora, the metrics, and its driver end to end),
``bench_serve_real`` (flat EM@1 and the served ids on one store and one
converted encoder) and ``bench_ivf_real`` (the quantizer grid's recall).

One JAX encoder (tiny, seeded) is saved and converted by
``convert_jax_checkpoint.py``; the JAX package dumps the store both read."""

import json
import os
import sys

import jax
import numpy as np
import pytest

import convert_jax_checkpoint
from densephrases_tpu.cli.common import load_encoder as jax_load_encoder
from densephrases_tpu.cli.common import save_encoder as jax_save_encoder
from densephrases_tpu.data.tokenization import WordPieceTokenizer as JaxTokenizer
from densephrases_tpu.dump import dump_phrases as jax_dump
from densephrases_tpu.index.search import MIPS as JaxMIPS
from densephrases_tpu.index.store import PhraseStore as JaxPhraseStore
from densephrases_tpu.model import DensePhrases as JaxDensePhrases
from densephrases_tpu.models.bert import BertConfig as JaxBertConfig
from densephrases_tpu.models.encoder import init_encoder_params as jax_init
from densephrases_tpu.preprocess import offline_corpus as jax_corpus
from densephrases_tpu.tools import bench_ivf_real as jax_ivf_real
from densephrases_tpu.tools import bench_serve_real as jax_serve_real
from densephrases_tpu.tools import dsmall as jax_dsmall
from densephrases_tpu_torch.cli.common import load_encoder
from densephrases_tpu_torch.data.tokenization import whole_word_vocab
from densephrases_tpu_torch.index.search import MIPS
from densephrases_tpu_torch.index.store import PhraseStore
from densephrases_tpu_torch.model import DensePhrases
from densephrases_tpu_torch.preprocess.offline_corpus import build_corpus_docs
from densephrases_tpu_torch.tools import bench_ivf_real, bench_serve_real
from densephrases_tpu_torch.tools import dsmall

SCALES = (12, 40)
# two builds of one grid, one a package: the same k-means draws, so the
# same lists but for near-ties; stated bar on recall@20
REAL_RECALL_ATOL = 0.05

NAMES = ["Paris", "London", "Warsaw", "Berlin", "Vienna", "Madrid", "Rome",
         "Lisbon", "Prague", "Dublin", "Oslo", "Athens"]
NOUNS = ["river", "bridge", "garden", "museum", "library", "harbor",
         "castle", "market", "station", "theater", "tower", "square"]
VERBS = ["crosses", "borders", "faces", "shelters", "joins", "overlooks"]


def _paragraph(rng):
    sents = []
    for _ in range(4):
        a, b = rng.choice(NAMES, 2, replace=False)
        n1, n2 = rng.choice(NOUNS, 2, replace=False)
        sents.append(f"The {n1} of {a} {rng.choice(VERBS)} the old {n2} "
                     f"near {b} in {int(rng.integers(1500, 2000))}.")
    return " ".join(sents)


def _write_tree(root, rng, n_py=10, n_md=10):
    """Source files whose docstrings, and .md files whose paragraphs, are
    prose; one paragraph repeats across two files (deduplicated)."""
    dup = _paragraph(rng)
    os.makedirs(os.path.join(root, "pkg"))
    os.makedirs(os.path.join(root, "md", "sub"))
    for i in range(n_py):
        pars = [_paragraph(rng) for _ in range(3)] + ([dup] if i < 2 else [])
        doc = "\n\n".join(pars)
        with open(os.path.join(root, "pkg", f"mod{i}.py"), "w") as f:
            f.write(f'"""{doc}"""\n\n\ndef f():\n    """{_paragraph(rng)}"""\n')
    for i in range(n_md):
        pars = [_paragraph(rng) for _ in range(3)]
        sub = "sub" if i % 2 else ""
        with open(os.path.join(root, "md", sub, f"doc{i}.md"), "w") as f:
            f.write(f"# Title {i}\n\n" + "\n\n".join(pars) + "\n")
    return dup


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dsmall")
    rng = np.random.default_rng(0)
    dup = _write_tree(str(tmp / "src"), rng)
    corpus_path = str(tmp / "corpus_docs.json")
    docs = dsmall.local_corpus_docs(corpus_path,
                                    roots=[str(tmp / "src" / "pkg")],
                                    md_roots=[str(tmp / "src" / "md")])
    texts = [p for d in docs for p in d["paragraphs"]]
    vocab = whole_word_vocab(texts, vocab_size=400)
    jcfg = JaxBertConfig.tiny(vocab_size=len(vocab))
    jparams = jax_init(jax.random.PRNGKey(0), jcfg)
    jax_save_encoder(str(tmp / "jax_enc"), jparams, jcfg, JaxTokenizer(vocab))
    assert convert_jax_checkpoint.main(
        ["--kind", "encoder", str(tmp / "jax_enc"), str(tmp / "port_enc")]) == 0
    # the split, QA and the largest corpus, written as dsmall lays them out
    train_docs, dev_docs = jax_dsmall.split_docs(docs, 6)
    dev_ex = jax_dsmall.build_qa(dev_docs, 3, seed=0)
    train_ex = jax_dsmall.build_qa(train_docs, 3, seed=0, max_pars=40)
    work = tmp / "work"
    os.makedirs(work)
    (work / "qa_doc_split.json").write_text(
        json.dumps({"train": train_ex, "dev": dev_ex}))
    corpus = jax_dsmall.nested_corpora(dev_docs, train_docs, SCALES)[-1]
    store_dir = str(work / f"store_pars{SCALES[-1]}")
    jax_dump(jparams, jcfg, JaxTokenizer(vocab),
             [{"doc_id": i, "title": d["title"],
               "paragraphs": d["paragraphs"]} for i, d in enumerate(corpus)],
             store_dir, max_seq_length=64, batch_size=8, attn_impl="xla")
    return {"tmp": tmp, "docs": docs, "dup": dup, "corpus_path": corpus_path,
            "vocab": vocab, "work": work, "store": store_dir,
            "dev_ex": dev_ex, "train_ex": train_ex}


def test_local_corpus_docs(world):
    docs = world["docs"]
    titles = [d["title"] for d in docs]
    assert sum(t.startswith("pkg:") or t.startswith("pkg/") for t in
               titles) == 10
    assert "sub/doc1.md" in titles and "doc0.md" in titles
    pars = [p for d in docs for p in d["paragraphs"]]
    assert pars.count(world["dup"]) == 1 and len(pars) == len(set(pars))
    # build_corpus_docs returns the cached file as it is (no upstream files)
    assert build_corpus_docs(out_path=world["corpus_path"]) == docs
    assert jax_corpus.build_corpus_docs(out_path=world["corpus_path"]) == docs
    # a second call reads the file
    assert dsmall.local_corpus_docs(world["corpus_path"], roots=[]) == docs


def test_split_qa_nested_match_the_reference(world):
    docs = world["docs"]
    got = dsmall.split_docs(docs, 6)
    assert got == jax_dsmall.split_docs(docs, 6)
    train_docs, dev_docs = got
    assert dev_docs and train_docs
    for per_par, max_pars in ((3, 0), (2, 9)):
        assert (dsmall.build_qa(train_docs, per_par, seed=1,
                                max_pars=max_pars)
                == jax_dsmall.build_qa(train_docs, per_par, seed=1,
                                       max_pars=max_pars))
    assert (dsmall.nested_corpora(dev_docs, train_docs, SCALES)
            == jax_dsmall.nested_corpora(dev_docs, train_docs, SCALES))
    rc_train, rc_dev = dsmall.split_rc(world["train_ex"])
    assert len(rc_train) + len(rc_dev) == len(world["train_ex"])


def _models(world):
    jparams, jcfg, jtok = jax_load_encoder(str(world["tmp"] / "jax_enc"))
    params, cfg, tok = load_encoder(str(world["tmp"] / "port_enc"),
                                    device="cpu")
    jdp = JaxDensePhrases(jparams, jcfg, jtok,
                          JaxMIPS(JaxPhraseStore.load(world["store"])),
                          max_query_length=24)
    dp = DensePhrases(params, cfg, tok,
                      MIPS(PhraseStore.load(world["store"]), device="cpu"),
                      max_query_length=24)
    return jdp, dp


def test_metrics_match_the_reference(world):
    jdp, dp = _models(world)
    got, want = (dsmall._metrics(dp, world["dev_ex"]),
                 jax_dsmall._metrics(jdp, world["dev_ex"]))
    for k in ("em_top1", "em_top10", "f1_top1", "f1_top10", "n"):
        assert got[k] == want[k], k


def test_serve_real_flat_em_and_ids_match_the_reference(world, monkeypatch):
    out = str(world["tmp"] / "serve_real.json")
    res = bench_serve_real.main(
        ["--store", world["store"], "--encoder",
         str(world["tmp"] / "port_enc"), "--batch", "4", "--out", out],
        device="cpu")
    jout = str(world["tmp"] / "jax_serve_real.json")
    monkeypatch.setattr(sys, "argv", [
        "bench_serve_real", "--store", world["store"], "--encoder",
        str(world["tmp"] / "jax_enc"), "--batch", "4", "--out", jout,
        "--workdir", str(world["tmp"] / "jax_cache")])
    jax_serve_real.main()
    with open(jout) as f:
        want = json.load(f)["flat"]
    assert res["dev_em1"] == want["dev_em1"]
    assert res["dev_em1_n"] == want["dev_em1_n"] > 0
    # the ids of every served top-1, against the reference's serve loop
    jdp, dp = _models(world)
    qs, golds = bench_serve_real.load_dev(
        str(world["work"] / "qa_doc_split.json"))
    batches = bench_serve_real.dev_batches(qs, golds, 4)
    got = bench_serve_real.em_at_1(dp, batches, 64)
    want_ids = []
    for bq, _ in batches:
        outs = jdp.mips.search(jdp.query2vec(bq), q_texts=bq, top_k=1,
                               nprobe=64, aggregate=True)
        want_ids += [(r[0]["doc_idx"], r[0]["start_idx"], r[0]["end_idx"])
                     if r else None for r in outs]
    assert got["ids"] == want_ids
    assert set(res["stages_ms"]) == {"encode", "search",
                                     "rescore_assemble_real_meta"}
    assert res["meta_preload_s"] >= 0 and res["qps"] > 0


def test_ivf_real_recall_matches_the_reference(world, monkeypatch):
    args = ["--store", world["store"], "--nlist", "8", "--nq", "16",
            "--quants", "SQ8,OPQ", "--probes", "2,8"]
    got = bench_ivf_real.main(
        args + ["--encoder", str(world["tmp"] / "port_enc"), "--workdir",
                str(world["tmp"] / "port_ivf"), "--out",
                str(world["tmp"] / "port_ivf.json")], device="cpu")
    jout = str(world["tmp"] / "jax_ivf.json")
    monkeypatch.setattr(sys, "argv", ["bench_ivf_real"] + args + [
        "--encoder", str(world["tmp"] / "jax_enc"), "--workdir",
        str(world["tmp"] / "jax_ivf"), "--out", jout])
    jax_ivf_real.main()
    with open(jout) as f:
        want = json.load(f)["real_vectors"]
    assert got["n"] == want["n"] and got["d"] == want["d"] == 64
    assert got["n_queries"] == want["n_queries"] == 16
    for key in ("ivf_SQ8", "ivf_OPQ8"):
        for p in ("p2", "p8"):
            for k in ("recall20", "recall20_norefine"):
                if k in want[key][p]:
                    assert abs(got[key][p][k] - want[key][p][k]) \
                        <= REAL_RECALL_ATOL, (key, p, k)
    assert "recall20_norefine" in got["ivf_OPQ8"]["p2"]
    # the saves land where bench_serve_real reads them
    store = PhraseStore.load(world["store"])
    assert os.path.exists(os.path.join(bench_ivf_real.index_dir(
        str(world["tmp"] / "port_ivf"), "OPQ", store.n_vecs, store.dim),
        "save.done"))


def test_serve_real_over_a_grid_index(world):
    bench_ivf_real.main(
        ["--store", world["store"], "--encoder",
         str(world["tmp"] / "port_enc"), "--nlist", "8", "--nq", "8",
         "--quants", "SQ8", "--probes", "8", "--workdir",
         str(world["tmp"] / "grid"), "--out",
         str(world["tmp"] / "grid.json")], device="cpu")
    res = bench_serve_real.main(
        ["--store", world["store"], "--encoder",
         str(world["tmp"] / "port_enc"), "--index", "SQ8", "--nprobe", "8",
         "--batch", "4", "--workdir", str(world["tmp"] / "grid"), "--out",
         str(world["tmp"] / "serve_sq8.json")], device="cpu")
    flat = bench_serve_real.main(
        ["--store", world["store"], "--encoder",
         str(world["tmp"] / "port_enc"), "--batch", "4", "--out",
         str(world["tmp"] / "serve_flat.json")], device="cpu")
    # nprobe = nlist scans every list, and both rescore the store's own
    # int8 vectors: SQ8 serves the flat index's top-1 span for every
    # question, so its EM@1 is the flat one
    assert res["nprobe"] == 8 and res["dev_em1_n"] == flat["dev_em1_n"]
    assert res["dev_em1"] == flat["dev_em1"]
    params, cfg, tok = load_encoder(str(world["tmp"] / "port_enc"),
                                    device="cpu")
    store, _ = bench_serve_real.open_store(world["store"])
    qs, golds = bench_serve_real.load_dev(
        str(world["work"] / "qa_doc_split.json"))
    batches = bench_serve_real.dev_batches(qs, golds, 4)
    ids = {}
    for index in ("SQ8", "flat"):
        mips, _ = bench_serve_real.open_index(
            store, index, str(world["tmp"] / "grid"), device="cpu")
        dp = DensePhrases(params, cfg, tok, mips, max_query_length=24)
        ids[index] = bench_serve_real.em_at_1(dp, batches, 8)["ids"]
    assert len(ids["flat"]) == res["dev_em1_n"] > 0
    assert ids["SQ8"] == ids["flat"]


def test_dsmall_corpus_only_writes_the_mlm_corpus(world):
    work = str(world["tmp"] / "corpus_only")
    res = dsmall.main(["--corpus_only", "--workdir", work, "--corpus",
                       world["corpus_path"]], device="cpu")
    with open(os.path.join(work, "corpus.txt")) as f:
        lines = f.read().splitlines()
    assert lines == [p for d in world["docs"] for p in d["paragraphs"]]
    assert res["n_paragraphs"] == len(lines)
    with pytest.raises(SystemExit):
        dsmall.main(["--workdir", work, "--corpus", world["corpus_path"]],
                    device="cpu")


def test_dsmall_main_end_to_end(world):
    work = str(world["tmp"] / "run")
    out = str(world["tmp"] / "DSMALL.json")
    res = dsmall.main(
        ["--workdir", work, "--corpus", world["corpus_path"],
         "--pretrained", str(world["tmp"] / "port_enc"), "--scales",
         ",".join(map(str, SCALES)), "--dev_pars", "6", "--dev_per_par", "3",
         "--train_per_par", "3", "--train_max_pars", "40", "--steps", "4",
         "--batch", "4", "--seq", "64", "--pre_batch", "2", "--eval_every",
         "2", "--patience", "3", "--qft_epochs", "1", "--qft_pairs", "8",
         "--qft_topk", "8", "--qft_batch", "4", "--dump_batch", "8",
         "--out", out], device="cpu")
    assert res["n_docs"] == len(world["docs"])
    info = res["rc_train"]
    assert info["steps_run"] == 4 and info["best_step"] in (2, 4)
    assert [c["step"] for c in info["curve"]] == [2, 4]
    assert set(res["scales"]) == {f"pars{s}" for s in SCALES}
    small, large = (res["scales"][f"pars{s}"] for s in SCALES)
    assert small["n_paragraphs"] <= large["n_paragraphs"]
    assert small["dev"]["n"] == large["dev"]["n"] == res["n_dev"]
    assert res["qft"]["epochs"] == 1 and len(res["qft"]["loss"]) == 1
    assert os.path.exists(os.path.join(work, "encoder_qft", "config.json"))
    with open(out) as f:
        assert json.load(f)["protocol"] == res["protocol"]
    # a rerun resumes from the caches and the result
    again = dsmall.main(
        ["--workdir", work, "--corpus", world["corpus_path"],
         "--pretrained", str(world["tmp"] / "port_enc"), "--scales",
         ",".join(map(str, SCALES)), "--dev_pars", "6", "--dev_per_par", "3",
         "--train_per_par", "3", "--train_max_pars", "40", "--steps", "4",
         "--batch", "4", "--seq", "64", "--pre_batch", "2", "--eval_every",
         "2", "--patience", "3", "--qft_epochs", "1", "--out", out],
        device="cpu")
    assert again["scales"] == res["scales"]

