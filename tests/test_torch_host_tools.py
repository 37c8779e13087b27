"""The port's host tools against the JAX package's, function by function on
the same inputs: the KILT metrics (eval/kilt.py), the SQLite document store
and the Wikipedia corpus chain (preprocess/doc_db.py, wiki.py), the dataset
converters (preprocess/datasets.py), the offline MLM corpus
(preprocess/offline_corpus.py), the store tools (tools/store_tools.py), the
preprocessing driver's outputs byte for byte (cli/preprocess.py), and the
streaming RC dataset (data/lazy.py)."""

import contextlib
import filecmp
import functools
import json
import os
import sqlite3

import numpy as np
import pytest

from densephrases_tpu.cli import preprocess as jax_cli
from densephrases_tpu.data import lazy as jax_lazy
from densephrases_tpu.data.tokenization import WordPieceTokenizer as JaxTokenizer
from densephrases_tpu.eval import kilt as jax_kilt
from densephrases_tpu.preprocess import datasets as jax_ds
from densephrases_tpu.preprocess import doc_db as jax_db
from densephrases_tpu.preprocess import offline_corpus as jax_oc
from densephrases_tpu.preprocess import wiki as jax_wiki
from densephrases_tpu.tools import store_tools as jax_st
from densephrases_tpu_torch.cli import preprocess as port_cli
from densephrases_tpu_torch.data import lazy as port_lazy
from densephrases_tpu_torch.data.features import convert_context_to_features
from densephrases_tpu_torch.data.tokenization import SPECIAL_TOKENS, WordPieceTokenizer
from densephrases_tpu_torch.eval import kilt as port_kilt
from densephrases_tpu_torch.index.store import DocMeta, StoreWriter
from densephrases_tpu_torch.preprocess import datasets as port_ds
from densephrases_tpu_torch.preprocess import doc_db as port_db
from densephrases_tpu_torch.preprocess import offline_corpus as port_oc
from densephrases_tpu_torch.preprocess import wiki as port_wiki
from densephrases_tpu_torch.tools import store_tools as port_st

WORDS = [f"w{i}" for i in range(80)] + ["the", "river", "paris", "fox"]
VOCAB = {t: i for i, t in enumerate(SPECIAL_TOKENS + WORDS + [".", ","])}


def _same_tree(a, b):
    """Two directories hold the same files with the same bytes."""
    cmp = filecmp.dircmp(a, b)
    assert not cmp.left_only and not cmp.right_only, (cmp.left_only,
                                                      cmp.right_only)
    for name in cmp.common_files:
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name),
                           shallow=False), name
    for sub in cmp.common_dirs:
        _same_tree(os.path.join(a, sub), os.path.join(b, sub))


# ---- KILT ------------------------------------------------------------------

def test_kilt_metrics_match_reference(tmp_path):
    preds = [{"answer": "The Eiffel tower", "provenance": ["1", "2", "9"]},
             {"answer": "Paris", "provenance": ["5"]},
             {"answer": "", "provenance": []},
             {"answer": "a big river flows", "provenance": ["7", "3"]}]
    golds = [{"answers": ["eiffel tower"], "provenance": [["1", "2"], ["4"]]},
             {"answers": ["London", "paris"], "provenance": [["6"]]},
             {"answers": [], "provenance": []},
             {"answers": ["the river flows big"], "provenance": [["3", "7"]]}]
    for k in (1, 2, 5):
        assert port_kilt.evaluate_kilt(preds, golds, k) == \
            jax_kilt.evaluate_kilt(preds, golds, k)
    for p, g in zip(preds, golds):
        assert port_kilt.rprecision(p["provenance"], g["provenance"]) == \
            jax_kilt.rprecision(p["provenance"], g["provenance"])
        for a in g["answers"]:
            assert port_kilt._rouge_l(p["answer"], a) == \
                jax_kilt._rouge_l(p["answer"], a)
    results = [[{"answer": "x", "title": ["A", "B"]}, {"answer": "y",
                                                       "title": ["A", "C"]}],
               []]
    t2w = {"A": "10", "C": "30"}
    assert port_kilt.results_to_kilt_predictions(results, t2w) == \
        jax_kilt.results_to_kilt_predictions(results, t2w)
    path = tmp_path / "kilt.jsonl"
    rows = [{"input": "q1", "output": [{"answer": "a1", "provenance": [
        {"wikipedia_id": "11"}, {"wikipedia_id": ""}]}, {"answer": ""}]},
        {"input": "q2", "output": []}]
    path.write_text("\n".join(json.dumps(r) for r in rows) + "\n\n")
    assert port_kilt.load_kilt_data(str(path)) == \
        jax_kilt.load_kilt_data(str(path))


# ---- documents and corpus files -------------------------------------------

def _extracted(root):
    """WikiExtractor-style jsonl files in two subdirectories."""
    rng = np.random.default_rng(0)
    for sub in ("AA", "AB"):
        os.makedirs(root / sub)
        with open(root / sub / "wiki_00", "w") as f:
            for i in range(6):
                paras = [" ".join(rng.choice(WORDS, int(rng.integers(3, 30))))
                         for _ in range(int(rng.integers(1, 5)))]
                title = ["Article", "List of things", "Thing (disambiguation)",
                         "Short"][i % 4] + f" {sub}{i}"
                f.write(json.dumps({"id": f"{sub}{i}", "title": title,
                                    "text": "\n".join(paras)}) + "\n\n")


def test_doc_db_round_trip(tmp_path):
    _extracted(tmp_path / "in")
    counts = {}
    for name, mod in (("jax", jax_db), ("port", port_db)):
        counts[name] = mod.build_db(str(tmp_path / f"{name}.db"),
                                    str(tmp_path / "in"))
    assert counts["port"] == counts["jax"] == 12
    with port_db.DocDB(str(tmp_path / "port.db")) as db, \
            jax_db.DocDB(str(tmp_path / "jax.db")) as jdb:
        assert db.doc_ids() == jdb.doc_ids()
        for i in db.doc_ids():
            assert db.get_doc_text(i) == jdb.get_doc_text(i)
            assert db.get_doc_title(i) == jdb.get_doc_title(i)
        assert db.get_doc_text("nope") is None
        db.insert_many([("new", "New", "text")])
        assert db.get_doc_title("new") == "New"
    with sqlite3.connect(str(tmp_path / "port.db")) as conn:
        assert conn.execute("SELECT COUNT(*) FROM documents").fetchone()[0] == 13


def test_wiki_chain_matches_reference(tmp_path):
    _extracted(tmp_path / "in")
    port_db.build_db(str(tmp_path / "docs.db"), str(tmp_path / "in"))
    for title, text in (("List of x", "a" * 80), ("Good", "short"),
                        ("Index of y", "b" * 80), ("Fine (disambiguation)",
                                                   "c" * 80), ("Ok", "d" * 80)):
        assert port_wiki.keep_article(title, text) == \
            jax_wiki.keep_article(title, text)
    text = "header\n" + "a long paragraph of words " * 2 + "\n\n x \n" + "b" * 30
    assert port_wiki.split_paragraphs(text) == jax_wiki.split_paragraphs(text)
    for name, mod in (("jax", jax_wiki), ("port", port_wiki)):
        out = tmp_path / name
        assert mod.db_to_squad_docs(str(tmp_path / "docs.db"),
                                    str(out / "corpus"), docs_per_file=2) > 1
        assert mod.concat_small_docs(str(out / "corpus"), str(out / "concat"),
                                     min_words=40) > 1
        rows = [{"question": "q1", "answers": [{"text": "a"}, "b"]},
                {"question": "q2"}]
        mod.create_openqa(rows, str(out / "squad.json"), "squad")
        mod.create_openqa([["q3", ["c"]]], str(out / "drqa.json"), "drqa")
        mod.create_openqa([{"input": "q4", "output": [{"answer": "d"}, {}]}],
                          str(out / "kilt.json"), "kilt")
    _same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))
    with pytest.raises(ValueError):
        port_wiki.create_openqa([{}], str(tmp_path / "x.json"), "other")


def test_datasets_match_reference(tmp_path):
    nq = [{"question_text": "what is the answer", "document_title": "T",
           "document_text": "<P> The answer is forty two . </P> <Table> x",
           "annotations": [{"long_answer": {"start_token": 0, "end_token": 8},
                            "short_answers": [{"start_token": 4,
                                               "end_token": 6}]},
                           {"long_answer": {"start_token": -1,
                                            "end_token": -1}}]},
          {"question_text": "no short", "document_text": "a b c",
           "annotations": [{"long_answer": {"start_token": 0, "end_token": 3},
                            "short_answers": []}]}]
    (tmp_path / "nq.jsonl").write_text("\n".join(json.dumps(r) for r in nq))
    a = tmp_path / "a.json"
    a.write_text(json.dumps({"data": [{"question": "Q1?", "answers": ["x"]},
                                      {"question": "Q2?", "answers": []}]}))
    b = tmp_path / "b.jsonl"
    b.write_text(json.dumps({"question": "q1?", "answers": ["y"]}) + "\n")
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    (corpus / "0000.json").write_text(json.dumps({"data": [
        {"title": "Good", "paragraphs": [{"context": "text " * 20}]},
        {"title": "List of stuff", "paragraphs": [{"context": "text " * 20}]}]}))
    tsv = tmp_path / "p.tsv"
    tsv.write_text("id\ttext\ttitle\n1\tfirst\tA\n2\tsecond\tA\n3\tthird\tB\n"
                   "4\tfourth\n")
    counts = {}
    for name, mod in (("jax", jax_ds), ("port", port_ds)):
        out = tmp_path / name
        out.mkdir()
        counts[name] = (
            mod.nq_to_squad(str(tmp_path / "nq.jsonl"), str(out / "nq.json")),
            mod.merge_openqa([str(a), str(b)], str(out / "m.json")),
            mod.merge_openqa([str(a), str(b)], str(out / "m2.json"),
                             dedup=False),
            mod.filter_noans(str(out / "m.json"), str(out / "noans.json")),
            mod.filter_wiki(str(corpus), str(out / "filtered")),
            mod.stat_entities(str(out / "m2.json")),
            mod.tsv_to_corpus(str(tsv), str(out / "psg"), docs_per_file=1,
                              passages_per_doc=2))
    assert counts["port"] == counts["jax"]
    _same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))
    for ans in ("42", "March 2009", "Kevin Skinner", "a blue whale", "",
                "3.5 %", "école"):
        assert port_ds.answer_type(ans) == jax_ds.answer_type(ans)
    for text in ("Hello, world!", "Ángel 42 ... x-y"):
        assert port_ds.SimpleTokenizer().words(text) == \
            jax_ds.SimpleTokenizer().words(text)


# ---- the offline MLM corpus ------------------------------------------------

PROSE = ("The river flows through the old city and past the cathedral. "
         "Many visitors walk along its banks in the summer evenings. "
         "The bridges were rebuilt after the flood of the last century.")


def _sources(root):
    """An articles file, a contexts file, a python package and a docs dir."""
    os.makedirs(root / "pkg" / "tests")
    (root / "pkg" / "mod.py").write_text(
        f'"""{PROSE}\n\nx = 1 :: y"""\n\ndef f():\n    """{PROSE} Again."""\n')
    (root / "pkg" / "tests" / "t.py").write_text(f'"""{PROSE} Test."""\n')
    (root / "pkg" / "bad.py").write_text("def (:\n")
    os.makedirs(root / "docs")
    (root / "docs" / "a.md").write_text(f"# Title\n\n{PROSE} Md.\n\n```\ncode\n```")
    (root / "articles.json").write_text(json.dumps({"data": [
        {"title": "A", "paragraphs": [{"context": PROSE + "  Art."},
                                      {"context": PROSE}]}]}))
    (root / "contexts.txt").write_text(f"[Sec one]\n{PROSE} Ctx.\nshort\n"
                                       f"[Sec two]\n{PROSE}\n")


def test_offline_corpus_matches_reference(tmp_path, monkeypatch):
    _sources(tmp_path)
    arts, ctxs = str(tmp_path / "articles.json"), str(tmp_path / "contexts.txt")
    roots, md = [str(tmp_path / "pkg")], [str(tmp_path / "docs")]
    for par in (PROSE, "short", "x = 1; y = {a: b} :: -> >>> " * 10,
                PROSE.replace(".", "")):
        assert port_oc.looks_like_prose(par) == jax_oc.looks_like_prose(par)
    pairs = ((port_oc, jax_oc),)
    for p, j in pairs:
        assert p.paragraphs_from_articles(arts) == j.paragraphs_from_articles(arts)
        assert p.paragraphs_from_contexts(ctxs) == j.paragraphs_from_contexts(ctxs)
        assert p.paragraphs_from_docstrings(roots) == \
            j.paragraphs_from_docstrings(roots)
        assert p.paragraphs_from_markdown(md) == j.paragraphs_from_markdown(md)
        assert p.docs_from_articles(arts) == j.docs_from_articles(arts)
        assert p.docs_from_contexts(ctxs) == j.docs_from_contexts(ctxs)
        assert p.docs_from_docstrings(roots) == j.docs_from_docstrings(roots)
    outs = {}
    for name, mod in (("jax", jax_oc), ("port", port_oc)):
        # the sources' default paths point at a checkout of the upstream
        # project: point both at this test's files
        for fn, path in (("paragraphs_from_articles", arts),
                         ("paragraphs_from_contexts", ctxs),
                         ("docs_from_articles", arts),
                         ("docs_from_contexts", ctxs)):
            monkeypatch.setattr(mod, fn, functools.partial(getattr(mod, fn),
                                                           path))
        monkeypatch.setattr(mod, "paragraphs_from_docstrings", functools.partial(
            mod.paragraphs_from_docstrings, roots))
        monkeypatch.setattr(mod, "docs_from_docstrings", functools.partial(
            mod.docs_from_docstrings, roots))
        out = tmp_path / f"out_{name}"
        out.mkdir()
        outs[name] = (mod.build_corpus(md_roots=md,
                                       out_path=str(out / "corpus.txt")),
                      mod.build_corpus_docs(md_roots=md,
                                            out_path=str(out / "docs.json")))
        assert mod.load_corpus(str(out / "corpus.txt")) == outs[name][0]
    assert outs["port"] == outs["jax"]
    _same_tree(str(tmp_path / "out_jax"), str(tmp_path / "out_port"))


def test_offline_corpus_defaults_name_the_same_files():
    # the port finds the upstream checkout under $DENSEPHRASES_REFERENCE_DIR
    # instead of a fixed absolute path; the files under it are the same
    for name in ("REF_ARTICLES", "REF_CONTEXTS"):
        port_rel = os.path.relpath(getattr(port_oc, name), port_oc.REF_ROOT)
        assert getattr(jax_oc, name).endswith(os.sep + port_rel), name
    roots = port_oc.package_roots(("numpy", "no_such_package_here"))
    assert roots == [os.path.dirname(np.__file__)]


# ---- stores ------------------------------------------------------------------

def _store(path, n_docs=5, dim=8, seed=0):
    rng = np.random.default_rng(seed)
    writer = StoreWriter(str(path), dim)
    for d in range(n_docs):
        words = [str(w) for w in rng.choice(WORDS, int(rng.integers(4, 12)))]
        ctx = " ".join(words)
        starts = np.cumsum([0] + [len(w) + 1 for w in words[:-1]])
        ends = starts + np.array([len(w) for w in words])
        n = int(rng.integers(1, len(words) + 1))
        writer.add_doc(DocMeta(doc_id=100 + d, title=f"T{d}", context=ctx,
                               word2char_start=starts.astype(np.int32),
                               word2char_end=ends.astype(np.int32),
                               f2o_start=np.sort(rng.choice(
                                   len(words), n, replace=False)).astype(
                                   np.int32)),
                       rng.integers(-128, 128, (n, dim)).astype(np.int8))
    writer.finalize()
    return str(path)


def test_store_tools_match_reference(tmp_path):
    store = _store(tmp_path / "store")
    assert port_st.check_store(store) == jax_st.check_store(store)
    assert port_st.check_store(store)["ok"]
    assert port_st.store_stats(store) == jax_st.store_stats(store)
    scores = np.random.default_rng(1).standard_normal(64).astype(np.float32)
    for name, mod in (("jax", jax_st), ("port", port_st)):
        mod.filter_store(store, str(tmp_path / name / "half"), 0.5)
        mod.filter_store(store, str(tmp_path / name / "scored"), 0.3, scores)
        mod.split_store(store, str(tmp_path / name / "split"), 2)
    _same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))


def test_preprocess_driver_outputs_match_byte_for_byte(tmp_path):
    _extracted(tmp_path / "in")
    store = _store(tmp_path / "store")
    squad = tmp_path / "squad.json"
    squad.write_text(json.dumps({"data": [{"title": "T", "paragraphs": [
        {"context": "The River flows. Paris is big! x", "qas": [
            {"id": "1", "question": "Where?", "answers": [{"text": "Paris"}]}]
         }]}]}))
    drqa = tmp_path / "drqa.json"
    drqa.write_text(json.dumps([["q", ["a"]], ["r", ["b", "c"]]]))
    kilt = tmp_path / "kilt.jsonl"
    kilt.write_text(json.dumps({"input": "q", "output": [{"answer": "a"}]})
                    + "\n\n")
    text = tmp_path / "cased.txt"
    text.write_text("The River Seine. It flows in Paris.\n\nParis is big.\n")
    for name, main in (("jax", jax_cli.main), ("port", port_cli.main)):
        out = tmp_path / name
        out.mkdir()
        main(["build-db", "--input", str(tmp_path / "in"), "--db",
              str(out / "docs.db")])
        main(["build-corpus", "--db", str(out / "docs.db"), "--out",
              str(out / "corpus"), "--docs_per_file", "3"])
        main(["concat", "--in", str(out / "corpus"), "--out",
              str(out / "concat"), "--min_words", "30"])
        for kind, path in (("squad", squad), ("drqa", drqa), ("kilt", kilt)):
            main(["create-openqa", "--input", str(path), "--input_type", kind,
                  "--out", str(out / f"open_{kind}.json")])
        for src in (squad, text):
            main(["train-truecase", "--input", str(src), "--out",
                  str(out / f"tc_{src.stem}.pkl")])
    # the SQLite files hold the same rows; every other output the same bytes
    rows = {}
    for name in ("jax", "port"):
        with sqlite3.connect(str(tmp_path / name / "docs.db")) as conn:
            rows[name] = conn.execute(
                "SELECT * FROM documents ORDER BY id").fetchall()
        os.remove(tmp_path / name / "docs.db")
    assert rows["port"] == rows["jax"] and rows["port"]
    _same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))


@pytest.mark.parametrize("cmd", ["check-store", "store-stats"])
def test_preprocess_store_commands_print_the_same(tmp_path, capsys, cmd):
    store = _store(tmp_path / "store")
    printed = {}
    for name, main in (("jax", jax_cli.main), ("port", port_cli.main)):
        with pytest.raises(SystemExit) if cmd == "check-store" else \
                contextlib.nullcontext() as exc:
            main([cmd, "--store", store])
        if cmd == "check-store":
            assert exc.value.code == 0
        printed[name] = capsys.readouterr().out
    assert printed["port"] == printed["jax"] and printed["port"]


# ---- the streaming RC dataset ----------------------------------------------

def _qa_rows(n=7, seed=0):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        words = [str(w) for w in rng.choice(WORDS, 90 if i == 2 else 20)]
        ctx = " ".join(words)
        ans = words[5]
        rows.append({"id": i, "question": " ".join(words[:4]), "title": "T",
                     "context": ctx, "answers": [ans],
                     "answer_start": ctx.index(ans)})
    return rows


def test_read_qa_jsonl_and_pool_match_reference(tmp_path):
    path = tmp_path / "qa.jsonl"
    rows = _qa_rows() + [{"input": "only input", "answer": "x"}]
    path.write_text("\n".join(json.dumps(r) for r in rows) + "\n\n")
    for rank, world, skip in ((0, 1, 0), (1, 2, 0), (0, 2, 2)):
        assert list(port_lazy.read_qa_jsonl(str(path), rank, world, skip)) == \
            list(jax_lazy.read_qa_jsonl(str(path), rank, world, skip))
    tsv = tmp_path / "psgs.tsv"
    tsv.write_text("id\ttext\ttitle\n" + "".join(
        f"{i}\tnegative passage {' '.join(WORDS[i:i + 9])}\tT{i}\n"
        for i in range(6)) + "7\tno title\n")
    pool, jpool = port_lazy.PassagePool(str(tsv)), jax_lazy.PassagePool(str(tsv))
    assert (pool.texts, pool.titles) == (jpool.texts, jpool.titles)
    assert len(port_lazy.PassagePool(str(tsv), max_rows=3)) == 2


def test_lazy_batches_match_reference(tmp_path):
    """Both packages' LazyRCDataset on one jsonl and one negative pool, with
    the teacher inputs: the same batches. One example's context spans
    several windows; ``convert_rc_examples`` keeps one window an example
    (the answer's, else the first), so every batch holds batch_size rows in
    both packages (ROADMAP.md Queue 3 asked whether it could hold more)."""
    path = tmp_path / "qa.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in _qa_rows()) + "\n")
    tsv = tmp_path / "psgs.tsv"
    tsv.write_text("".join(f"{i}\tnegative {' '.join(WORDS[i:i + 9])}\tT{i}\n"
                           for i in range(6)))
    kw = dict(batch_size=3, max_seq_length=48, doc_stride=24,
              max_query_length=8, seed=4, with_teacher=True)
    got = list(port_lazy.LazyRCDataset(
        port_lazy.read_qa_jsonl(str(path)), WordPieceTokenizer(VOCAB),
        negative_pool=port_lazy.PassagePool(str(tsv)), **kw))
    want = list(jax_lazy.LazyRCDataset(
        jax_lazy.read_qa_jsonl(str(path)), JaxTokenizer(VOCAB),
        negative_pool=jax_lazy.PassagePool(str(tsv)), **kw))
    assert len(got) == len(want) == 2  # 7 examples: two full batches of 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert "neg_input_ids" in g and "cross_input_ids" in g
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    windows, _ = convert_context_to_features(
        0, "T", [_qa_rows()[2]["context"]], WordPieceTokenizer(VOCAB),
        max_seq_length=48, stride=24)
    assert len(windows) > 1
    for g in got:
        assert all(v.shape[0] == 3 for v in g.values())
