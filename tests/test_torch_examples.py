"""The port's runnable examples (``densephrases_tpu_torch/examples``)
against the JAX package's (``examples/*/run.py``), on the CPU: each runs
with ``--load_dir`` on one encoder (a tiny seeded JAX save, converted by
``convert_jax_checkpoint.py`` for the port), and both print the same
report: the same answers, titles and metrics. Numbers in the reports are
compared to 3 decimals (the scores are fp32 sums in another order);
``create_custom_index`` reads a synthetic articles / questions pair and
answers from the reference's store."""

import io
import json
import os
import re
import runpy
import sys
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest

import convert_jax_checkpoint
from densephrases_tpu.cli.common import save_encoder as jax_save_encoder
from densephrases_tpu.data.tokenization import WordPieceTokenizer as JaxTokenizer
from densephrases_tpu.index.store import PhraseStore as JaxPhraseStore
from densephrases_tpu.models.bert import BertConfig as JaxBertConfig
from densephrases_tpu.models.encoder import init_encoder_params as jax_init
from densephrases_tpu_torch.data.tokenization import whole_word_vocab
from densephrases_tpu_torch.index.store import PhraseStore
from densephrases_tpu_torch.examples import (
    _common, create_custom_index, entity_linking, fid_reader,
    knowledge_dialogue, slot_filling)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = {
    "entity-linking": entity_linking,
    "fid-reader": fid_reader,
    "knowledge-dialogue": knowledge_dialogue,
    "slot-filling": slot_filling,
}
ARTICLES = [
    {"title": "Danube", "paragraphs": [
        {"context": "The Danube flows through Vienna and Budapest. It is "
                    "the second longest river in Europe."}]},
    {"title": "Vltava", "paragraphs": [
        {"context": "The Vltava crosses Prague. The Charles Bridge spans "
                    "the Vltava in the old town."},
        {"context": "The Vltava joins the Elbe at Melnik."}]},
]
QUESTIONS = [{"question": "Which river flows through Vienna?",
              "answers": ["Danube"]},
             {"question": "What spans the Vltava?",
              "answers": ["Charles Bridge"]}]


@pytest.fixture(scope="module")
def encoders(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("examples")
    texts = [d["text"] for d in _common.TINY_WIKI] + [
        p["context"] for a in ARTICLES for p in a["paragraphs"]] + [
        q["question"] for q in QUESTIONS]
    vocab = whole_word_vocab(texts, vocab_size=600)
    jcfg = JaxBertConfig.tiny(vocab_size=len(vocab))
    jax_save_encoder(str(tmp / "jax_enc"), jax_init(jax.random.PRNGKey(5),
                                                    jcfg),
                     jcfg, JaxTokenizer(vocab))
    assert convert_jax_checkpoint.main(
        ["--kind", "encoder", str(tmp / "jax_enc"), str(tmp / "port_enc")]) == 0
    (tmp / "articles.json").write_text(json.dumps({"data": ARTICLES}))
    (tmp / "questions.json").write_text(json.dumps({"data": QUESTIONS}))
    return tmp


def _normalized(text, workdir):
    text = text.replace(workdir, "<workdir>")
    return [re.sub(r"-?\d+\.\d+", lambda m: f"{float(m.group()):.3f}", line)
            for line in text.splitlines() if line.strip()]


def _run_reference(script, argv, monkeypatch):
    """Run a JAX example script as ``python run.py argv`` and return what
    it printed."""
    monkeypatch.setattr(sys, "argv", [script] + argv)
    monkeypatch.setattr(sys, "path", list(sys.path))
    buf = io.StringIO()
    with redirect_stdout(buf):
        runpy.run_path(script, run_name="__main__")
    return buf.getvalue()


def _run_port(module, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        ret = module.main(argv, device="cpu")
    return buf.getvalue(), ret


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_matches_the_reference(encoders, name, monkeypatch):
    jwork, pwork = str(encoders / f"jax_{name}"), str(encoders / f"pt_{name}")
    want = _run_reference(
        os.path.join(REPO, "examples", name, "run.py"),
        ["--cpu", "--load_dir", str(encoders / "jax_enc"), "--workdir",
         jwork], monkeypatch)
    got, ret = _run_port(EXAMPLES[name],
                         ["--load_dir", str(encoders / "port_enc"),
                          "--workdir", pwork])
    assert _normalized(got, pwork) == _normalized(want, jwork)
    metrics, rows = ret
    assert metrics and len(rows) == 3


def test_create_custom_index_matches_the_reference(encoders, monkeypatch):
    common = ["--articles", str(encoders / "articles.json"), "--questions",
              str(encoders / "questions.json"), "--top_k", "3"]
    # one working directory: the port's dump resumes the reference's store
    # (every doc is in it), so both answer from one store. Each package's
    # own dump of these articles rounds ~7% of the int8 codes apart by one
    # (bf16 tower outputs near a rounding edge), which moves a third answer
    # whose score is within 1% of the next; the dump itself is held in
    # test_torch_slice.py
    jwork = pwork = str(encoders / "cci")
    want = _run_reference(
        os.path.join(REPO, "examples", "create-custom-index", "run.py"),
        common + ["--load_dir", str(encoders / "jax_enc"), "--workdir",
                  jwork], monkeypatch)
    got, ret = _run_port(create_custom_index,
                         common + ["--load_dir", str(encoders / "port_enc"),
                                   "--workdir", pwork, "--cpu"])
    assert _normalized(got, pwork) == _normalized(want, jwork)
    assert [q for q, _, _ in ret] == [q["question"] for q in QUESTIONS]
    assert all(len(answers) == 3 for _, _, answers in ret)
    assert "2 documents" in got
    # the port's own dump, held against the reference's at the int8
    # tolerance of test_torch_slice.py::test_dump_matches_reference: codes
    # at most one apart, fewer than 15% of them
    own = str(encoders / "cci_port")
    _run_port(create_custom_index,
              common + ["--load_dir", str(encoders / "port_enc"),
                        "--workdir", own, "--cpu"])
    ps = PhraseStore.load(os.path.join(own, "store"))
    js = JaxPhraseStore.load(os.path.join(jwork, "store"))
    np.testing.assert_array_equal(ps.doc_bases, js.doc_bases)
    np.testing.assert_array_equal(ps.doc_ids, js.doc_ids)
    assert [ps.metas[i] for i in range(ps.num_docs)] == \
        [js.metas[i] for i in range(js.num_docs)]
    diff = np.abs(ps.vecs.astype(np.int16) - js.vecs.astype(np.int16))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() < 0.15


def test_examples_run_from_scratch_without_a_load_dir(tmp_path):
    # no --load_dir: a vocab trained on the corpus, a seeded tiny encoder
    out, (metrics, rows) = _run_port(
        entity_linking, ["--cpu", "--workdir", str(tmp_path / "el")])
    assert "entity-linking metrics" in out and metrics["n"] == 3
    assert all(a in {d["title"] for d in _common.TINY_WIKI} for _, a in rows)


def test_cpu_flag_asks_for_the_cpu():
    assert _common.parse_device(["--cpu", "--x"], "cuda") == (["--x"], "cpu")
    assert _common.parse_device(["--x"], "cuda") == (["--x"], "cuda")


def test_vocab_without_tokenizers(monkeypatch):
    # the card's machine has no `tokenizers`: WordPiece training raises
    # there, as the reference does, and a caller picks the whole-word vocab
    from densephrases_tpu_torch.data.tokenization import (
        build_vocab, train_wordpiece_vocab)

    monkeypatch.setitem(sys.modules, "tokenizers", None)
    texts = [d["text"] for d in _common.TINY_WIKI]
    with pytest.raises(ImportError):
        train_wordpiece_vocab(texts, vocab_size=120)
    with pytest.raises(ImportError):
        build_vocab(texts, vocab_size=120)
    with pytest.raises(ValueError):
        build_vocab(texts, vocab_size=120, kind="bpe")
    tok = build_vocab(texts, vocab_size=120, kind="whole_word")
    assert tok.vocab == whole_word_vocab(texts, vocab_size=120)
    assert tok.vocab_size == 120
    pieces = tok.tokenize("Curie discovered polonium in Zurich")
    assert "[UNK]" not in pieces and "curie" in pieces
