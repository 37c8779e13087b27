"""The port's host tools against the JAX package's: prediction analysis,
the KILT helpers, question generation (the cloze generators,
``generate_squad``, ``filter_qg`` and the local seq2seq plug) and the
benchmark helpers, with identical outputs on the same files and seeds."""

import json
import math

import numpy as np
import pytest

from densephrases_tpu.tools import analysis as jax_analysis
from densephrases_tpu.tools import benchmark as jax_benchmark
from densephrases_tpu.tools import kilt_tools as jax_kilt_tools
from densephrases_tpu.tools import question_generation as jax_qg
from densephrases_tpu_torch.index.store import DocMeta, StoreWriter
from densephrases_tpu_torch.tools import analysis, benchmark, kilt_tools
from densephrases_tpu_torch.tools import question_generation as qg

CONTEXTS = [
    "The fourth season premiered on NBC in June 2009. Kevin Skinner was "
    "named the winner in September 2009.",
    "Cristiano Ronaldo was born in Funchal in 1985. He joined Sporting CP "
    "at age 12 after a successful trial. The club's academy developed "
    "several famous players over the years. His transfer fee was a record "
    "12.24 million pounds.",
    "Kevin Skinner won the show in 2009.",
]


def _both(tmp_path, fn_port, fn_ref, write, name):
    """Run one tool of each package into its own file; return both files'
    texts and both return values."""
    a, b = str(tmp_path / f"port_{name}"), str(tmp_path / f"ref_{name}")
    ra, rb = fn_port(*write(a)), fn_ref(*write(b))
    return open(a).read(), open(b).read(), ra, rb


# ------------------------------------------------------------- analysis
@pytest.fixture(scope="module")
def pred_files(tmp_path_factory):
    rng = np.random.default_rng(0)
    words = ["paris", "london", "the eiffel tower", "1889", "rome", "Kevin"]
    tmp = tmp_path_factory.mktemp("preds")
    files = []
    for k in range(3):
        rows = {}
        for i in range(40):
            golds = [words[int(rng.integers(0, len(words)))]]
            preds = [words[int(j)] for j in rng.integers(0, len(words), 5)]
            if k == 2 and i % 9 == 0:
                preds = []  # skipped by analyze_predictions
            rows[f"q{i}"] = {"question": f"question {i}?", "prediction": preds,
                             "answers": golds}
        path = str(tmp / f"pred{k}.json")
        with open(path, "w") as f:
            json.dump(rows, f)
        files.append(path)
    return files


@pytest.mark.parametrize("top_k", [1, 3, 10])
@pytest.mark.parametrize("which", [0, 2])
def test_analyze_predictions_matches_reference(pred_files, which, top_k):
    assert analysis.analyze_predictions(pred_files[which], top_k) == \
        jax_analysis.analyze_predictions(pred_files[which], top_k)


def test_compare_predictions_matches_reference(pred_files):
    out = analysis.compare_predictions(*pred_files[:2])
    assert out == jax_analysis.compare_predictions(*pred_files[:2])
    assert out["both"] + out["a_only"] + out["b_only"] + out["neither"] == 40


# ------------------------------------------------------------------ KILT
def test_kilt_tools_match_reference(tmp_path):
    ks = tmp_path / "ks.jsonl"
    with open(ks, "w") as f:
        for wid, title in (("123", "Paris"), ("456", "London"), (7, "Rome")):
            f.write(json.dumps({"wikipedia_id": wid,
                                "wikipedia_title": title}) + "\n")
        f.write(json.dumps({"id": "9", "title": "Oslo"}) + "\n\n")
    pa, pb, ma, mb = _both(tmp_path, kilt_tools.build_title2wikiid,
                           jax_kilt_tools.build_title2wikiid,
                           lambda out: (str(ks), out), "map.json")
    assert ma == mb == {"Paris": "123", "London": "456", "Rome": "7",
                        "Oslo": "9"}
    assert pa == pb

    pred = tmp_path / "pred.jsonl"
    with open(pred, "w") as f:
        for i in range(10):
            f.write(json.dumps({"id": i, "input": "q", "output": [],
                                "extra": "junk"}) + "\n")
    sa, sb, na, nb = _both(tmp_path, kilt_tools.strip_predictions,
                           jax_kilt_tools.strip_predictions,
                           lambda out: (str(pred), out), "stripped.jsonl")
    assert na == nb == 10 and sa == sb and "extra" not in sa
    for n in (3, 20):
        sa, sb, na, nb = _both(
            tmp_path, kilt_tools.sample_jsonl, jax_kilt_tools.sample_jsonl,
            lambda out: (str(pred), out, n, 5), f"sample{n}.jsonl")
        assert na == nb == min(n, 10) and sa == sb


# --------------------------------------------------- question generation
@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("ctx", range(len(CONTEXTS)))
def test_cloze_generators_match_reference(ctx, seed):
    text = CONTEXTS[ctx]
    assert qg.cloze_qg(text, 5, seed) == jax_qg.cloze_qg(text, 5, seed)
    ext = qg.cloze_qg_extended(text, 100, seed)
    assert ext == jax_qg.cloze_qg_extended(text, 100, seed)
    assert all(a in text for _, a in ext)


def test_generate_and_filter_squad_match_reference(tmp_path):
    docs = [{"title": f"T{i}", "paragraphs": [c]}
            for i, c in enumerate(CONTEXTS)] + [{"paragraphs": ["no entities"]}]
    ga, gb, na, nb = _both(tmp_path, qg.generate_squad, jax_qg.generate_squad,
                           lambda out: (docs, out, None, 4, 1), "qg.json")
    assert na == nb > 0 and ga == gb
    gold = {qa["question"]: qa["answers"][0]["text"]
            for art in json.loads(ga)["data"] for par in art["paragraphs"]
            for qa in par["qas"]}
    # a reader right on every other question; EM and F1 matching
    half = lambda q, c: gold[q] if sorted(gold).index(q) % 2 else "garbage"
    for match in ("em", "f1"):
        fa, fb, ka, kb = _both(
            tmp_path, qg.filter_qg, jax_qg.filter_qg,
            lambda out: (str(tmp_path / "port_qg.json"), out, half, match),
            f"filtered_{match}.json")
        assert ka == kb and 0 < ka < na and fa == fb

    # a generator yielding explicit answer starts, one of them wrong
    def gen(ctx):
        return [("who won", "Kevin Skinner", ctx.find("Kevin")),
                ("bad start", "Kevin", 1)]

    ga, gb, na, nb = _both(tmp_path, qg.generate_squad, jax_qg.generate_squad,
                           lambda out: (docs[:1], out, gen), "qg_fn.json")
    assert na == nb == 1 and ga == gb


@pytest.fixture(scope="module")
def tiny_seq2seq_dir(tmp_path_factory):
    """A tiny random-weights BART seq2seq and WordLevel tokenizer on disk
    (``tests/test_qg_seq2seq.py``'s contract model): the plug's local load
    path without a download."""
    pytest.importorskip("transformers")
    pytest.importorskip("tokenizers")
    import torch
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import (BartConfig, BartForConditionalGeneration,
                              PreTrainedTokenizerFast)

    path = tmp_path_factory.mktemp("tiny_qg_model")
    words = ("what when where who is was the a of in founded moved city "
             "residents grew generate question later and by to").split()
    vocab = {"<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3, "<hl>": 4}
    for w in words:
        vocab[w] = len(vocab)
    core = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    core.pre_tokenizer = pre_tokenizers.Whitespace()
    PreTrainedTokenizerFast(
        tokenizer_object=core, pad_token="<pad>", bos_token="<s>",
        eos_token="</s>", unk_token="<unk>").save_pretrained(str(path))
    cfg = BartConfig(
        vocab_size=len(vocab), d_model=32, encoder_layers=1,
        decoder_layers=1, encoder_attention_heads=2,
        decoder_attention_heads=2, encoder_ffn_dim=64, decoder_ffn_dim=64,
        max_position_embeddings=512, pad_token_id=0, bos_token_id=1,
        eos_token_id=2, decoder_start_token_id=1, forced_eos_token_id=None)
    torch.manual_seed(0)
    BartForConditionalGeneration(cfg).save_pretrained(str(path))
    return str(path)


def test_hf_seq2seq_qg_matches_reference(tiny_seq2seq_dir, tmp_path):
    context = ("The city of Springfield was founded in 1821 by Thomas "
               "Pynchon. Thomas Pynchon later moved to Boston, and "
               "Springfield grew to 120000 residents.")
    kw = dict(max_questions=3, max_input_len=128, max_output_len=12)
    fn, ref_fn = (qg.hf_seq2seq_qg(tiny_seq2seq_dir, **kw),
                  jax_qg.hf_seq2seq_qg(tiny_seq2seq_dir, **kw))
    out = fn(context)
    assert out == ref_fn(context)
    starts = [s for _, _, s in out]
    assert len(set(starts)) == len(starts)
    for q, a, start in out:
        assert q and context[start:start + len(a)] == a
    docs = [{"title": "S", "paragraphs": [context]}]
    ga, gb, na, nb = _both(tmp_path, qg.generate_squad, jax_qg.generate_squad,
                           lambda p: (docs, p, fn), "hf.json")
    assert na == nb == len(out) and ga == gb


# ------------------------------------------------------------- benchmark
def test_create_benchmark_data_matches_reference(tmp_path):
    rows = [{"id": f"q{i}", "question": f"question\t{i}",
             "answers": [f"a{i}", f"b{i}"]} for i in range(30)]
    qa = tmp_path / "qa.json"
    qa.write_text(json.dumps({"data": rows}))
    na = benchmark.create_benchmark_data(str(qa), str(tmp_path / "port"), 12, 4)
    nb = jax_benchmark.create_benchmark_data(str(qa), str(tmp_path / "ref"),
                                             12, 4)
    assert na == nb == 12
    for suffix in ("_denspi.json", "_dpr.csv", "_orqa.jsonl"):
        assert (tmp_path / f"port{suffix}").read_text() == \
            (tmp_path / f"ref{suffix}").read_text()


def test_benchmark_store_read(tmp_path):
    writer = StoreWriter(str(tmp_path / "s"), 32)
    rng = np.random.default_rng(0)
    for d in range(8):
        writer.add_doc(DocMeta(
            doc_id=d, title=f"t{d}", context="x " * 40,
            word2char_start=np.arange(40, dtype=np.int32) * 2,
            word2char_end=np.arange(40, dtype=np.int32) * 2 + 1,
            f2o_start=np.arange(40, dtype=np.int32)),
            rng.integers(-128, 127, (40, 32)).astype(np.int8))
    writer.finalize()
    out = benchmark.benchmark_store_read(str(tmp_path / "s"), 200, 10, 1)
    ref = jax_benchmark.benchmark_store_read(str(tmp_path / "s"), 200, 10, 1)
    assert out.keys() == ref.keys() == {"reads_per_sec", "mb_per_sec",
                                        "total_s"}
    assert all(math.isfinite(v) and v > 0 for v in out.values())
    # the same bytes read: 200 windows of 10 rows of 32 bytes
    assert math.isclose(out["mb_per_sec"] * out["total_s"] * 1e6,
                        200 * 10 * 32, rel_tol=1e-9)
    assert math.isclose(out["reads_per_sec"] * out["total_s"], 200,
                        rel_tol=1e-9)
