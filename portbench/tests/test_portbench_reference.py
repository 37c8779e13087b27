"""The plain reference against the port at tiny sizes on the CPU, where
both compute in float32."""

import numpy as np
import pytest
import torch

from portbench import inputs, port
from portbench.reference import bert, search, tokenize

CPU = torch.device("cpu")
MODEL = {"vocab_size": 300, "hidden_size": 64, "num_hidden_layers": 2,
         "num_attention_heads": 4, "intermediate_size": 128,
         "max_position_embeddings": 64, "type_vocab_size": 2,
         "layer_norm_eps": 1e-12, "hidden_act": "gelu",
         "initializer_range": 0.02}
WEIGHTS = {"std": 0.05, "ln_std": 0.1}


def test_tokenize_matches_the_port():
    from densephrases_tpu_torch.data.features import (
        convert_questions_to_features)

    vocab = inputs.make_vocab(300, ["what"], 7)
    texts = ["what " + " ".join(vocab[10:10 + n]) for n in (3, 9, 40)]
    texts.append("what nosuchword " + vocab[20])
    ids, mask = tokenize.encode(texts, vocab, 24)
    feats = convert_questions_to_features(texts, port.tokenizer(vocab), 24)
    assert (ids == np.stack([f.input_ids for f in feats])).all()
    assert (mask == np.stack([f.attention_mask for f in feats])).all()


def test_tower_matches_the_port_in_float32():
    from densephrases_tpu_torch.models.encoder import embed_query

    sd = inputs.make_weights(MODEL, WEIGHTS, 3, CPU, dtype=torch.float32)
    params = port.encoder_params(MODEL, sd, CPU)
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(5, 300, (6, 16), generator=g)
    mask = torch.ones(6, 16, dtype=torch.long)
    mask[1:, 9:] = 0
    qs, qe = bert.encode(sd, MODEL, ids, mask)
    ps, pe = embed_query(params, ids, mask, compute_dtype=torch.float32)
    torch.testing.assert_close(qs, ps, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(qe, pe, rtol=1e-4, atol=1e-4)
    assert (qs - qe).abs().max() > 0.1  # two towers, two sets of weights


def test_fp8_control_moves_the_queries_far_more_than_rounding():
    sd = inputs.make_weights(MODEL, WEIGHTS, 3, CPU, dtype=torch.float32)
    ids = torch.randint(5, 300, (4, 16),
                        generator=torch.Generator().manual_seed(1))
    mask = torch.ones(4, 16, dtype=torch.long)
    q32, _ = bert.encode(sd, MODEL, ids, mask)
    q8, _ = bert.encode(sd, MODEL, ids, mask, bert.fp8)
    assert float((q8 - q32).norm() / q32.norm()) > 0.03


def test_exact_topk_and_spread_against_numpy():
    corpus = torch.randint(-60, 61, (3000, 32), dtype=torch.int8,
                           generator=torch.Generator().manual_seed(2))
    q = torch.randn(5, 32, generator=torch.Generator().manual_seed(3))
    old = search.BLOCK_ROWS
    search.BLOCK_ROWS = 700  # several blocks, the last one short
    try:
        vals, ids, std = search.exact_scores_topk(corpus, -2.0, 20.0, q, 7)
    finally:
        search.BLOCK_ROWS = old
    full = q.double() @ (corpus.double() / 20.0 - 2.0).T
    want_v, want_i = torch.topk(full, 7, dim=1)
    assert (ids == want_i).all()
    torch.testing.assert_close(vals.double(), want_v, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(std.double(), full.std(1, unbiased=False),
                               rtol=1e-4, atol=1e-4)


def test_rescore_matches_the_ports_rescore():
    from densephrases_tpu_torch.index.search import _rescore_spans

    vpd, n_docs, d, k, max_len = 20, 30, 16, 5, 10
    g = torch.Generator().manual_seed(4)
    corpus = torch.randint(-60, 61, (vpd * n_docs, d), dtype=torch.int8,
                           generator=g)
    qs, qe = torch.randn(3, d, generator=g), torch.randn(3, d, generator=g)
    vals, ids, _ = search.exact_scores_topk(corpus, -2.0, 20.0,
                                            torch.cat([qs, qe]), k)
    got = search.rescore(corpus, -2.0, 20.0, qs, qe, ids[:3], ids[3:],
                         vals[:3], vals[3:], vpd, max_len)
    rows = torch.arange(vpd * n_docs)
    ref = _rescore_spans(qs, qe, ids[:3].int(), ids[3:].int(), vals[:3],
                         vals[3:], corpus, (rows % vpd).int(),
                         (rows // vpd + 1) * vpd, (rows // vpd) * vpd,
                         -2.0, 20.0, max_answer_length=max_len)
    span_s, span_e, score = got
    assert (span_e[:, :k] - ids[:3] == ref["end_offset"]).all()
    assert (span_s[:, k:] - ids[3:] == ref["start_offset"]).all()
    torch.testing.assert_close(score[:, :k], ref["joint_from_start"])
    torch.testing.assert_close(score[:, k:], ref["joint_from_end"])
    answers = search.answers(span_s, span_e, score, vpd, k)
    for lst, sc in zip(answers, score):
        assert [a["score"] for a in lst] == sorted(
            [a["score"] for a in lst], reverse=True)
        assert lst[0]["score"] == pytest.approx(float(sc.max()))
