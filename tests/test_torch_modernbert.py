"""ModernBERT query towers (``models/modernbert.py``) and kernel A's banded
instance (``models/attention.py`` with a window, ``csrc/attention_band.cu``).

On the CPU at a tiny size (hidden 64, 4 heads, 6 layers: two periods of the
layer pattern, a band of half-width 8): the port's tower against the
benchmark's plain float32 reference (``portbench/reference/modernbert.py``)
on seeded weights; the banded plain twin against a dense masked softmax;
layer 0's identity norm and each layer kind's RoPE theta and window; the
checkpoint key map both ways; ``window=None`` bit for bit the full twin;
answers bit for bit with tracing on and off, and the attention counters.
On the card (skipped without one): the band kernel against its twin at the
benchmark cell's shape and at edge shapes, kernel A's global path at L
8,192, and the towers through the kernels against the plain path. This
file imports no JAX, so on a card's machine without it:

    python -m pytest --noconftest tests/test_torch_modernbert.py -q
"""

import dataclasses
import importlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from densephrases_tpu_torch import bench
from densephrases_tpu_torch.models import attention as attn_mod
from densephrases_tpu_torch.models import hf_import
from densephrases_tpu_torch.models import modernbert as mb
from densephrases_tpu_torch.models.attention import (
    NEG_INF, attention, attention_plain, band_pairs)
from densephrases_tpu_torch.models.encoder import (
    EncoderParams, embed_query, init_encoder_params)
from densephrases_tpu_torch.models.modernbert import (
    ModernBertConfig, ModernBertModel)
from densephrases_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:  # the benchmark's reference lives beside
    sys.path.insert(0, str(REPO))
ref_mb = importlib.import_module("portbench.reference.modernbert")
ref_bert = importlib.import_module("portbench.reference.bert")

# two periods of the layer pattern (global, local, local), a band of 8 each
# side; weights N(0, 0.15), so that the tiny towers mix their tokens as much
# as the published width does at 0.05 (the benchmark's tiny runs' choice)
CFG = dataclasses.replace(ModernBertConfig.tiny(), initializer_range=0.15)
L = 40
# the port in float32 against the reference: the same products and sums,
# taken in another order (einsum blocks, fused layer norm); measured 1.2e-6
FP32_RTOL = 1e-4
# the port in bf16 (its serve type) against the float32 reference: the
# residual stream, q, k, v, the GeGLU product and P rounded to bf16 (2^-9
# relative each) through 6 layers move the [CLS] vector by 3.8% of its
# norm at this size (measured); fp8 e4m3 towers (2^-4 relative) move it by
# 50%, which this rejects
BF16_RTOL = 0.1


def _ids_mask(seed=0, b=4, l=L):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(5, CFG.vocab_size, (b, l), generator=g)
    mask = torch.ones(b, l, dtype=torch.long)
    for r, n in enumerate((l, 31, 9, 17)[:b]):  # padded rows
        mask[r, n:] = 0
        ids[r, n:] = 0
    return ids, mask


def _params(seed=0):
    return init_encoder_params(CFG, torch.Generator().manual_seed(seed),
                               device="cpu")


def _reference(params, ids, mask, rnd=ref_bert.identity):
    sd = hf_import.modernbert_state_dict_from_encoder(params)
    return ref_mb.encode(sd, dataclasses.asdict(CFG), ids, mask, rnd)


def _rel(got, want):
    return float((got.float() - want.float()).norm(dim=-1).max()
                 / want.float().norm(dim=-1).min())


# ------------------------------------------------------- the tower itself
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, FP32_RTOL),
                                        (torch.bfloat16, BF16_RTOL)])
def test_tower_matches_the_plain_reference(dtype, rtol):
    params = _params()
    ids, mask = _ids_mask()
    got = embed_query(params, ids, mask, compute_dtype=dtype)
    want = _reference(params, ids, mask)
    for g, w in zip(got, want):
        assert g.shape == (4, CFG.hidden_size)
        assert _rel(g, w) < rtol, _rel(g, w)


def test_fp8_towers_fail_the_bf16_tolerance():
    params = _params()
    ids, mask = _ids_mask()
    want = _reference(params, ids, mask)
    low = _reference(params, ids, mask, rnd=ref_bert.fp8)
    assert max(_rel(g, w) for g, w in zip(low, want)) > BF16_RTOL


def test_distinct_queries_get_distinct_vectors():
    params = _params()
    ids, mask = _ids_mask()
    qs, _ = embed_query(params, ids, mask)
    dist = torch.cdist(qs.float(), qs.float())
    assert float(dist[~torch.eye(4, dtype=torch.bool)].min()) > \
        0.1 * float(qs.float().norm(dim=-1).mean())


def test_padding_does_not_move_a_query():
    """A query's vector is the same alone at its length and padded in a
    batch (its padded keys weigh exp(-1e9) = 0), to float32 rounding."""
    params = _params()
    ids, mask = _ids_mask()
    batch = embed_query(params, ids, mask, compute_dtype=torch.float32)[0]
    alone = embed_query(params, ids[2:3, :9], mask[2:3, :9],
                        compute_dtype=torch.float32)[0]
    assert _rel(alone, batch[2:3]) < FP32_RTOL


def test_layer_zero_has_no_attention_norm(monkeypatch):
    model = ModernBertModel(CFG)
    assert model.layers[0].attn_norm is None
    assert all(layer.attn_norm is not None for layer in model.layers[1:])
    model.init_weights(torch.Generator().manual_seed(0))
    calls = []
    real = mb._norm
    monkeypatch.setattr(mb, "_norm",
                        lambda x, w, eps: calls.append(w) or real(x, w, eps))
    x = torch.randn(2, 12, CFG.hidden_size)
    m = torch.ones(2, 12)
    first, second = model.layers[0], model.layers[1]
    for layer, want in ((first, [first.mlp_norm]),
                        (second, [second.attn_norm, second.mlp_norm])):
        calls.clear()
        with torch.no_grad():
            layer(x, m, CFG, "plain", torch.float32)
        assert [id(c) for c in calls] == [id(w) for w in want]


def test_each_layer_kind_takes_its_theta_and_window(monkeypatch):
    seen = []
    real_rope, real_attn = mb.rope_tables, mb.attention
    monkeypatch.setattr(mb, "rope_tables", lambda theta, *a: seen.append(
        ("theta", theta)) or real_rope(theta, *a))
    monkeypatch.setattr(mb, "attention", lambda *a, window=None, **k: seen.append(
        ("window", window)) or real_attn(*a, window=window, **k))
    model = ModernBertModel(CFG).init_weights(torch.Generator().manual_seed(0))
    ids, mask = _ids_mask(b=1)
    with torch.no_grad():
        model(ids, mask, compute_dtype=torch.float32)
    thetas = [v for k, v in seen if k == "theta"]
    windows = [v for k, v in seen if k == "window"]
    assert thetas == [160000.0, 10000.0, 10000.0] * 2
    assert windows == [None, 8, 8] * 2
    assert [CFG.is_global(i) for i in range(6)] == [True, False, False] * 2


def test_rope_tables_are_built_once_per_theta_and_length():
    mb._ROPE.clear()
    with profiling.recording() as rec:
        for _ in range(2):
            mb.rope_tables(10000.0, 24, 16, "cpu")
            mb.rope_tables(160000.0, 24, 16, "cpu")
        mb.rope_tables(10000.0, 25, 16, "cpu")
    built = [s for s in rec.spans() if s.name == "towers.rope"]
    assert [(s.attrs["theta"], s.attrs["length"]) for s in built] == [
        (10000.0, 24), (160000.0, 24), (10000.0, 25)]
    cos, sin = mb.rope_tables(10000.0, 24, 16, "cpu")
    # rotate-half: position p, dims i and i + 8 share theta^(-2i / 16)
    ang = 5 * 10000.0 ** (-2 * 3 / 16)
    assert float(cos[5, 3]) == pytest.approx(np.cos(ang), abs=1e-7)
    assert float(sin[5, 11]) == pytest.approx(np.sin(ang), abs=1e-7)


def test_training_calls_raise():
    model = ModernBertModel(CFG)
    ids, mask = _ids_mask(b=1)
    with pytest.raises(ValueError, match="serve only"):
        model(ids, mask, dropout=torch.Generator())
    with pytest.raises(ValueError, match="serve only"):
        model(ids, mask, remat="full")
    with pytest.raises(ValueError, match="no biases"):
        ModernBertConfig(norm_bias=True)


# ------------------------------------------------------ the key map
def test_hf_key_map_round_trip():
    params = _params(3)
    sd = hf_import.modernbert_state_dict_from_encoder(params)
    q = "query_start_encoder.model."
    assert {k for k in sd if k.startswith(q)} == (
        {q + "embeddings.tok_embeddings.weight", q + "embeddings.norm.weight",
         q + "final_norm.weight"}
        | {f"{q}layers.{i}.{k}" for i in range(6)
           for k in ("attn.Wqkv.weight", "attn.Wo.weight", "mlp_norm.weight",
                     "mlp.Wi.weight", "mlp.Wo.weight")}
        | {f"{q}layers.{i}.attn_norm.weight" for i in range(1, 6)})
    h, f = CFG.hidden_size, CFG.intermediate_size
    assert sd[q + "layers.2.attn.Wqkv.weight"].shape == (3 * h, h)
    assert sd[q + "layers.2.mlp.Wi.weight"].shape == (2 * f, h)
    assert sd[q + "layers.2.mlp.Wo.weight"].shape == (h, f)
    back = hf_import.modernbert_encoder_from_state_dict(sd, CFG)
    for (name, a), (name_b, b) in zip(params.named_parameters(),
                                      back.named_parameters()):
        assert name == name_b and torch.equal(a, b), name
    assert hf_import.modernbert_state_dict_from_encoder(back).keys() == sd.keys()


def test_query_towers_alone_leave_the_rest_zero():
    params = _params(4)
    sd = {k: v for k, v in hf_import.modernbert_state_dict_from_encoder(
        params).items() if k.startswith("query_")}
    got = hf_import.modernbert_encoder_from_state_dict(
        sd, CFG, towers=("query_start", "query_end"))
    assert isinstance(got, EncoderParams)
    assert torch.equal(got.query_end.layers[4].wi, params.query_end.layers[4].wi)
    assert all(float(p.abs().max()) == 0 for p in got.phrase.parameters())
    assert float(got.filter.w.abs().max()) == 0
    assert got.query_start.tok_emb.data_ptr() == \
        sd["query_start_encoder.model.embeddings.tok_embeddings.weight"].data_ptr()
    with pytest.raises(ValueError, match="shape"):
        bad = dict(sd)
        bad["query_end_encoder.model.layers.1.attn.Wo.weight"] = torch.zeros(3, 3)
        hf_import.modernbert_encoder_from_state_dict(
            bad, CFG, towers=("query_start", "query_end"))


# --------------------------------------------------- the banded plain twin
def _dense_band(q, k, v, mask, w):
    """Full scores with -1e9 on padded keys, added in fp32 as the twins
    add it (so a padded key's score rounds to -1e9), and -inf off the
    band; the products and the softmax in fp64."""
    qf, kf, vf = (t.to(torch.float64) for t in (q, k, v))
    s = (torch.einsum("bhqd,bhkd->bhqk", qf, kf) / q.shape[-1] ** 0.5).float()
    s = (s + ((1.0 - mask.float()) * NEG_INF)[:, None, None, :]).double()
    pos = torch.arange(q.shape[2])
    s = s.masked_fill((pos[:, None] - pos[None]).abs() > w, float("-inf"))
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), vf)


def _band_inputs(b, h, l, d, seed, full_pad=True):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(b, h, l, d, generator=g) for _ in range(3))
    mask = torch.ones(b, l)
    for i in range(b):
        mask[i, max(1, l - 5 * i - 3):] = 0
    if full_pad:
        mask[-1] = 0  # a fully padded row
    return q, k, v, mask


# L < 2w + 1, L not a multiple of the twin's 64-row blocks, w 0, w past L
@pytest.mark.parametrize("b,h,l,d,w", [(3, 2, 12, 16, 8), (2, 3, 130, 32, 8),
                                       (3, 2, 200, 64, 64), (2, 2, 65, 16, 0),
                                       (2, 1, 50, 16, 70), (3, 2, 129, 16, 64)])
def test_band_twin_matches_a_dense_masked_softmax(b, h, l, d, w):
    q, k, v, mask = _band_inputs(b, h, l, d, seed=l + w)
    got = attention_plain(q, k, v, mask, window=w)
    want = _dense_band(q, k, v, mask, w)
    # fp32 against fp64: sums in another order, ~1e-7 of O(1) outputs
    assert float((got.double() - want).abs().max()) < 1e-5
    # the fully padded row: each query averages V over its band
    i = l // 2
    lo, hi = max(0, i - w), min(l, i + w + 1)
    assert torch.allclose(got[-1, :, i], v[-1, :, lo:hi].mean(1), atol=1e-5)


def test_band_twin_in_bf16_rounds_where_the_full_twin_does():
    q, k, v, mask = (t.to(torch.bfloat16) if t.dim() == 4 else t
                     for t in _band_inputs(2, 2, 100, 32, seed=1))
    got = attention_plain(q, k, v, mask, window=8)
    want = _dense_band(q, k, v, mask, 8)
    # bf16 scores and probabilities: a bf16 ulp or two of O(1) outputs
    assert float((got.double() - want).abs().max()) < 3e-2


def test_a_band_that_covers_the_row_is_full_attention():
    q, k, v, mask = _band_inputs(2, 2, 70, 16, seed=2)
    full = attention_plain(q, k, v, mask)
    for w in (69, 100):
        assert torch.allclose(attention_plain(q, k, v, mask, window=w), full,
                              atol=1e-6)


def test_window_none_is_the_full_twin_bit_for_bit():
    """The full twin's formula as it stood before windows existed."""
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, mask = (t.to(dtype) if t.dim() == 4 else t
                         for t in _band_inputs(3, 2, 37, 16, seed=3))
        d = q.shape[-1]
        scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / (d ** 0.5)
        bias = (1.0 - mask[:, None, None, :].to(torch.float32)) * NEG_INF
        probs = torch.softmax(scores.to(torch.float32) + bias, -1).to(dtype)
        old = torch.einsum("bhqk,bhkd->bhqd", probs, v)
        assert torch.equal(attention_plain(q, k, v, mask), old)
        assert torch.equal(attention_plain(q, k, v, mask, window=None), old)
        assert torch.equal(attention(q, k, v, mask), old)


def test_a_long_full_twin_scores_its_rows_in_blocks(monkeypatch):
    q, k, v, mask = _band_inputs(2, 2, 70, 16, seed=5)
    whole = attention_plain(q, k, v, mask)
    monkeypatch.setattr(attn_mod, "PLAIN_SCORES_MAX", 2 * 2 * 70 * 16)
    assert torch.allclose(attention_plain(q, k, v, mask), whole, atol=1e-6)


def test_band_pairs_against_a_count():
    for l in range(1, 40):
        for w in range(0, 45):
            want = sum(min(l - 1, i + w) - max(0, i - w) + 1 for i in range(l))
            assert band_pairs(l, w) == want, (l, w)
    assert band_pairs(8192, None) == 8192 ** 2
    assert band_pairs(8192, 64) == 8192 * 129 - 64 * 65


def test_the_band_refuses_what_it_cannot_do():
    q, k, v, mask = _band_inputs(1, 1, 8, 16, seed=4)
    q.requires_grad_(True)
    with pytest.raises(ValueError, match="no backward"):
        attention(q, k, v, mask, window=2)
    with pytest.raises(ValueError, match="needs CUDA"):
        attn_mod.attention_cuda(q.detach(), k, v, mask, window=2)
    with pytest.raises(ValueError, match=">= 0"):
        attention_plain(q.detach(), k, v, mask, window=-1)


# ---------------------------------------- served, with tracing on and off
@pytest.fixture(scope="module")
def served(tmp_path_factory):
    store = bench.build_store(str(tmp_path_factory.mktemp("mb") / "store"),
                              n_docs=30, vecs_per_doc=20, d=CFG.hidden_size)
    tok = bench.bench_vocab("whole_word")
    model, fused, _ = bench.serve_model(store, CFG, tok, device="cpu")
    model.max_query_length = L
    return model, fused


TEXTS = [" ".join(["benchmark", "query", "words"][: 1 + i % 3] * (2 + 3 * i))
         for i in range(5)]


def test_answers_equal_with_tracing_on_and_off(served):
    model, fused = served
    off = fused.search(TEXTS, top_k=5)
    with profiling.recording() as rec:
        on = fused.search(TEXTS, top_k=5)
    assert on == off
    cnt = rec.counters()
    b, h, n_glob, n_loc = len(TEXTS), CFG.num_attention_heads, 2, 4
    # two towers, each two global and four local layers
    assert cnt["towers.attn_launches_global"] == 2 * n_glob
    assert cnt["towers.attn_launches_band"] == 2 * n_loc
    assert cnt["towers.attn_pairs_global"] == 2 * n_glob * b * h * L * L
    assert cnt["towers.attn_pairs_band"] == \
        2 * n_loc * b * h * (L * 17 - 8 * 9)
    assert not profiling.active()


def test_modernbert_params_serve_through_densephrases(served):
    model, _ = served
    assert isinstance(model.params.query_start, ModernBertModel)
    answers = model.search(TEXTS[:2], top_k=3)
    assert len(answers) == 2 and all(len(a) == 3 for a in answers)


# ---------------------------------------------------------------- the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


# the kernel against its twin, both bf16: the twin rounds its scores and
# probabilities to bf16, the kernel keeps fp32 scores and rounds P once;
# outputs of magnitude ~1 differ by a bf16 ulp or two (as kernel A's)
CARD_TOL = 3e-2


def _card_inputs(b, h, l, d, dev, seed):
    q, k, v, mask = _band_inputs(b, h, l, d, seed)
    return (*(t.to(dev, torch.bfloat16) for t in (q, k, v)), mask.to(dev))


def test_card_band_at_the_cell_shape(cuda):
    q, k, v, mask = _card_inputs(8, 16, 8192, 64, cuda, seed=5)
    mask[0] = 1
    got = attn_mod.attention_cuda(q, k, v, mask, window=64)
    want = attention_plain(q, k, v, mask, window=64)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert float((got.float() - want.float()).abs().max()) < CARD_TOL


@pytest.mark.parametrize("b,h,l,d,w", [
    (3, 2, 12, 16, 8), (2, 3, 130, 32, 8), (3, 2, 200, 64, 64),
    (2, 2, 65, 16, 0), (2, 1, 50, 128, 70), (3, 2, 129, 64, 64),
    (1, 4, 1000, 64, 64), (2, 2, 300, 64, 130)])
def test_card_band_at_edge_shapes(cuda, b, h, l, d, w):
    q, k, v, mask = _card_inputs(b, h, l, d, cuda, seed=l + d + w)
    got = attn_mod.attention_cuda(q, k, v, mask, window=w)
    want = attention_plain(q, k, v, mask, window=w)
    torch.cuda.synchronize()
    assert float((got.float() - want.float()).abs().max()) < CARD_TOL


def test_card_global_path_at_8192(cuda):
    q, k, v, mask = _card_inputs(1, 2, 8192, 64, cuda, seed=6)
    mask[0, 5000:] = 0
    got = attn_mod.attention_cuda(q, k, v, mask)
    want = attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    assert float((got.float() - want.float()).abs().max()) < CARD_TOL


def test_card_towers_through_the_kernels_match_the_plain_path(cuda):
    params = _params().to(cuda)
    ids, mask = (t.to(cuda) for t in _ids_mask(l=200))
    got = embed_query(params, ids, mask)
    want = embed_query(params, ids, mask, attn_impl="plain")
    for g, w in zip(got, want):
        assert _rel(g, w) < BF16_RTOL
