"""Port's BERT towers and weight bridge against the JAX reference: the same
``init_encoder_params(PRNGKey(0))`` weights, bridged with
``models/from_jax.py``, give the same tower outputs, ``embed_query`` and
``embed_phrase``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densephrases_tpu.models.bert import BertConfig as JaxBertConfig
from densephrases_tpu.models.bert import bert_forward
from densephrases_tpu.models.encoder import embed_phrase as jax_embed_phrase
from densephrases_tpu.models.encoder import embed_query as jax_embed_query
from densephrases_tpu.models.encoder import init_encoder_params as jax_init
from densephrases_tpu_torch.models.bert import BertConfig
from densephrases_tpu_torch.models.encoder import (
    embed_phrase,
    embed_query,
    init_encoder_params,
)
from densephrases_tpu_torch.models.from_jax import encoder_from_jax


@pytest.fixture(scope="module")
def cfgs():
    return JaxBertConfig.tiny(), BertConfig.tiny()


@pytest.fixture(scope="module")
def jax_params(cfgs):
    return jax_init(jax.random.PRNGKey(0), cfgs[0])


@pytest.fixture(scope="module")
def bridged(cfgs, jax_params):
    return encoder_from_jax(jax.tree.map(np.asarray, jax_params), cfgs[1],
                            device="cpu")


def _batch(cfg, b=3, l=20, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_size, size=(b, l)).astype(np.int32)
    mask = np.ones((b, l), np.int32)
    for i in range(b):
        mask[i, l - 4 * i - 1:] = 0
    tt = np.zeros((b, l), np.int32)
    tt[:, l // 2:] = 1
    return ids, mask, tt


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("tower", ["phrase", "query_start", "query_end"])
def test_tower_matches_fp32(cfgs, jax_params, bridged, tower):
    ids, mask, tt = _batch(cfgs[1])
    ref = bert_forward(jax_params[tower], jnp.asarray(ids), jnp.asarray(mask),
                       jnp.asarray(tt), config=cfgs[0], attn_impl="xla",
                       compute_dtype=jnp.float32, remat="none")
    out = getattr(bridged, tower)(*_t(ids, mask, tt),
                                  compute_dtype=torch.float32)
    # fp32 throughout on both sides; LN outputs are O(1), so 1e-5 absolute
    # covers the different summation orders
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-5)


def test_embed_query_matches_bf16(cfgs, jax_params, bridged):
    ids, mask, tt = _batch(cfgs[1], seed=1)
    rs, re_ = jax_embed_query(jax_params, cfgs[0], jnp.asarray(ids),
                              jnp.asarray(mask), jnp.asarray(tt),
                              attn_impl="xla")
    qs, qe = embed_query(bridged, *_t(ids, mask, tt))
    for out, ref in ((qs, rs), (qe, re_)):
        assert out.shape == ref.shape and out.dtype == torch.float32
        # bf16 compute rounds at the same points in both packages; a value
        # that lands one bf16 ulp apart (7.8e-3 at magnitude 1) carries
        # through the later layers, so compare loosely, and on average
        diff = np.abs(out.numpy() - np.asarray(ref))
        assert diff.max() < 0.05, diff.max()
        assert diff.mean() < 1e-2, diff.mean()


def test_embed_phrase_matches_bf16(cfgs, jax_params, bridged):
    ids, mask, tt = _batch(cfgs[1], seed=2)
    ref = jax_embed_phrase(jax_params, cfgs[0], jnp.asarray(ids),
                           jnp.asarray(mask), jnp.asarray(tt),
                           attn_impl="xla")
    out = embed_phrase(bridged, *_t(ids, mask, tt))
    for o, r in zip(out, ref):
        # as in test_embed_query_matches_bf16
        diff = np.abs(o.numpy() - np.asarray(r))
        assert diff.max() < 0.05, diff.max()
        assert diff.mean() < 1e-2, diff.mean()


def test_embed_phrase_fp32_filter_head(cfgs, jax_params, bridged):
    ids, mask, tt = _batch(cfgs[1], seed=3)
    hidden = bert_forward(jax_params["phrase"], jnp.asarray(ids),
                          jnp.asarray(mask), jnp.asarray(tt), config=cfgs[0],
                          attn_impl="xla", compute_dtype=jnp.float32,
                          remat="none")
    flt = np.asarray(hidden) @ np.asarray(jax_params["filter"]["w"])
    start, end, fs, fe = embed_phrase(bridged, *_t(ids, mask, tt),
                                      compute_dtype=torch.float32)
    assert start is end
    # fp32 throughout; the head sums 64 products of O(1) and O(0.02) terms
    np.testing.assert_allclose(fs.numpy(), flt[..., 0], atol=1e-5)
    np.testing.assert_allclose(fe.numpy(), flt[..., 1], atol=1e-5)


def test_mask_invariance(cfgs, bridged):
    # changing ids under the padding mask must not change unmasked outputs
    # (tests/test_bert.py::test_bert_forward_shape_and_mask_invariance)
    cfg = cfgs[1]
    b, l = 2, 16
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, size=(b, l)).astype(np.int32)
    mask = np.ones((b, l), np.int32)
    mask[:, 12:] = 0
    ids2 = ids.copy()
    ids2[:, 12:] = (ids2[:, 12:] + 7) % cfg.vocab_size
    out = bridged.phrase(*_t(ids, mask), compute_dtype=torch.float32)
    out2 = bridged.phrase(*_t(ids2, mask), compute_dtype=torch.float32)
    assert out.shape == (b, l, cfg.hidden_size)
    np.testing.assert_allclose(out[:, :12].detach().numpy(),
                               out2[:, :12].detach().numpy(), atol=1e-5)


def test_bridge_to_bf16(cfgs, jax_params):
    tree = jax.tree.map(np.asarray, jax_params)
    params = encoder_from_jax(tree, cfgs[1], device="cpu",
                              dtype=torch.bfloat16)
    got = params.query_end.layers[1].ffn_in_w
    assert got.dtype == torch.bfloat16
    want = jnp.asarray(tree["query_end"]["layers"]["ffn_in_w"][1], jnp.bfloat16)
    np.testing.assert_array_equal(got.detach().float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_bridge_rejects_wrong_shapes(cfgs, jax_params):
    tree = jax.tree.map(np.asarray, jax_params)
    wrong = BertConfig.tiny(vocab_size=cfgs[1].vocab_size + 1)
    with pytest.raises(ValueError, match="embed/word"):
        encoder_from_jax(tree, wrong, device="cpu")


def test_init_is_seeded_and_query_towers_copy_phrase(cfgs):
    cfg = cfgs[1]
    a = init_encoder_params(cfg, torch.Generator().manual_seed(3),
                            device="cpu")
    b = init_encoder_params(cfg, torch.Generator().manual_seed(3),
                            device="cpu")
    c = init_encoder_params(cfg, torch.Generator().manual_seed(4),
                            device="cpu")
    for (name, pa), pb in zip(a.state_dict().items(),
                              b.state_dict().values()):
        assert torch.equal(pa, pb), name
    assert not torch.equal(a.phrase.layers[0].q_w, c.phrase.layers[0].q_w)
    for tower in (a.query_start, a.query_end):
        for (name, p), q in zip(tower.state_dict().items(),
                                a.phrase.state_dict().values()):
            assert torch.equal(p, q), name
    assert float(a.phrase.layers[0].q_w.std()) == pytest.approx(
        cfg.initializer_range, rel=0.1)
    assert torch.equal(a.phrase.ln_scale, torch.ones(cfg.hidden_size))


def test_cuda_device_without_gpu_raises(cfgs):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="cuda"):
        init_encoder_params(cfgs[1], device="cuda")
