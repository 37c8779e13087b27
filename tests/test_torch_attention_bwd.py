"""Port's attention backward (kernel B's plain twin and the autograd
Function) against the JAX reference: ``attention_bwd_plain`` vs the Pallas
backward in interpret mode and vs ``jax.vjp`` of ``attention_xla``, on the
same numpy inputs; the logsumexp twin ``attention_lse_plain`` against a
numpy logsumexp of the reference's scores. The CUDA kernels need a GPU;
``chip_smoke.py`` phase 2b holds them against the plain twins there.

``_model_fwd`` and ``_model_bwd`` model the tensor-core kernels' rounding on
the CPU (bf16 unnormalised P into P·V, fp32 lse, delta from the bf16
output, bf16 dS and Pᵀ into the backward products): held against the
reference at ``chip_smoke.py``'s tolerances, they show that those rounding
points fit inside them before any card runs the kernels."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densephrases_tpu.models.attention import (
    attention_pallas,
    attention_vjp_pallas,
    attention_xla,
)
from densephrases_tpu_torch.models.attention import (
    ATTENTION_BWD,
    ATTENTION_FWD,
    NEG_INF,
    attention,
    attention_bwd_plain,
    attention_cuda_bwd,
    attention_function,
    attention_lse_plain,
    attention_plain,
    mask_offset,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# chip_smoke.py's tolerances for bf16: kernel A vs attention_plain (max abs),
# kernel B vs attention_bwd_plain and the autograd Function vs autograd of
# attention_plain (max abs over max |ref|)
KERNEL_TOL_BF16, ATTN_BWD_RTOL_BF16, FN_VS_AUTOGRAD_RTOL_BF16 = 3e-2, 1e-2, 5e-2
TILE = 64  # keys per K/V tile of kernel A


def _inputs(b, h, l, d, seed=0):
    """q, k, v, g ~ N(0, 1); ragged masks (row i keeps l - 5i tokens) and
    the last row fully masked."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((b, h, l, d)).astype(np.float32)
                  for _ in range(4))
    mask = np.ones((b, l), np.float32)
    for i in range(b):
        mask[i, max(1, l - 5 * i):] = 0
    mask[-1] = 0
    return q, k, v, g, mask


def _rel(got, want):
    """max |got - want| over max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _plain(q, k, v, g, mask, dtype):
    return [x.float().numpy() for x in attention_bwd_plain(
        *(torch.from_numpy(a).to(dtype) for a in (q, k, v)),
        torch.from_numpy(mask), torch.from_numpy(g).to(dtype))]


@pytest.mark.parametrize("l", [24, 130])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_interpret(l, dtype):
    q, k, v, g, mask = _inputs(3, 2, l, 16, seed=l)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    ref = attention_vjp_pallas(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                               jnp.asarray(mask), jnp.asarray(g, jdt),
                               interpret=True)
    out = _plain(q, k, v, g, mask, getattr(torch, dtype))
    # the same formula from the same (rounded) inputs, fp32 inside: in fp32
    # only the summation order differs (~1e-6 of the largest gradient); in
    # bf16 both round one fp32 result once, so they sit at most a bf16 ulp
    # (2^-8 of the largest gradient) apart
    tol = 1e-5 if dtype == "float32" else 2 ** -8
    for got, want in zip(out, ref):
        assert _rel(got, np.asarray(want.astype(jnp.float32))) <= tol


@pytest.mark.parametrize("l", [24, 130])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_xla_vjp(l, dtype):
    q, k, v, g, mask = _inputs(3, 2, l, 16, seed=l + 1)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jm = jnp.asarray(mask)
    _, vjp = jax.vjp(lambda a, b, c: attention_xla(a, b, c, jm),
                     *(jnp.asarray(a, jdt) for a in (q, k, v)))
    ref = vjp(jnp.asarray(g, jdt))
    out = _plain(q, k, v, g, mask, getattr(torch, dtype))
    # fp32: the same gradient by another route (autodiff of the softmax vs
    # the closed form), 1e-5 of the largest gradient. bf16: attention_xla
    # rounds the scores and probabilities to bf16 and jax.vjp differentiates
    # that rounded path, while the kernel's formula stays in fp32 until the
    # outputs, so they agree to a few percent of the largest gradient
    tol = 1e-5 if dtype == "float32" else 5e-2
    for got, want in zip(out, ref):
        want = np.asarray(want.astype(jnp.float32))
        assert _rel(got, want) <= tol
        assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.999


def test_fully_masked_row_gradients_match_reference():
    # the -1e9 bias is the same for every key of a fully masked row: P is
    # uniform and the gradients are not zero, in the reference and here
    q, k, v, g, mask = _inputs(2, 2, 24, 16, seed=7)
    ref = attention_vjp_pallas(*(jnp.asarray(a) for a in (q, k, v)),
                               jnp.asarray(mask), jnp.asarray(g),
                               interpret=True)
    out = _plain(q, k, v, g, mask, torch.float32)
    for got, want in zip(out, ref):
        assert np.abs(got[-1]).max() > 0.1
        np.testing.assert_allclose(got[-1], np.asarray(want)[-1], atol=1e-5)


def _plain_fwd(q, k, v, mask):
    return attention_plain(q, k, v, mask), attention_lse_plain(q, k, mask)


def _plain_bwd(q, k, v, mask, g, out, lse):
    return attention_bwd_plain(q, k, v, mask, g)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_function_from_plain_pair_matches_autograd(dtype):
    q, k, v, g, mask = _inputs(3, 2, 40, 16, seed=11)
    tdt = getattr(torch, dtype)
    fn = attention_function(_plain_fwd, _plain_bwd)
    grads = {}
    for name, f in (("function", fn.apply), ("autograd", attention_plain)):
        leaves = [torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v)]
        out = f(*leaves, torch.from_numpy(mask))
        out.backward(torch.from_numpy(g).to(tdt))
        grads[name] = [out.detach()] + [t.grad for t in leaves]
    # the forward is the same function, so outputs are identical. fp32
    # gradients: closed form vs autodiff, 1e-5 of the largest. bf16:
    # autograd differentiates the bf16-rounded forward, so a few percent
    assert torch.equal(grads["function"][0], grads["autograd"][0])
    tol = 1e-5 if dtype == "float32" else 5e-2
    for got, want in zip(grads["function"][1:], grads["autograd"][1:]):
        assert got.dtype == tdt
        assert _rel(got.float().numpy(), want.float().numpy()) <= tol


def test_cpu_dispatch_is_differentiable_and_launches_nothing():
    q, k, v, g, mask = _inputs(2, 2, 24, 16, seed=5)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    fwd, bwd = ATTENTION_FWD.launches, ATTENTION_BWD.launches
    attention(*leaves, torch.from_numpy(mask)).backward(torch.from_numpy(g))
    assert (ATTENTION_FWD.launches, ATTENTION_BWD.launches) == (fwd, bwd)
    want = _plain(q, k, v, g, mask, torch.float32)
    for t, w in zip(leaves, want):
        assert _rel(t.grad.numpy(), w) <= 1e-5


@pytest.mark.parametrize("call", ["wrapper", "function"])
def test_cuda_entry_on_cpu_tensors_raises(call):
    q, k, v, g, mask = (torch.from_numpy(a) for a in _inputs(2, 2, 24, 16))
    before = ATTENTION_BWD.launches
    with pytest.raises(ValueError, match="CUDA"):
        if call == "wrapper":
            attention_cuda_bwd(q, k, v, mask, g, q, torch.zeros(2, 2, 24))
        else:  # a gradient is asked for: through AttentionCuda
            attention(q.requires_grad_(), k, v, mask, impl="cuda")
    assert ATTENTION_BWD.launches == before


def _np_reference_lse(q, k, mask):
    """float64 logsumexp over keys of the Pallas kernel's fp32 scores."""
    d = q.shape[-1]
    scores = np.einsum("bhqd,bhkd->bhqk", q, k).astype(np.float32) \
        * np.float32(1.0 / d ** 0.5)
    scores = scores + ((1.0 - mask) * np.float32(NEG_INF))[:, None, None, :]
    s = scores.astype(np.float64)
    m = s.max(-1, keepdims=True)
    return (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]


@pytest.mark.parametrize("l", [24, 130])
def test_lse_plain_matches_numpy_logsumexp(l):
    q, k, _, _, mask = _inputs(3, 2, l, 16, seed=l + 5)
    got = attention_lse_plain(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == (3, 2, l)
    offset = mask_offset(torch.from_numpy(mask)).double().numpy()
    want = _np_reference_lse(q, k, mask)
    # fp32 logsumexp of fp32 scores vs float64 of the same scores; the
    # fully masked row (the last) is log L above its -1e9 offset
    np.testing.assert_allclose(got.double().numpy() + offset[:, None, None],
                               want, rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(got[-1].numpy(), np.log(l), rtol=1e-6)
    assert offset.tolist() == [0.0, 0.0, NEG_INF]


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _model_fwd(q, k, v, mask):
    """Kernel A's bf16 path on the CPU, rounded where the kernel rounds:
    fp32 scores of bf16 inputs less the mask offset, an online softmax over
    64-key tiles, the unnormalised P rounded to bf16 into P·V, fp32 row
    sums, one normalisation at the end. Returns bf16 out and fp32 lse."""
    q, k, v = (t.float() for t in (q, k, v))
    b, h, l, d = q.shape
    scale = 1.0 / d ** 0.5
    bias = ((1.0 - mask.float()) * NEG_INF)[:, None, None, :]
    off = mask_offset(mask)[:, None, None, None]
    m = torch.full((b, h, l, 1), -np.inf)
    total = torch.zeros(b, h, l, 1)
    o = torch.zeros(b, h, l, d)
    for k0 in range(0, l, TILE):
        s = torch.einsum("bhqd,bhkd->bhqk", q, k[:, :, k0:k0 + TILE]) * scale \
            + bias[..., k0:k0 + TILE] - off
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        total = total * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + torch.einsum("bhqk,bhkd->bhqd", _bf16(p),
                                     v[:, :, k0:k0 + TILE])
        m = m_new
    return (o / total).to(torch.bfloat16), (m + torch.log(total))[..., 0]


def _model_bwd(q, k, v, mask, g, out, lse):
    """Kernel B's bf16 path on the CPU: P = exp(S - offset - lse), delta
    from the bf16 output, dS and Pᵀ rounded to bf16 into the products,
    fp32 sums, bf16 gradients."""
    q, k, v, g, out = (t.float() for t in (q, k, v, g, out))
    scale = 1.0 / q.shape[-1] ** 0.5
    bias = ((1.0 - mask.float()) * NEG_INF)[:, None, None, :]
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale + bias \
        - mask_offset(mask)[:, None, None, None]
    p = torch.exp(s - lse[..., None])
    delta = (g * out).sum(-1, keepdim=True)
    ds = _bf16(p * (torch.einsum("bhqd,bhkd->bhqk", g, v) - delta) * scale)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q)
    dv = torch.einsum("bhqk,bhqd->bhkd", _bf16(p), g)
    return [x.to(torch.bfloat16) for x in (dq, dk, dv)]


# chip_smoke.py phase 2b's ragged shapes (every head dim), plus the phrase
# tower's L = 384 and a short sequence
MODEL_SHAPES = [(3, 2, 130, 16), (2, 3, 77, 32), (3, 2, 100, 64),
                (2, 2, 200, 128), (2, 2, 384, 64), (4, 2, 29, 64)]


def _bf16_inputs(shape, seed):
    q, k, v, g, mask = _inputs(*shape, seed=seed)
    jq, jk, jv, jg = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, g))
    tq, tk, tv, tg = (torch.from_numpy(a).to(torch.bfloat16)
                      for a in (q, k, v, g))
    return (jq, jk, jv, jg, jnp.asarray(mask)), (tq, tk, tv, tg,
                                                  torch.from_numpy(mask))


@pytest.mark.parametrize("shape", MODEL_SHAPES, ids=str)
def test_kernel_model_fwd_within_chip_tolerance(shape):
    (jq, jk, jv, _, jm), (q, k, v, _, mask) = _bf16_inputs(shape, seed=21)
    out, lse = _model_fwd(q, k, v, mask)
    ref = np.asarray(attention_pallas(jq, jk, jv, jm, interpret=True)
                     .astype(jnp.float32))
    plain = attention_plain(q, k, v, mask).float().numpy()
    for want in (ref, plain):
        assert np.abs(out.float().numpy() - want).max() <= KERNEL_TOL_BF16
    np.testing.assert_allclose(lse.numpy(),
                               attention_lse_plain(q, k, mask).numpy(),
                               rtol=1e-5, atol=1e-5)
    # the fully masked row: a uniform average of V, lse = log L
    np.testing.assert_allclose(
        out[-1].float().numpy(),
        np.broadcast_to(v[-1].float().mean(1, keepdim=True).numpy(),
                        out[-1].shape), atol=KERNEL_TOL_BF16)
    np.testing.assert_allclose(lse[-1].numpy(), np.log(shape[2]), rtol=1e-6)


@pytest.mark.parametrize("shape", MODEL_SHAPES, ids=str)
def test_kernel_model_bwd_within_chip_tolerance(shape):
    (jq, jk, jv, jg, jm), (q, k, v, g, mask) = _bf16_inputs(shape, seed=22)
    out, lse = _model_fwd(q, k, v, mask)
    got = [x.float().numpy() for x in _model_bwd(q, k, v, mask, g, out, lse)]
    pallas = attention_vjp_pallas(jq, jk, jv, jm, jg, interpret=True)
    _, vjp = jax.vjp(lambda a, b, c: attention_xla(a, b, c, jm), jq, jk, jv)
    for mine, ref, xla in zip(got, pallas, vjp(jg)):
        # kernel B is held against attention_bwd_plain, which sits within a
        # bf16 ulp of the Pallas backward (test_plain_matches_pallas_interpret)
        assert _rel(mine, np.asarray(ref.astype(jnp.float32))) \
            <= ATTN_BWD_RTOL_BF16
        # AttentionCuda is held against autograd of the bf16-rounded forward
        assert _rel(mine, np.asarray(xla.astype(jnp.float32))) \
            <= FN_VS_AUTOGRAD_RTOL_BF16
        assert np.abs(mine[-1]).max() > 0.0  # the fully masked row learns


def test_function_from_model_pair_matches_plain_twins():
    # the (out, lse) residuals reach the backward: a Function from the
    # rounding models agrees with the plain twins in bf16
    _, (q, k, v, g, mask) = _bf16_inputs((3, 2, 70, 16), seed=23)
    fn = attention_function(_model_fwd, _model_bwd)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fn.apply(*leaves, mask)
    out.backward(g)
    want = attention_bwd_plain(q, k, v, mask, g)
    assert out.dtype == torch.bfloat16
    for t, w in zip(leaves, want):
        assert t.grad.dtype == torch.bfloat16
        assert _rel(t.grad.float().numpy(), w.float().numpy()) \
            <= ATTN_BWD_RTOL_BF16


def test_import_needs_no_nvcc(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k not in ("CUDA_HOME", "CUDA_PATH")}
    env["PATH"] = str(tmp_path)
    env["PYTHONPATH"] = REPO
    code = ("from densephrases_tpu_torch.models.attention import ATTENTION_BWD\n"
            "assert ATTENTION_BWD._fn is None and ATTENTION_BWD.launches == 0\n"
            "print(ATTENTION_BWD.library_path().name)\n")
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("attention_bwd-")
