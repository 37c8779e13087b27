"""Port's attention backward (kernel B's plain twin and the autograd
Function) against the JAX reference: ``attention_bwd_plain`` vs the Pallas
backward in interpret mode and vs ``jax.vjp`` of ``attention_xla``, on the
same numpy inputs. The CUDA kernel itself needs a GPU; ``chip_smoke.py``
phase 2b holds it against ``attention_bwd_plain`` there."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densephrases_tpu.models.attention import attention_vjp_pallas, attention_xla
from densephrases_tpu_torch.models.attention import (
    ATTENTION_BWD,
    ATTENTION_FWD,
    attention,
    attention_bwd_plain,
    attention_cuda_bwd,
    attention_function,
    attention_plain,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_function_from_plain_pair_matches_autograd(dtype):
    q, k, v, g, mask = _inputs(3, 2, 40, 16, seed=11)
    tdt = getattr(torch, dtype)
    fn = attention_function(attention_plain, attention_bwd_plain)
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
            attention_cuda_bwd(q, k, v, mask, g)
        else:
            attention(q, k, v, mask, impl="cuda")
    assert ATTENTION_BWD.launches == before


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
