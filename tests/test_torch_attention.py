"""Port's attention (densephrases_tpu_torch/models/attention.py) against the
JAX reference: ``attention_plain`` vs ``attention_xla`` and vs the Pallas
kernel in interpret mode, on the same numpy inputs. The CUDA kernel itself
needs a GPU; ``chip_smoke.py`` holds it against ``attention_plain`` there."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densephrases_tpu.models.attention import attention_pallas, attention_xla
from densephrases_tpu_torch.models.attention import (
    ATTENTION_FWD,
    attention,
    attention_cuda,
    attention_plain,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs(b, h, l, d, seed=0):
    """q, k, v ~ N(0, 1); ragged masks (row i keeps l - 5i tokens) and the
    last row fully masked, like the dump's all-zero pad windows."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, l, d)).astype(np.float32)
               for _ in range(3))
    mask = np.ones((b, l), np.float32)
    for i in range(b):
        mask[i, max(1, l - 5 * i):] = 0
    mask[-1] = 0
    return q, k, v, mask


def _torch(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


@pytest.mark.parametrize("l", [24, 130])
def test_plain_matches_xla_fp32(l):
    q, k, v, mask = _inputs(3, 2, l, 16)
    ref = np.asarray(attention_xla(*(jnp.asarray(a) for a in (q, k, v, mask))))
    out = attention_plain(*_torch(q, k, v, mask)).numpy()
    # fp32 on both sides; only the summation order differs
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("l", [24, 130])
def test_plain_matches_xla_bf16(l):
    q, k, v, mask = _inputs(3, 2, l, 16, seed=1)
    ref = attention_xla(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                        jnp.asarray(mask))
    ref = np.asarray(ref.astype(jnp.float32))
    qt, kt, vt = _torch(q, k, v, dtype=torch.bfloat16)
    out = attention_plain(qt, kt, vt, torch.from_numpy(mask))
    assert out.dtype == torch.bfloat16
    # both round scores and probabilities to bf16 at the same points; the
    # sums run in another order, so an element may land one bf16 ulp
    # (7.8e-3 at magnitude 1) or two apart
    np.testing.assert_allclose(out.float().numpy(), ref, atol=2e-2)


@pytest.mark.parametrize("l", [24, 130])
def test_plain_matches_pallas_interpret(l):
    q, k, v, mask = _inputs(2, 2, l, 16, seed=2)
    ref = np.asarray(attention_pallas(
        *(jnp.asarray(a) for a in (q, k, v, mask)), interpret=True))
    out = attention_plain(*_torch(q, k, v, mask)).numpy()
    # the interpreter's dots run at the TPU's default (bf16-pass) matmul
    # precision, so they agree to bf16 accumulation tolerance, as in
    # tests/test_bert.py::test_pallas_attention_matches_xla
    np.testing.assert_allclose(out, ref, atol=2e-2)
    assert np.corrcoef(out.ravel(), ref.ravel())[0, 1] > 0.99999


def test_fully_masked_row_is_uniform_average_of_v():
    q, k, v, mask = _inputs(2, 2, 24, 16, seed=3)
    out = attention_plain(*_torch(q, k, v, mask)).numpy()
    # the additive -1e9 bias is the same for every key of a fully masked
    # row, so its softmax is uniform (not NaN, not zero)
    np.testing.assert_allclose(out[-1], np.broadcast_to(
        v[-1].mean(axis=1, keepdims=True), out[-1].shape), atol=1e-5)


def test_cpu_dispatch_takes_plain_path():
    q, k, v, mask = _torch(*_inputs(2, 2, 24, 16, seed=4))
    before = ATTENTION_FWD.launches
    out = attention(q, k, v, mask)
    assert torch.equal(out, attention_plain(q, k, v, mask))
    assert ATTENTION_FWD.launches == before


@pytest.mark.parametrize("call", ["dispatch", "wrapper"])
def test_kernel_on_cpu_tensor_raises(call):
    q, k, v, mask = _torch(*_inputs(2, 2, 24, 16, seed=5))
    with pytest.raises(ValueError, match="CUDA"):
        if call == "dispatch":
            attention(q, k, v, mask, impl="cuda")
        else:
            attention_cuda(q, k, v, mask)


def test_unknown_impl_raises():
    q, k, v, mask = _torch(*_inputs(2, 2, 8, 16))
    with pytest.raises(ValueError, match="unknown attention impl"):
        attention(q, k, v, mask, impl="pallas")


def test_library_hash_covers_shared_headers(tmp_path, monkeypatch):
    # kernels A and B include csrc/attention_tiles.cuh: editing the header
    # must rebuild them, not load a stale library
    from densephrases_tpu_torch.utils import cuda_build

    monkeypatch.setattr(cuda_build, "CSRC_DIR", tmp_path)
    (tmp_path / "k.cu").write_text('#include "tiles.cuh"\n')
    (tmp_path / "tiles.cuh").write_text("// v1\n")
    kernel = cuda_build.CudaKernel("k.cu", "k", [])
    before = kernel.library_path()
    (tmp_path / "tiles.cuh").write_text("// v2\n")
    assert kernel.library_path() != before
    assert kernel.library_path().name.startswith("k-")


def test_import_needs_no_nvcc(tmp_path):
    # no toolkit on PATH and no CUDA_HOME: importing the kernel's module and
    # hashing its source must work; only a launch builds the library
    env = {k: v for k, v in os.environ.items()
           if k not in ("CUDA_HOME", "CUDA_PATH")}
    env["PATH"] = str(tmp_path)
    env["PYTHONPATH"] = REPO
    code = ("from densephrases_tpu_torch.models.attention import ATTENTION_FWD\n"
            "assert ATTENTION_FWD._fn is None\n"
            "print(ATTENTION_FWD.library_path().name)\n")
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("attention_fwd-")
