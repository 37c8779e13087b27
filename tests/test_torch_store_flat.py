"""Port's quantization contract, phrase store and flat index against the JAX
reference: identical codes, stores that each package opens from the other,
and identical top-k ids from the int8 scan."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densephrases_tpu.index.flat import FlatIndex as JaxFlatIndex
from densephrases_tpu.index.flat import _scan_topk as jax_scan_topk
from densephrases_tpu.index.store import DocMeta as JaxDocMeta
from densephrases_tpu.index.store import PhraseStore as JaxPhraseStore
from densephrases_tpu.index.store import StoreWriter as JaxStoreWriter
from densephrases_tpu.ops import quant as jq
from densephrases_tpu_torch.index.flat import FlatIndex, _scan_topk
from densephrases_tpu_torch.index.store import DocMeta, PhraseStore, StoreWriter
from densephrases_tpu_torch.ops import quant as tq


def _floats(seed=0, shape=(50, 64)):
    # N(-2, 2) spans the int8 clip range at both ends (offset -2, scale 20),
    # and exact .5 code boundaries exercise round-half-to-even
    rng = np.random.default_rng(seed)
    x = rng.normal(-2.0, 2.0, size=shape).astype(np.float32)
    x[0, :8] = np.array([-2.025, -1.975, -2.075, 10, -10, -2, 4.35, -8.4],
                        np.float32)
    return x


def test_float_to_int8_parity():
    x = _floats()
    ref = jq.float_to_int8(x)
    np.testing.assert_array_equal(tq.float_to_int8(x), ref)
    np.testing.assert_array_equal(tq.float_to_int8(torch.from_numpy(x)).numpy(),
                                  ref)
    np.testing.assert_array_equal(tq.int8_to_float(ref), jq.int8_to_float(ref))
    np.testing.assert_array_equal(
        tq.int8_to_float(torch.from_numpy(ref)).numpy(), jq.int8_to_float(ref))


def test_int4_parity():
    x = _floats(seed=1)
    ref = jq.float_to_int4(x)
    np.testing.assert_array_equal(tq.float_to_int4(x), ref)
    got = tq.float_to_int4(torch.from_numpy(x))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(tq.int4_to_float(ref), jq.int4_to_float(ref))
    np.testing.assert_array_equal(
        tq.int4_to_float(torch.from_numpy(ref)).numpy(), jq.int4_to_float(ref))
    assert (tq.INT4_OFFSET, tq.INT4_SCALE, tq.DEFAULT_OFFSET,
            tq.DEFAULT_SCALE) == (jq.INT4_OFFSET, jq.INT4_SCALE,
                                  jq.DEFAULT_OFFSET, jq.DEFAULT_SCALE)


def _write(writer_cls, meta_cls, path, n_docs=5, dim=32, seed=0):
    rng = np.random.default_rng(seed)
    w = writer_cls(str(path), dim)
    for i in range(n_docs):
        n = int(rng.integers(3, 12))
        words = [f"w{j}é" for j in range(n + 2)]  # non-ASCII context
        ctx = " ".join(words)
        starts = np.cumsum([0] + [len(t) + 1 for t in words[:-1]]).astype(np.int32)
        w.add_doc(meta_cls(doc_id=100 + i, title=f"doc {i}", context=ctx,
                           word2char_start=starts,
                           word2char_end=(starts + np.array(
                               [len(t) for t in words])).astype(np.int32),
                           f2o_start=np.sort(rng.choice(n + 2, n, False))
                           .astype(np.int32)),
                  rng.integers(-128, 128, (n, dim)).astype(np.int8))
    return w.finalize()


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_store_opens_in_the_other_package(tmp_path, direction):
    if direction == "port_to_jax":
        written = _write(StoreWriter, DocMeta, tmp_path / "s")
        other = JaxPhraseStore.load(str(tmp_path / "s"))
    else:
        written = _write(JaxStoreWriter, JaxDocMeta, tmp_path / "s")
        other = PhraseStore.load(str(tmp_path / "s"))
    for field in ("vecs", "doc_bases", "doc_ids"):
        np.testing.assert_array_equal(getattr(other, field),
                                      getattr(written, field))
    assert (other.offset, other.scale) == (written.offset, written.scale)
    np.testing.assert_array_equal(other.f2o_flat(), written.f2o_flat())
    other.preload_metas()
    for i in range(written.num_docs):
        a, b = written.meta(i), other.meta(i)
        assert (a.doc_id, a.title, a.context) == (b.doc_id, b.title, b.context)
        for f in ("word2char_start", "word2char_end", "f2o_start"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    np.testing.assert_array_equal(other.global_to_doc(np.arange(other.n_vecs))[0],
                                  written.global_to_doc(np.arange(other.n_vecs))[0])


def test_store_files_are_byte_identical(tmp_path):
    _write(StoreWriter, DocMeta, tmp_path / "a", seed=3)
    _write(JaxStoreWriter, JaxDocMeta, tmp_path / "b", seed=3)
    for name in ("vecs.int8", "meta.pkls", "doc_bases.npy", "doc_ids.npy",
                 "store.json", "f2o.int32"):
        assert (tmp_path / "a" / name).read_bytes() == \
            (tmp_path / "b" / name).read_bytes(), name


def _corpus(n, d=64, b=6, seed=0):
    rng = np.random.default_rng(seed)
    codes = rng.integers(-128, 128, (n, d)).astype(np.int8)
    queries = rng.standard_normal((b, d)).astype(np.float32)
    return codes, queries


# scores are O(10) sums of 64 products; fp32 summation order differs
SCORE_ATOL = 1e-4


@pytest.mark.parametrize("n,chunk,k", [(3000, 512, 10), (1000, 512, 37),
                                       (700, 8, 5)])
def test_scan_topk_ids_identical(n, chunk, k):
    codes, queries = _corpus(n)
    rows = -(-n // chunk) * chunk
    padded = np.zeros((rows, codes.shape[1]), np.int8)
    padded[:n] = codes
    rv, ri = jax_scan_topk(jnp.asarray(queries), jnp.asarray(padded),
                           jnp.int32(n), -2.0, 20.0, top_k=k, chunk=chunk)
    tv, ti = _scan_topk(torch.from_numpy(queries), torch.from_numpy(padded),
                        n, -2.0, 20.0, top_k=k, chunk=chunk)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    np.testing.assert_allclose(tv.numpy(), np.asarray(rv), atol=SCORE_ATOL)


@pytest.mark.parametrize("n,k", [(5000, 20), (40, 64)])
def test_flat_index_matches_reference(n, k):
    # k > n pads with NEG_INF scores, as the reference does
    codes, queries = _corpus(n, seed=1)
    rv, ri = JaxFlatIndex(codes).search(queries, top_k=k)
    tv, ti = FlatIndex(codes, device="cpu").search(queries, top_k=k)
    np.testing.assert_array_equal(ti, ri)
    np.testing.assert_allclose(tv, rv, atol=SCORE_ATOL)


def test_flat_index_matches_exact_dequantized_scores():
    codes, queries = _corpus(2000, seed=2)
    vals, ids = FlatIndex(codes, chunk=512, device="cpu").search(queries, top_k=8)
    # the scan rounds queries to bf16 for the product and takes Σq in fp32
    qbf = torch.from_numpy(queries).to(torch.bfloat16).float().numpy()
    exact = (qbf.astype(np.float64) @ codes.T.astype(np.float64)) / 20.0 \
        + (-2.0) * queries.sum(-1, keepdims=True).astype(np.float64)
    np.testing.assert_array_equal(ids, np.argsort(-exact, axis=1)[:, :8])
    np.testing.assert_allclose(vals, np.take_along_axis(exact, ids, 1),
                               atol=SCORE_ATOL)


def test_flat_index_rejects_non_int8():
    with pytest.raises(ValueError, match="int8"):
        FlatIndex(np.zeros((4, 8), np.float32), device="cpu")
