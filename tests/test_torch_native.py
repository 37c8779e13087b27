"""The port's copy of the native store runtime against the JAX package's:
the cases of ``tests/test_native.py`` on the port's bindings, each held
against the reference's output on the same inputs; the zlib batch codec
across the two libraries both ways; and ``preload_metas`` / ``f2o_flat`` of
one store through both packages."""

import zlib

import numpy as np
import pytest

from densephrases_tpu import native as jax_native
from densephrases_tpu.index.store import PhraseStore as JaxPhraseStore
from densephrases_tpu_torch import native
from densephrases_tpu_torch.index.store import DocMeta, PhraseStore, StoreWriter


def test_native_builds_into_the_build_dir():
    assert native.available(), "g++ build of the port's libdpstore failed"
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.parent.name == "_build"


@pytest.mark.parametrize("shape,rows,idx_shape", [
    ((5000, 96), 5000, (37, 11)), ((300, 768), 300, (64,)),
    ((10, 8), 10, (4, 3))])
def test_gather_rows_matches_reference(shape, rows, idx_shape):
    rng = np.random.default_rng(shape[0])
    m = rng.integers(-128, 127, shape).astype(np.int8)
    idx = rng.integers(0, rows, idx_shape)
    out = native.gather_rows(m, idx)
    np.testing.assert_array_equal(out, m[idx])
    np.testing.assert_array_equal(out, jax_native.gather_rows(m, idx))


def test_gather_rows_out_of_range_zeros():
    m = np.ones((10, 8), np.int8)
    idx = np.asarray([0, 11, -1, 9])
    out = native.gather_rows(m, idx)
    np.testing.assert_array_equal(out[0], np.ones(8))
    np.testing.assert_array_equal(out[1], np.zeros(8))
    np.testing.assert_array_equal(out[2], np.zeros(8))
    np.testing.assert_array_equal(out, jax_native.gather_rows(m, idx))


def _buffers(seed, n=64):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 5, size=rng.integers(10, 5000)).astype(
        np.uint8).tobytes() for _ in range(n)]


@pytest.mark.parametrize("level", [1, 6, 9])
def test_zlib_batch_round_trip_matches_reference(level):
    bufs = _buffers(level)
    comp = native.compress_batch(bufs, level)
    assert all(len(c) < len(b) + 64 for c, b in zip(comp, bufs))
    # the same zlib at the same level: the same bytes as the reference's
    assert comp == jax_native.compress_batch(bufs, level)
    assert native.decompress_batch(comp, [len(b) for b in bufs]) == bufs


@pytest.mark.parametrize("writer,reader", [
    ("port", "jax"), ("jax", "port"), ("zlib", "port"), ("port", "zlib")])
def test_zlib_batch_interop(writer, reader):
    bufs = [b"hello world " * 100, b"abc" * 7] + _buffers(7, 8)
    comp = {"port": native.compress_batch, "jax": jax_native.compress_batch,
            "zlib": lambda bs: [zlib.compress(b) for b in bs]}[writer](bufs)
    sizes = [len(b) for b in bufs]
    back = {"port": lambda cs: native.decompress_batch(cs, sizes),
            "jax": lambda cs: jax_native.decompress_batch(cs, sizes),
            "zlib": lambda cs: [zlib.decompress(c) for c in cs]}[reader](comp)
    assert back == bufs


def test_file_io_round_trip(tmp_path):
    rng = np.random.default_rng(2)
    data = rng.integers(-128, 127, (1000, 64)).astype(np.int8)
    p = str(tmp_path / "vecs.bin")
    n = native.write_bytes(p, data)
    assert n == data.size
    back = native.read_bytes(p, data.size).view(np.int8).reshape(data.shape)
    np.testing.assert_array_equal(back, data)
    # the reference reads the port's file and the port the reference's
    np.testing.assert_array_equal(jax_native.read_bytes(p, data.size), back
                                  .view(np.uint8).reshape(-1))
    q = str(tmp_path / "ref.bin")
    jax_native.write_bytes(q, data)
    np.testing.assert_array_equal(native.read_bytes(q, data.size),
                                  data.view(np.uint8).reshape(-1))


@pytest.fixture(scope="module")
def store_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("native") / "s")
    writer = StoreWriter(path, 16)
    rng = np.random.default_rng(3)
    for d in range(20):
        n = int(rng.integers(1, 9))
        writer.add_doc(DocMeta(
            doc_id=d, title=f"t{d}", context=f"doc {d} content é " * 30,
            word2char_start=np.arange(n, dtype=np.int32) * 3,
            word2char_end=np.arange(n, dtype=np.int32) * 3 + 2,
            f2o_start=np.arange(n, dtype=np.int32)),
            rng.integers(-128, 127, (n, 16)).astype(np.int8))
    writer.finalize()
    return path


def _metas(store):
    return [(m.doc_id, m.title, m.context, m.word2char_start.tobytes(),
             m.word2char_end.tobytes(), m.f2o_start.tobytes())
            for m in (store._meta_cache[i] for i in range(store.num_docs))]


def test_store_preload_metas_matches_reference(store_dir):
    store = PhraseStore.load(store_dir).preload_metas()
    assert len(store._meta_cache) == 20
    m = store.meta(7)
    assert m.context.startswith("doc 7 content")
    ref = JaxPhraseStore.load(store_dir).preload_metas()
    assert _metas(store) == _metas(ref)
    # the native batch equals per-doc decompression
    one = PhraseStore.load(store_dir)
    for i in range(one.num_docs):
        one.meta(i)
    assert _metas(store) == _metas(one)


def test_f2o_flat_matches_reference(store_dir, tmp_path):
    import shutil

    # fresh copies: f2o_flat writes a sidecar next to the store
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    shutil.copytree(store_dir, a)
    shutil.copytree(store_dir, b)
    np.testing.assert_array_equal(PhraseStore.load(a).f2o_flat(),
                                  JaxPhraseStore.load(b).f2o_flat())


def test_legacy_store_without_sizes_uses_zlib(store_dir, monkeypatch):
    store = PhraseStore.load(store_dir)
    for m in store.metas:
        m.pop("sizes", None)

    def refuse(*a):
        raise AssertionError("a store without sizes went through native")

    monkeypatch.setattr(native, "decompress_batch", refuse)
    store.preload_metas()
    ref = JaxPhraseStore.load(store_dir).preload_metas()
    assert _metas(store) == _metas(ref)


def test_failed_build_falls_back_with_a_warning(monkeypatch, caplog):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", False)
    monkeypatch.setattr(native, "library_path",
                        lambda: native.BUILD_DIR / "no_such_dir" / "x.so")
    monkeypatch.setattr(native, "GXX_FLAGS", ("-this-flag-does-not-exist",))
    with caplog.at_level("WARNING", logger=native.__name__):
        assert not native.available()
    assert "native build failed" in caplog.text
    bufs = [b"abc" * 50]
    assert native.decompress_batch(native.compress_batch(bufs), [150]) == bufs


def test_threads_share_one_build(monkeypatch, tmp_path):
    # MIPS's background metadata preload and its f2o load reach the native
    # runtime from two threads of one process at once: one builds, the
    # other waits for it (a second g++ into the same temp name lost the
    # race with the first's rename)
    import threading

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", False)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    builds, errors = [], []
    real_build = native._build

    def counted(out):
        builds.append(out)
        return real_build(out)

    monkeypatch.setattr(native, "_build", counted)

    def use():
        try:
            assert native.available()
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=use) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(builds) == 1
    assert native.library_path().exists()
