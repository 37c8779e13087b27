"""Flat position-addressable phrase store — the HDF5-dump replacement.

Host copy of ``densephrases_tpu/index/store.py``: the port never imports the JAX
package, whose ``__init__`` imports jax. Keep the two in step. The on-disk
format is the same byte for byte, so either package opens the other's
stores.

The reference stores phrase vectors as per-doc ragged HDF5 groups with
datasets {start, start2end, word2char_start, word2char_end, f2o_start} and
attrs {context, title, offset, scale} (ref: densephrases/utils/embed_utils.py:
235-246), then at serve time re-reads vectors per hit with a Python loop over
``faiss.reconstruct()`` (ref: densephrases/index.py:275-302) — its biggest
serve-time bottleneck.

TPU-native design: ONE flat int8 array over the whole corpus, with the
structural invariant that a document's (filtered) vectors occupy a contiguous
range. Consequences:

- ``global vec id = doc_base + local position`` — no 1e8/1e9 offset encoding
  (ref: index.py:124-141); id→(doc, word) is a binary search over doc bases
  plus one subtraction, and (doc, word)→vector is direct addressing.
- the two-stage span rescore needs vectors at positions [i, i+L): that is a
  *windowed gather on consecutive rows* of the flat array — one vectorized
  device gather replaces the reference's per-hit Python reconstruct loop.
- the flat array shards trivially across TPU HBM along rows via pjit.

On disk a store is a directory:
  vecs.int8            raw int8 [N, D] (memmap-able), APPEND-ONLY during dump
  meta.pkls            append-only stream of per-doc records
                       (doc_id, n_vecs, compressed metadata) — the source of
                       truth for resume; replaces per-group HDF5 appends
                       (ref: embed_utils.py:227-249)
  doc_bases.npy        int64 [num_docs + 1] prefix offsets into vecs (snapshot)
  doc_ids.npy          int64 [num_docs] external document ids (snapshot)
  store.json           {n_vecs, dim, offset, scale, quant} — written LAST by
                       finalize(); acts as the commit marker

Crash safety: vectors and metadata stream to disk per doc; a crash anywhere
(including mid-finalize) leaves the stream files consistent up to the last
complete doc record, and re-opening the directory truncates any partial
vector tail and resumes appending — O(metadata) work, never O(corpus).
"""

from __future__ import annotations

import json
import os
import pickle
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from densephrases_tpu_torch import native
from densephrases_tpu_torch.ops.quant import DEFAULT_OFFSET, DEFAULT_SCALE


@dataclass
class DocMeta:
    """Host-side metadata for one document (ref dump schema:
    embed_utils.py:235-246)."""

    doc_id: int
    title: str
    context: str
    word2char_start: np.ndarray  # int32 [num_words]
    word2char_end: np.ndarray  # int32 [num_words]
    f2o_start: np.ndarray  # int32 [n_vecs] filtered→original word position

    def compress(self) -> dict:
        raw = {
            "context": self.context.encode("utf-8"),
            "word2char_start": self.word2char_start.astype(np.int32).tobytes(),
            "word2char_end": self.word2char_end.astype(np.int32).tobytes(),
            "f2o_start": self.f2o_start.astype(np.int32).tobytes(),
        }
        out = {"doc_id": self.doc_id, "title": self.title,
               "sizes": {k: len(v) for k, v in raw.items()}}
        out.update({k: zlib.compress(v) for k, v in raw.items()})
        return out

    @staticmethod
    def decompress(d: dict) -> "DocMeta":
        return DocMeta(
            doc_id=d["doc_id"],
            title=d["title"],
            context=zlib.decompress(d["context"]).decode("utf-8"),
            word2char_start=np.frombuffer(zlib.decompress(d["word2char_start"]), np.int32),
            word2char_end=np.frombuffer(zlib.decompress(d["word2char_end"]), np.int32),
            f2o_start=np.frombuffer(zlib.decompress(d["f2o_start"]), np.int32),
        )


def _read_meta_stream(path: str):
    """Read the append-only per-doc record stream. Tolerates a truncated
    final record (crash mid-append): reading stops at the last complete one.

    Returns (doc_ids, doc_bases, metas, good_end_offset)."""
    doc_ids: List[int] = []
    doc_bases: List[int] = [0]
    metas: List[dict] = []
    good_end = 0
    if not os.path.exists(path):
        return doc_ids, doc_bases, metas, good_end
    with open(path, "rb") as f:
        while True:
            try:
                doc_id, n_vecs, meta = pickle.load(f)
            except Exception:  # noqa: BLE001 — EOF or partial tail record
                break
            doc_ids.append(int(doc_id))
            doc_bases.append(doc_bases[-1] + int(n_vecs))
            metas.append(meta)
            good_end = f.tell()
    return doc_ids, doc_bases, metas, good_end


class StoreWriter:
    """Streaming, resumable store writer.

    Vectors append straight to ``vecs.int8`` and per-doc metadata to the
    ``meta.pkls`` record stream as each doc arrives — host RSS stays
    O(compressed metadata), never O(vectors). Re-opening an existing store
    dir resumes by reading the metadata stream and truncating any partial
    vector tail; already-present docs are skipped
    (ref: generate_phrase_vecs.py:64-71, embed_utils.py:227-249)."""

    def __init__(self, path: str, dim: int, offset: float = DEFAULT_OFFSET,
                 scale: float = DEFAULT_SCALE, quant: str = "int8"):
        self.path = path
        self.dim = dim
        self.offset = offset
        self.scale = scale
        self.quant = quant
        os.makedirs(path, exist_ok=True)
        self._vec_path = os.path.join(path, "vecs.int8")
        self._stream_path = os.path.join(path, "meta.pkls")

        legacy_pkl = os.path.join(path, "meta.pkl")
        if os.path.exists(legacy_pkl) and not os.path.exists(self._stream_path):
            self._convert_legacy(legacy_pkl)

        self._doc_ids, self._doc_bases, self._metas, stream_end = (
            _read_meta_stream(self._stream_path))
        if os.path.exists(self._stream_path) \
                and os.path.getsize(self._stream_path) > stream_end:
            os.truncate(self._stream_path, stream_end)  # drop partial record
        self._n = self._doc_bases[-1]
        # Truncate a partially-written vector tail back to the last complete
        # doc boundary, then append from there.
        want_bytes = self._n * self.dim
        if os.path.exists(self._vec_path):
            have = os.path.getsize(self._vec_path)
            assert have >= want_bytes, (
                f"vecs.int8 shorter ({have}) than metadata claims "
                f"({want_bytes}) — store corrupted")
            if have > want_bytes:
                with open(self._vec_path, "r+b") as f:
                    f.truncate(want_bytes)
        self._vec_f = open(self._vec_path, "ab")
        self._stream_f = open(self._stream_path, "ab")
        self._existing = set(self._doc_ids)

    def _convert_legacy(self, legacy_pkl: str):
        """One-time upgrade of a round-1 store dir (monolithic meta.pkl) to
        the append-only stream — reuses vecs.int8 as-is, no vector rewrite."""
        with open(legacy_pkl, "rb") as f:
            metas = pickle.load(f)
        doc_bases = np.load(os.path.join(self.path, "doc_bases.npy"))
        doc_ids = np.load(os.path.join(self.path, "doc_ids.npy"))
        tmp = self._stream_path + ".tmp"
        with open(tmp, "wb") as f:
            for i, m in enumerate(metas):
                n_vecs = int(doc_bases[i + 1] - doc_bases[i])
                pickle.dump((int(doc_ids[i]), n_vecs, m), f,
                            protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, self._stream_path)
        os.remove(legacy_pkl)

    def has_doc(self, doc_id: int) -> bool:
        return doc_id in self._existing

    @property
    def n_vecs(self) -> int:
        return self._n

    def add_doc_raw(self, doc_id: int, codes: np.ndarray, meta_compressed: dict):
        assert codes.dtype == np.int8 and codes.shape[1] == self.dim
        codes = np.ascontiguousarray(codes)
        # vectors first, record second: a crash between the two leaves a
        # vector tail that resume truncates
        self._vec_f.write(codes.tobytes())
        pickle.dump((int(doc_id), int(codes.shape[0]), meta_compressed),
                    self._stream_f, protocol=pickle.HIGHEST_PROTOCOL)
        self._n += codes.shape[0]
        self._doc_bases.append(self._n)
        self._doc_ids.append(int(doc_id))
        self._metas.append(meta_compressed)
        self._existing.add(int(doc_id))

    def add_doc(self, meta: DocMeta, codes: np.ndarray):
        """codes: int8 [n_vecs, dim] already quantized start vectors."""
        assert codes.shape[0] == len(meta.f2o_start), (
            f"vec count {codes.shape[0]} != f2o_start {len(meta.f2o_start)}"
        )
        self.add_doc_raw(meta.doc_id, codes, meta.compress())

    def flush(self):
        if not self._vec_f.closed:
            self._vec_f.flush()
        if not self._stream_f.closed:
            self._stream_f.flush()

    def finalize(self, mmap: bool = False,
                 build_sidecars: bool = True) -> "PhraseStore":
        """Snapshot the doc index + commit marker. Cheap (O(num_docs)) and
        idempotent — the vector file is already on disk.

        build_sidecars: also persist the serve-time f2o sidecar NOW, so
        the first serve's cold start is the warm path (ref serve startup
        role: index.py:69-76 meta_compressed.pkl preload)."""
        self.flush()
        if not self._vec_f.closed:
            self._vec_f.close()
        if not self._stream_f.closed:
            self._stream_f.close()
        np.save(os.path.join(self.path, "doc_bases.npy"),
                np.asarray(self._doc_bases, np.int64))
        np.save(os.path.join(self.path, "doc_ids.npy"),
                np.asarray(self._doc_ids, np.int64))
        with open(os.path.join(self.path, "store.json"), "w") as f:
            json.dump({"n_vecs": int(self._n), "dim": self.dim,
                       "offset": self.offset, "scale": self.scale,
                       "quant": self.quant}, f)
        st = PhraseStore.load(self.path, mmap=mmap)
        if build_sidecars:
            st.f2o_flat()  # writes + stamps the f2o.int32 sidecar
        return st


@dataclass
class PhraseStore:
    """In-RAM (or memmapped) view of a store directory."""

    vecs: np.ndarray  # int8 [N, D]
    doc_bases: np.ndarray  # int64 [num_docs + 1]
    doc_ids: np.ndarray  # int64 [num_docs]
    metas: list  # compressed per-doc dicts
    offset: float = DEFAULT_OFFSET
    scale: float = DEFAULT_SCALE
    _meta_cache: dict = field(default_factory=dict)
    path: Optional[str] = None
    _f2o_flat: Optional[np.ndarray] = None

    @staticmethod
    def load(path: str, mmap: bool = False) -> "PhraseStore":
        with open(os.path.join(path, "store.json")) as f:
            info = json.load(f)
        n, d = info["n_vecs"], info["dim"]
        mode = "r" if mmap else None
        vecs = np.memmap(os.path.join(path, "vecs.int8"), np.int8, "r",
                         shape=(n, d))
        if not mmap:
            vecs = np.asarray(vecs)
        doc_bases = np.load(os.path.join(path, "doc_bases.npy"))
        doc_ids = np.load(os.path.join(path, "doc_ids.npy"))
        legacy = os.path.join(path, "meta.pkl")
        if os.path.exists(legacy):  # round-1 monolithic pickle
            with open(legacy, "rb") as f:
                metas = pickle.load(f)
        else:
            _, _, metas, _ = _read_meta_stream(os.path.join(path, "meta.pkls"))
            metas = metas[:len(doc_ids)]
        return PhraseStore(vecs=vecs, doc_bases=doc_bases, doc_ids=doc_ids,
                           metas=metas, offset=info["offset"],
                           scale=info["scale"], path=path)

    @staticmethod
    def merge(shard_paths: List[str], out_path: str) -> "PhraseStore":
        """Merge shard stores into one (ref merge stage:
        build_phrase_index.py:282-338 — here it is concatenation because
        ids are (doc_base + position), not global hash ids). Every dump
        numbers its docs from 0, so a shard's doc ids (in the store and its
        metadata) are offset by the docs of the shards before it; the
        reference keeps each shard's ids, which repeat (ROADMAP Queue 3)."""
        first = PhraseStore.load(shard_paths[0], mmap=True)
        writer = StoreWriter(out_path, first.dim, first.offset, first.scale)
        base = 0
        for sp in shard_paths:
            shard = PhraseStore.load(sp, mmap=True)
            for i in range(shard.num_docs):
                doc_id = base + int(shard.doc_ids[i])
                writer.add_doc_raw(doc_id, shard.vec_rows(i),
                                   {**shard.meta_compressed(i),
                                    "doc_id": doc_id})
            base += shard.num_docs
        return writer.finalize()

    @property
    def n_vecs(self) -> int:
        return self.vecs.shape[0]

    @property
    def dim(self) -> int:
        return self.vecs.shape[1]

    @property
    def num_docs(self) -> int:
        return len(self.doc_ids)

    def vec_rows(self, doc_pos: int) -> np.ndarray:
        return np.asarray(self.vecs[self.doc_bases[doc_pos]:self.doc_bases[doc_pos + 1]])

    def meta_compressed(self, doc_pos: int) -> dict:
        return self.metas[doc_pos]

    def meta(self, doc_pos: int) -> DocMeta:
        """Decompress-with-cache per-doc metadata (ref: index.py:106-122)."""
        if doc_pos not in self._meta_cache:
            self._meta_cache[doc_pos] = DocMeta.decompress(self.metas[doc_pos])
        return self._meta_cache[doc_pos]

    def preload_metas(self, background: bool = False):
        """Decompress ALL doc metadata into the cache using the native
        parallel zlib codec — the serve-time 'metadata on RAM' mode
        (ref: index.py:69-76 meta_compressed.pkl preloading).

        background=True returns immediately and fills the cache from a
        daemon thread: serving starts cold-path-fast and per-doc meta()
        decompresses on demand until the sweep catches up (duplicate
        decompression of a doc is pure and harmless)."""
        if background:
            import threading

            t = threading.Thread(target=self.preload_metas, daemon=True)
            t.start()
            self._preload_thread = t
            return self
        todo = [i for i in range(self.num_docs) if i not in self._meta_cache]
        if not todo:
            return self
        keys = ("context", "word2char_start", "word2char_end", "f2o_start")
        bufs, sizes = [], []
        for i in todo:
            m = self.metas[i]
            known = m.get("sizes")
            for k in keys:
                bufs.append(m[k])
                sizes.append(known[k] if known else -1)
        if all(s >= 0 for s in sizes):
            outs = native.decompress_batch(bufs, sizes)
        else:  # legacy store without size metadata
            outs = [zlib.decompress(b) for b in bufs]
        for j, i in enumerate(todo):
            c, ws, we, fo = outs[4 * j: 4 * j + 4]
            self._meta_cache[i] = DocMeta(
                doc_id=self.metas[i]["doc_id"], title=self.metas[i]["title"],
                context=c.decode("utf-8"),
                word2char_start=np.frombuffer(ws, np.int32),
                word2char_end=np.frombuffer(we, np.int32),
                f2o_start=np.frombuffer(fo, np.int32),
            )
        return self

    def f2o_flat(self) -> np.ndarray:
        """Flat [N] filtered→original word map for the whole corpus.

        The serve engine needs f2o for EVERY row up front (span-validity
        masking in the rescore kernel); decompressing every doc's metadata
        one-by-one in Python is O(corpus) serve startup (the reference pays
        the same to load meta_compressed.pkl, ref: index.py:69-76). Here:
        one threaded batch decompress of only the f2o buffers, one
        concatenation — and the result is cached as an ``f2o.int32``
        sidecar next to the store so later serves just memmap-read it
        (O(seconds) at 10M+ rows)."""
        if self._f2o_flat is not None:
            return self._f2o_flat
        sidecar = (os.path.join(self.path, "f2o.int32")
                   if self.path is not None else None)
        stamp = self._f2o_stamp()
        if sidecar and os.path.exists(sidecar):
            # validate against a content stamp, not just the length: a store
            # re-dumped in place with the same total vector count would
            # otherwise serve a stale filtered→original map (silently wrong
            # span masking)
            meta_path = sidecar + ".meta"
            ok = False
            if os.path.exists(meta_path):
                try:
                    ok = json.load(open(meta_path)) == stamp
                except Exception:
                    ok = False
            if ok:
                arr = np.fromfile(sidecar, np.int32)
                if arr.shape[0] == self.n_vecs:
                    self._f2o_flat = arr
                    return arr
            # stale/unstamped sidecars fall through to a rebuild
        if (self.num_docs > 0
                and len(self._meta_cache) >= self.num_docs):
            # preload_metas already inflated every doc: concatenate from the
            # cache instead of a second zlib pass over the same buffers
            arr = np.concatenate(
                [np.asarray(self._meta_cache[i].f2o_start, np.int32)
                 for i in range(self.num_docs)])
        else:
            bufs = [m["f2o_start"] for m in self.metas]
            sizes = [m.get("sizes", {}).get("f2o_start", -1)
                     for m in self.metas]
            if bufs and all(s >= 0 for s in sizes):
                outs = native.decompress_batch(bufs, sizes)
            else:
                outs = [zlib.decompress(b) for b in bufs]
            arr = (np.frombuffer(b"".join(outs), np.int32) if outs
                   else np.zeros(0, np.int32))
        assert arr.shape[0] == self.n_vecs, (
            f"f2o length {arr.shape[0]} != n_vecs {self.n_vecs}")
        if sidecar:
            try:
                tmp = sidecar + ".tmp"
                arr.tofile(tmp)
                os.replace(tmp, sidecar)
                with open(sidecar + ".meta.tmp", "w") as f:
                    json.dump(stamp, f)
                os.replace(sidecar + ".meta.tmp", sidecar + ".meta")
            except OSError:  # read-only store dir: cache in RAM only
                pass
        self._f2o_flat = arr
        return arr

    def _f2o_stamp(self) -> dict:
        """Content stamp for the f2o sidecar: n_vecs + the compressed
        metadata file's size and a cheap head/tail crc — catches in-place
        re-dumps that happen to preserve the total vector count."""
        stamp = {"n_vecs": int(self.n_vecs)}
        if self.path is not None:
            mp = os.path.join(self.path, "meta.pkls")
            if os.path.exists(mp):
                stamp["meta_size"] = os.path.getsize(mp)
                with open(mp, "rb") as f:
                    head = f.read(65536)
                    try:
                        f.seek(-65536, os.SEEK_END)
                    except OSError:
                        f.seek(0)
                    tail = f.read(65536)
                stamp["meta_crc"] = int(
                    zlib.crc32(tail, zlib.crc32(head)))
        return stamp

    def global_to_doc(self, gids: np.ndarray):
        """Map global vec ids → (doc position, local vec position).

        Replaces the reference's idx2id HDF5 lookup + 1e8/1e9 offset decode
        (ref: index.py:124-141) with a vectorized binary search."""
        gids = np.asarray(gids)
        doc_pos = np.searchsorted(self.doc_bases, gids, side="right") - 1
        doc_pos = np.clip(doc_pos, 0, self.num_docs - 1)
        local = gids - self.doc_bases[doc_pos]
        return doc_pos, local

    def doc_base(self, doc_pos) -> np.ndarray:
        return self.doc_bases[doc_pos]
