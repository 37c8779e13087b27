"""MIPS: the online phrase search engine over a flat or IVF index.

The counterpart of ``densephrases_tpu/index/search.py`` over a device-
resident index:

stage 1 — ``search_dense``: stack [query_start; query_end] rows and run one
  batched MIPS over the ``FlatIndex`` or ``IVFIndex`` (``nprobe`` lists
  probed; a flat index ignores it).
stage 2 — ``search_phrase``: for every start hit, score candidate ends within
  ``max_answer_length`` (and symmetrically starts for end hits) on the
  device: a windowed gather of consecutive rows, the int8 dequant, one
  einsum against the query vectors, validity masks from the flat f2o map
  and the doc bounds, and an argmax (``_rescore_spans``). Its results,
  packed into one buffer (``_pack``), come to the host in ONE device→host
  copy: ``_send`` starts it into pinned memory without blocking,
  ``_receive`` waits for it and assembles. ``FusedServer`` calls the two
  halves apart, to keep batches in flight.
stage 3 — ``_assemble`` (host): char offsets and result dicts; then
  ``aggregate_results`` (opt1–opt4, ``_aggregate``) and the context-window
  adjustments.

The rescore reads the int8 corpus in its original row order: an int8 flat
index shares its padded code buffer, a PQ / OPQ IVF index with an int8
refine shares its refine matrix (the store's own codes), and an SQ8 / SQ4
IVF index (whose codes are sorted by list) or an int4 flat index gets the
store's vectors uploaded. A PQ / OPQ index without a device refine (loaded
with ``refine_mode`` "none" or "host") is served in decode mode
(``pq_serve``): no corpus-sized int8 tensor exists on the device, and the
rescore decodes each candidate window from the index's codes,
``c_rot[list] + books[m, code_m]``, in the rotated code space.

``rotation`` (``MIPS.R``) rotates every query before both stages; vectors
handed back with ``return_idxs`` are rotated back, so ``q · v`` is the
serve score. ``vecs_on_device`` keeps those vectors on the device.

A tiered index (``index/tiered.py``, recognised by its
``gather_rows_host``) serves a corpus larger than the device: no corpus-
sized tensor is made, stage 1's hits come to the host, and stage 2 runs in
numpy (``_rescore_spans_host``) over candidate windows gathered from the
host memmap.

``mesh`` (a ``parallel.Mesh``) shards the flat index over the ranks
(``FlatIndex(mesh=...)``): every rank runs the same search on the same
queries, and the stage-1 merge is an all-gather. A mesh index is no 2-D
buffer to share, so each rank uploads the store's codes for the rescore
(ref search.py:298-300).
"""

from __future__ import annotations

import re
import time
from typing import List, Optional

import numpy as np
import torch

from densephrases_tpu_torch.eval.metrics import normalize_answer
from densephrases_tpu_torch.index.flat import FlatIndex
from densephrases_tpu_torch.index.ivf import IVFIndex, _upload
from densephrases_tpu_torch.index.store import PhraseStore
from densephrases_tpu_torch.ops.pq import unpack_nibbles_dev
from densephrases_tpu_torch.utils.device import resolve_device
from densephrases_tpu_torch.utils import profiling

NEG_INF = -1e9
SCORE_FLOOR = -1e5  # host-side filter for masked/dummy results (ref: index.py:420)
# the four candidate-vector outputs of _rescore_spans(return_vecs=True)
VEC_KEYS = ("end_vec_for_start", "start_vec_anchor", "start_vec_for_end",
            "end_vec_anchor")


def _rescore_spans(query_start, query_end, s_gids, e_gids, s_scores, e_scores,
                   vecs, f2o, doc_end_row, doc_base_row, offset: float,
                   scale: float, pq=None, *, max_answer_length: int,
                   return_vecs: bool = False):
    """Constrained span rescoring for both anchor directions, on the device.

    query_start/query_end: [B, D] fp32. s_gids/e_gids: [B, K] row ids of the
    start/end hits; s_scores/e_scores: [B, K] their MIPS scores. vecs: the
    padded [R, D] int8 corpus; f2o, doc_end_row, doc_base_row: [N].
    Returns per-direction best partner offsets and joint scores (and the
    partner vectors when return_vecs).

    pq: None, or decode mode's (codes, books, inv_perm, row_list, c_rot)
    (ref search.py:73-99): vecs is None, the queries are in the rotated
    code space, and a row decodes as ``c_rot[row_list[s]] + Σ_m
    books[m, code_m]`` with s = inv_perm[row] its sorted row. The
    reference takes the book rows by a one-hot product; here they are
    gathered, the same fp32 values. The centroid term is added whatever
    the index's ``pq_residual`` says, as the reference does (a fault of
    the reference for indexes pickled without residual codes; ROADMAP
    Queue 3)."""
    n = f2o.shape[0]
    L = max_answer_length
    dev = s_gids.device

    if pq is not None:
        codes, books, inv_perm, row_list, c_rot = pq
        m = books.shape[0]
        sub = torch.arange(m, device=dev)

        def fetch(rows):
            s = inv_perm[rows].long()
            code = (unpack_nibbles_dev(codes[s], m) if books.shape[1] == 16
                    else codes[s][..., :m]).long()
            res = books[sub, code]  # [..., M, dsub]
            return (c_rot[row_list[s].long()]
                    + res.reshape(code.shape[:-1] + (-1,)))
    else:
        def fetch(rows):
            return vecs[rows].to(torch.float32) / scale + offset

    def gather_window(gids, offsets):
        win = gids.long()[..., None] + offsets  # [B, K, L]
        wc = win.clamp(0, n - 1)
        return win, wc, fetch(wc)  # [B, K, L, D]

    s_anchor = s_gids.long().clamp(0, n - 1)
    e_anchor = e_gids.long().clamp(0, n - 1)
    up = torch.arange(L, device=dev)
    down = torch.arange(-(L - 1), 1, device=dev)

    # --- ends for start hits (ref: index.py:323-346)
    win_e, wc_e, evecs = gather_window(s_gids, up)
    dist_e = f2o[wc_e] - f2o[s_anchor][..., None]
    valid_e = ((win_e < doc_end_row[s_anchor][..., None]) & (win_e >= 0)
               & (dist_e >= 0) & (dist_e <= L))
    e_part = torch.einsum("bkld,bd->bkl", evecs, query_end)
    joint_e = s_scores[..., None] + e_part + NEG_INF * (~valid_e)
    best_e_score, best_e = joint_e.max(-1)

    # --- starts for end hits (ref: index.py:348-371)
    win_s, wc_s, svecs = gather_window(e_gids, down)
    dist_s = f2o[e_anchor][..., None] - f2o[wc_s]
    valid_s = ((win_s >= doc_base_row[e_anchor][..., None]) & (win_s >= 0)
               & (dist_s >= 0) & (dist_s <= L))
    s_part = torch.einsum("bkld,bd->bkl", svecs, query_start)
    joint_s = e_scores[..., None] + s_part + NEG_INF * (~valid_s)
    best_s_score, best_s = joint_s.max(-1)

    out = {
        "end_offset": best_e, "joint_from_start": best_e_score,
        "start_offset": best_s - (L - 1), "joint_from_end": best_s_score,
    }
    if return_vecs:
        def pick(vecs4, best):
            idx = best[..., None, None].expand(-1, -1, 1, vecs4.shape[-1])
            return torch.gather(vecs4, 2, idx)[:, :, 0]

        out.update({
            "end_vec_for_start": pick(evecs, best_e),
            "start_vec_anchor": fetch(s_anchor),
            "start_vec_for_end": pick(svecs, best_s),
            "end_vec_anchor": fetch(e_anchor),
        })
    return out


def _rescore_spans_host(query_start, query_end, s_gids, e_gids, s_scores,
                        e_scores, gather_rows, f2o, doc_end_row, doc_base_row,
                        offset, scale, *, max_answer_length: int,
                        return_vecs: bool = False, n_total: int):
    """Numpy twin of ``_rescore_spans`` for the host-tiered serve path: the
    candidate windows (B·K·L rows) come through ``gather_rows`` from the
    host memmap and the einsum and argmax run on the host. A copy of the
    reference's (search.py:159-219)."""
    L = max_answer_length
    n = n_total

    def windows(gids, offsets):
        win = gids[..., None] + offsets  # [B, K, L]
        wc = np.clip(win, 0, n - 1)
        v = gather_rows(wc.reshape(-1)).reshape(wc.shape + (-1,))
        v = v.astype(np.float32) / scale + offset
        return win, wc, v

    up = np.arange(L)
    down = np.arange(-(L - 1), 1)
    s_anchor = np.clip(s_gids, 0, n - 1)
    e_anchor = np.clip(e_gids, 0, n - 1)

    win_e, wc_e, evecs = windows(s_gids, up)
    dist_e = f2o[wc_e] - f2o[s_anchor][..., None]
    valid_e = (
        (win_e < doc_end_row[s_anchor][..., None]) & (win_e >= 0)
        & (dist_e >= 0) & (dist_e <= L))
    e_part = np.einsum("bkld,bd->bkl", evecs, query_end)
    joint_e = s_scores[..., None] + e_part + NEG_INF * (~valid_e)
    best_e = np.argmax(joint_e, axis=-1)
    best_e_score = np.max(joint_e, axis=-1)

    win_s, wc_s, svecs = windows(e_gids, down)
    dist_s = f2o[e_anchor][..., None] - f2o[wc_s]
    valid_s = (
        (win_s >= doc_base_row[e_anchor][..., None]) & (win_s >= 0)
        & (dist_s >= 0) & (dist_s <= L))
    s_part = np.einsum("bkld,bd->bkl", svecs, query_start)
    joint_s = e_scores[..., None] + s_part + NEG_INF * (~valid_s)
    best_s = np.argmax(joint_s, axis=-1)
    best_s_score = np.max(joint_s, axis=-1)

    out = {
        "end_offset": best_e, "joint_from_start": best_e_score,
        "start_offset": best_s - (L - 1), "joint_from_end": best_s_score,
    }
    if return_vecs:
        bidx = np.arange(s_gids.shape[0])[:, None]
        kidx = np.arange(s_gids.shape[1])[None, :]
        out.update({
            "end_vec_for_start": evecs[bidx, kidx, best_e],
            "start_vec_anchor":
                gather_rows(s_anchor.reshape(-1)).reshape(
                    s_anchor.shape + (-1,)).astype(np.float32) / scale + offset,
            "start_vec_for_end": svecs[bidx, kidx, best_s],
            "end_vec_anchor":
                gather_rows(e_anchor.reshape(-1)).reshape(
                    e_anchor.shape + (-1,)).astype(np.float32) / scale + offset,
        })
    return out


def _pack(tensors: dict):
    """Flatten a dict of device tensors into one int32 buffer (floats bit-
    cast, integers narrowed; every value here fits int32), so the host
    receives them in a single copy. Returns (buffer, layout)."""
    parts, layout = [], []
    for key, t in tensors.items():
        is_float = t.is_floating_point()
        word = (t.to(torch.float32).view(torch.int32) if is_float
                else t.to(torch.int32))
        parts.append(word.reshape(-1))
        layout.append((key, tuple(t.shape), is_float))
    return torch.cat(parts), layout


def _unpack(buf: np.ndarray, layout) -> dict:
    """Inverse of ``_pack`` on the host copy of the buffer."""
    out, at = {}, 0
    for key, shape, is_float in layout:
        size = int(np.prod(shape))
        part = buf[at:at + size].reshape(shape)
        out[key] = part.view(np.float32) if is_float else part
        at += size
    return out


def _sync(device: torch.device):
    """Wait for the device's queued work, so set-up stages time it."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


_SENT_RE = re.compile(r"(?<=[.!?])\s+(?=[A-Z\"'(\[])")


def _sentencize(text: str):
    """Rule-based sentence splitter (replaces the spaCy sentencizer,
    ref: index.py:64-66 — host-side, not perf-critical)."""
    sents = []
    pos = 0
    for m in _SENT_RE.finditer(text):
        sents.append((text[pos:m.start()], pos))
        pos = m.end()
    sents.append((text[pos:], pos))
    return [s for s in sents if s[0].strip()] or [(text, 0)]


class MIPS:
    """Phrase search engine over a flat, an IVF or a tiered index on one
    device, or over a flat index sharded on a mesh (API parity with ref
    MIPS, index.py:23)."""

    def __init__(self, store: PhraseStore, index=None, rotation=None,
                 mesh=None, shard_axis: str = "shard",
                 collect_stats: bool = False, preload_meta: bool = True, *,
                 device=None):
        """The reference's parameters in its order (ref search.py:240-242).
        index: a ``FlatIndex``, ``IVFIndex``, ``TieredFlatIndex`` or
        ``TieredIVF`` (None: a flat int8 index over the store). rotation:
        a [D, D] matrix applied to the queries of both stages. mesh (with
        ``shard_axis``): a ``parallel.Mesh``; with no ``index``, the flat
        index is sharded over its ranks, on ``mesh.device``. collect_stats:
        record the unique docs a query's hits touch (``num_docs_list``).
        preload_meta: decompress the doc metadata in the background.
        device: where to upload the corpus when no
        ``index`` is given (None: "cuda"); with an ``index``, None or its
        device. ``init_stages`` holds the seconds of each set-up stage."""
        self.store = store
        self.collect_stats = collect_stats
        stages = {}
        t = time.perf_counter()
        if index is None:
            index = FlatIndex(store.vecs, store.offset, store.scale,
                              mesh=mesh, shard_axis=shard_axis,
                              device="cuda" if device is None else device)
            stages["index_upload_s"] = round(time.perf_counter() - t, 3)
        # a tiered index rescores on the host from its row gather
        self.tiered = hasattr(index, "gather_rows_host")
        if not (self.tiered or isinstance(index, (FlatIndex, IVFIndex))):
            raise NotImplementedError(
                "the port serves a FlatIndex, an IVFIndex or a tiered index")
        if (device is not None
                and resolve_device(device).type != index.device.type):
            raise ValueError(f"index is on {index.device}, asked for {device}")
        self.index = index
        self.device = index.device
        self.R = (None if rotation is None else torch.as_tensor(
            np.asarray(rotation, np.float32), device=self.device))
        self.pq_serve = None

        if preload_meta:
            # decompress all doc metadata in the background; per-doc meta()
            # decompresses on demand until the sweep catches up
            store.preload_metas(background=True)

        # per-row serve arrays: f2o from the store's sidecar, doc bounds as
        # a repeat over the doc lengths (no per-doc Python loop)
        t = time.perf_counter()
        f2o = store.f2o_flat()
        stages["f2o_s"] = round(time.perf_counter() - t, 3)
        t = time.perf_counter()
        lens = np.diff(store.doc_bases).astype(np.int64)
        # int32 row ids (ref: search.py:279-281)
        rdt = np.int32 if store.n_vecs < 2**31 else np.int64
        doc_end_row = np.repeat(store.doc_bases[1:].astype(rdt), lens)
        doc_base_row = np.repeat(store.doc_bases[:-1].astype(rdt), lens)
        if self.tiered:
            self.vecs_dev = None
            self.f2o_host = f2o
            self.doc_end_host = doc_end_row
            self.doc_base_host = doc_base_row
        else:
            self.vecs_dev = self._rescore_corpus(store, index, stages)
            self.f2o_dev = torch.tensor(f2o, device=self.device)
            self.doc_end_dev = torch.tensor(doc_end_row, device=self.device)
            self.doc_base_dev = torch.tensor(doc_base_row, device=self.device)
            _sync(self.device)
        stages["serve_arrays_s"] = round(time.perf_counter() - t, 3)
        self.init_stages = stages
        self.num_docs_list: List[float] = []

    def _rescore_corpus(self, store: PhraseStore, index, stages: dict):
        """The original-order int8 corpus on the index's device for the
        rescore (which clips row ids, so pad rows are never candidates),
        or None in decode mode, which sets ``pq_serve``."""
        if (isinstance(index, FlatIndex) and index.quant == "int8"
                and index.mesh is None):
            return index.codes  # shared: the padded flat buffer
        if isinstance(index, IVFIndex):
            refine = index.refine_codes
            if (refine is not None and refine.shape[0] >= store.n_vecs
                    and refine.shape[1] == store.dim):
                return refine  # PQ / OPQ with refine: the store's own codes
            if index.pq_books is not None:
                t = time.perf_counter()
                self.pq_serve = self._decode_arrays(store, index)
                # the port keeps one unpadded code copy: nothing to compact
                stages["pq_compacted"] = False
                _sync(self.device)
                stages["pq_setup_s"] = round(time.perf_counter() - t, 3)
                return None
        # SQ8 / SQ4 (codes sorted by list), a mesh flat index (this rank's
        # rows only) or an int4 flat index (whose nibbles are not the int8
        # corpus; the reference's MIPS shares them and fails, ROADMAP
        # Queue 3)
        return _upload(store.vecs, torch.int8, index.device)

    @staticmethod
    def _decode_arrays(store: PhraseStore, index: IVFIndex) -> dict:
        """Decode mode's maps, built on the device (ref search.py:318-348):
        global row → sorted row (a scatter of row_perm), sorted row → list
        (a searchsorted over the list offsets), and the rotated centroids."""
        dev, n_real = index.device, index.n_real
        inv_perm = torch.zeros(store.n_vecs, dtype=torch.int32, device=dev)
        inv_perm[index.row_perm[:n_real].long()] = torch.arange(
            n_real, dtype=torch.int32, device=dev)
        offs = index.list_offsets
        row_list = (torch.searchsorted(
            offs, torch.arange(n_real, dtype=offs.dtype, device=dev),
            right=True) - 1).to(torch.int32)
        rot = index.rotation
        c_rot = index.centroids if rot is None else index.centroids @ rot
        return {"codes": index.codes, "books": index.pq_books,
                "inv_perm": inv_perm, "row_list": row_list,
                "c_rot": c_rot.to(torch.float32), "rot": rot}

    # ---------------- stage 1 ----------------
    def search_dense(self, query, top_k: int = 10, nprobe: int = 256, *,
                     chunk: Optional[int] = None):
        """query: [B, 2D] — returns start/end hit ids + scores as DEVICE
        tensors (ref: index.py:189-218). nprobe: IVF lists probed (capped
        at nlist by the index; a flat index ignores it). chunk: a flat
        index's scan chunk (None: the index's own)."""
        with profiling.span("index.search_dense"):
            query = torch.as_tensor(query, dtype=torch.float32,
                                    device=self.device)
            b = query.shape[0]
            qs, qe = query.chunk(2, dim=1)
            stacked = torch.cat([qs, qe], 0)
            if self.R is not None:
                stacked = stacked @ self.R  # rotate queries into code space
            scores, gids = self.index.search(
                stacked, top_k, nprobe=nprobe, as_numpy=False,
                **({} if chunk is None else {"chunk": chunk}))
        s_scores, e_scores = scores[:b], scores[b:]
        s_gids, e_gids = gids[:b], gids[b:]

        if self.collect_stats:  # unique-docs-per-query stat (ref: :380-386)
            s_doc, _ = self.store.global_to_doc(s_gids.cpu().numpy())
            e_doc, _ = self.store.global_to_doc(e_gids.cpu().numpy())
            num_docs = sum(
                len(set(sd.tolist()) | set(ed.tolist()))
                for sd, ed in zip(s_doc, e_doc)) / max(b, 1)
            self.num_docs_list.append(num_docs)
        return s_gids, e_gids, s_scores, e_scores

    # ---------------- stage 2 ----------------
    def _rescore(self, query, s_gids, e_gids, s_scores, e_scores,
                 max_answer_length: int, return_idxs: bool):
        """The device rescore and the hit ids as a dict of device tensors:
        queries rotated by ``R`` (and, in decode mode, into the index's code
        space), returned vectors rotated back (ref search.py:405-476)."""
        query = torch.as_tensor(query, dtype=torch.float32, device=self.device)
        qs, qe = query.chunk(2, dim=1)
        if self.R is not None:
            qs, qe = qs @ self.R, qe @ self.R
        pq, out_rot = None, self.R
        if self.pq_serve is not None:
            ps = self.pq_serve
            if ps["rot"] is not None:
                qs, qe = qs @ ps["rot"], qe @ ps["rot"]
                out_rot = ps["rot"]
            pq = (ps["codes"], ps["books"], ps["inv_perm"], ps["row_list"],
                  ps["c_rot"])
        res = _rescore_spans(
            qs, qe, s_gids, e_gids, s_scores, e_scores,
            self.vecs_dev, self.f2o_dev, self.doc_end_dev, self.doc_base_dev,
            self.store.offset, self.store.scale, pq,
            max_answer_length=max_answer_length, return_vecs=return_idxs)
        if return_idxs and out_rot is not None:
            # serve scores are (q·R)·c: hand back v = c·Rᵀ, so q·v is the
            # serve score (ref: search.py:468-476)
            for key in VEC_KEYS:
                res[key] = res[key] @ out_rot.T
        res["s_gids"], res["e_gids"] = s_gids, e_gids
        return res

    def rescore(self, query, s_gids, e_gids, s_scores, e_scores,
                max_answer_length: int = 10, return_idxs: bool = False):
        """Device half of stage 2: the packed (not yet copied) rescore bundle
        with the hit ids, as ``_pack`` returns it, for ``_send``."""
        with profiling.span("index.rescore"):
            return _pack(self._rescore(query, s_gids, e_gids, s_scores,
                                       e_scores, max_answer_length,
                                       return_idxs))

    def _send(self, buf, layout) -> dict:
        """Start the ONE device→host copy of a packed bundle, into pinned
        memory behind this batch's own work only (a copy issued in
        ``_receive`` would wait for the batches submitted since); on the
        CPU the buffer itself. Returns the handle ``_receive`` takes."""
        done = None
        with profiling.span("serve.copy"):
            if buf.is_cuda:
                host = torch.empty(buf.shape, dtype=buf.dtype,
                                   pin_memory=True)
                host.copy_(buf, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
                buf = host
        profiling.count("serve.d2h_bytes", buf.numel() * buf.element_size())
        return {"buf": buf, "done": done, "layout": layout}

    def _receive(self, handle, return_idxs: bool = False,
                 return_sent: bool = False):
        """Wait for a ``_send`` handle's copy, the one sync point, then
        assemble its result dicts on the host."""
        with profiling.span("serve.wait"):
            if handle["done"] is not None:
                handle["done"].synchronize()
        with profiling.span("index.assemble"):
            res = _unpack(handle["buf"].numpy(), handle["layout"])
            s_gids, e_gids = res.pop("s_gids"), res.pop("e_gids")
            return self._assemble(res, s_gids, e_gids,
                                  return_idxs=return_idxs,
                                  return_sent=return_sent)

    def search_phrase(self, query, s_gids, e_gids, s_scores, e_scores,
                      max_answer_length: int = 10, return_idxs: bool = False,
                      return_sent: bool = False, vecs_on_device: bool = False):
        """Constrained span rescore + host result assembly
        (ref: index.py:220-422).

        vecs_on_device (implies return_idxs): the candidate vectors stay on
        the device and are not attached to the result dicts; the return
        value is ``(results, (start_vecs, end_vecs))``, two [B, 2K, D]
        device tensors whose columns are the candidates' ``cand_col``."""
        if vecs_on_device:
            return_idxs = True
        if self.tiered:
            return self._search_phrase_host(
                query, s_gids, e_gids, s_scores, e_scores, max_answer_length,
                return_idxs, return_sent, vecs_on_device)
        dev_vecs = None
        with profiling.span("index.rescore"):
            res = self._rescore(query, s_gids, e_gids, s_scores, e_scores,
                                max_answer_length, return_idxs)
            if vecs_on_device:
                # K start-anchored spans, then K end-anchored spans
                dev_vecs = (
                    torch.cat([res.pop("start_vec_anchor"),
                               res.pop("start_vec_for_end")], dim=1),
                    torch.cat([res.pop("end_vec_for_start"),
                               res.pop("end_vec_anchor")], dim=1))
                return_idxs = False
            bundle = _pack(res)
        outs = self._receive(self._send(*bundle), return_idxs, return_sent)
        return (outs, dev_vecs) if dev_vecs is not None else outs

    def _search_phrase_host(self, query, s_gids, e_gids, s_scores, e_scores,
                            max_answer_length: int, return_idxs: bool,
                            return_sent: bool, vecs_on_device: bool):
        """``search_phrase`` over a tiered index: the hits come to the host
        and ``_rescore_spans_host`` rescores there; returned vectors are
        rotated back by ``Rᵀ`` (ref search.py:412-443)."""
        query = torch.as_tensor(query, dtype=torch.float32, device=self.device)
        qs, qe = query.chunk(2, dim=1)
        if self.R is not None:
            qs, qe = qs @ self.R, qe @ self.R
        dev_vecs = None
        with profiling.span("index.rescore"):
            s_gids, e_gids, s_scores, e_scores = (
                torch.as_tensor(t).cpu().numpy()
                for t in (s_gids, e_gids, s_scores, e_scores))
            s_gids, e_gids = s_gids.astype(np.int64), e_gids.astype(np.int64)
            res = _rescore_spans_host(
                qs.cpu().numpy(), qe.cpu().numpy(), s_gids, e_gids, s_scores,
                e_scores, self.index.gather_rows_host, self.f2o_host,
                self.doc_end_host, self.doc_base_host, self.store.offset,
                self.store.scale, max_answer_length=max_answer_length,
                return_vecs=return_idxs, n_total=self.store.n_vecs)
            if return_idxs and self.R is not None:
                rt = self.R.cpu().numpy().T
                for key in VEC_KEYS:
                    res[key] = res[key] @ rt
            if vecs_on_device:
                # K start-anchored spans, then K end-anchored spans
                dev_vecs = tuple(
                    torch.as_tensor(np.concatenate(
                        [res.pop(a), res.pop(b)], axis=1), device=self.device)
                    for a, b in (("start_vec_anchor", "start_vec_for_end"),
                                 ("end_vec_for_start", "end_vec_anchor")))
                return_idxs = False
        with profiling.span("index.assemble"):
            outs = self._assemble(res, s_gids, e_gids,
                                  return_idxs=return_idxs,
                                  return_sent=return_sent)
        return (outs, dev_vecs) if dev_vecs is not None else outs

    def _assemble(self, res, s_gids, e_gids, return_idxs: bool = False,
                  return_sent: bool = False):
        """Host stage 3: char-offset lookup + result dict construction from
        the downloaded rescore bundle (ref: index.py:374-422)."""
        b = s_gids.shape[0]
        # per query: for each of the K start hits a (start, best end) span,
        # then for each of the K end hits a (best start, end) span — 2K
        # candidates (ref: index.py:374-378)
        span_start_gids = np.concatenate(
            [s_gids, e_gids + res["start_offset"]], axis=1)  # [B, 2K]
        span_end_gids = np.concatenate(
            [s_gids + res["end_offset"], e_gids], axis=1)
        span_scores = np.concatenate(
            [res["joint_from_start"], res["joint_from_end"]], axis=1)
        if return_idxs:
            start_vecs = np.concatenate(
                [res["start_vec_anchor"], res["start_vec_for_end"]], axis=1)
            end_vecs = np.concatenate(
                [res["end_vec_for_start"], res["end_vec_anchor"]], axis=1)

        out = []
        store = self.store
        for bi in range(b):
            cands = []
            doc_pos, s_local = store.global_to_doc(span_start_gids[bi])
            _, e_local = store.global_to_doc(span_end_gids[bi])
            for ci in range(span_start_gids.shape[1]):
                score = float(span_scores[bi, ci])
                if score <= SCORE_FLOOR:
                    continue
                dpos = int(doc_pos[ci])
                meta = store.meta(dpos)
                sl, el = int(s_local[ci]), int(e_local[ci])
                if sl < 0 or el < 0 or sl >= len(meta.f2o_start) \
                        or el >= len(meta.f2o_start):
                    continue
                start_pos = int(meta.word2char_start[meta.f2o_start[sl]])
                if len(meta.word2char_end) > 0 and el >= 0:
                    end_pos = int(meta.word2char_end[meta.f2o_start[el]])
                else:
                    end_pos = start_pos + 1
                each = {
                    "context": meta.context,
                    "title": [meta.title],
                    "doc_idx": int(store.doc_ids[dpos]),
                    "start_pos": start_pos, "end_pos": end_pos,
                    "start_idx": sl, "end_idx": el,
                    "score": score,
                    "cand_col": ci,
                    "start_vec": start_vecs[bi, ci] if return_idxs else None,
                    "end_vec": end_vecs[bi, ci] if return_idxs else None,
                }
                each["answer"] = each["context"][each["start_pos"]:each["end_pos"]]
                each = self.adjust(each)
                if return_sent:
                    each = self.adjust_sent(each)
                cands.append(each)
            cands.sort(key=lambda x: -x["score"])
            out.append(cands)
        return out

    # ---------------- context adjustment (ref: index.py:167-187) -----------
    @staticmethod
    def adjust(each, delimiter: str = " [PAR] "):
        last = each["context"].rfind(delimiter, 0, each["start_pos"])
        last = 0 if last == -1 else last + len(delimiter)
        nxt = each["context"].find(delimiter, each["end_pos"])
        nxt = len(each["context"]) if nxt == -1 else nxt
        each["context"] = each["context"][last:nxt]
        each["start_pos"] -= last
        each["end_pos"] -= last
        return each

    @staticmethod
    def adjust_sent(each):
        sents = _sentencize(each["context"])
        starts = np.array([s[1] for s in sents])
        first = max(int((starts <= each["start_pos"]).sum()) - 1, 0)
        last = max(int((starts <= max(each["end_pos"] - 1, 0)).sum()) - 1, first)
        each["context"] = " ".join(s[0] for s in sents[first:last + 1])
        each["start_pos"] -= sents[first][1]
        each["end_pos"] -= sents[first][1]
        return each

    # ---------------- aggregation (ref: index.py:424-448) -------------------
    @staticmethod
    def aggregate_results(results, top_k: int = 10, q_text: Optional[str] = None,
                          agg_strat: str = "opt1"):
        seen = {}
        for r_idx, result in enumerate(results):
            if agg_strat == "opt1":
                key = f'{result["title"]}_{result["start_pos"]}_{result["end_pos"]}'
            elif agg_strat == "opt2":
                key = result["context"]
            elif agg_strat == "opt3":
                key = str(result["title"])
            elif agg_strat == "opt4":
                key = normalize_answer(result["answer"])
            else:
                raise NotImplementedError(f"wrong aggregation strategy {agg_strat}")
            if key not in seen:
                seen[key] = r_idx
            else:
                result["score"] = -1e8
                if agg_strat == "opt4":
                    kept = results[seen[key]]
                    if result["title"][0] not in kept["title"]:
                        kept["title"] = kept["title"] + result["title"]
        results = sorted(results, key=lambda x: -x["score"])
        return [r for r in results if r["score"] > SCORE_FLOOR]

    # ---------------- orchestrator (ref: index.py:450-482) ------------------
    def search(self, query, q_texts=None, nprobe: int = 256, top_k: int = 10,
               aggregate: bool = False, return_idxs: bool = False,
               max_answer_length: int = 10, agg_strat: str = "opt1",
               return_sent: bool = False, vecs_on_device: bool = False):
        s_gids, e_gids, s_scores, e_scores = self.search_dense(
            query, top_k=top_k, nprobe=nprobe)
        outs = self.search_phrase(
            query, s_gids, e_gids, s_scores, e_scores,
            max_answer_length=max_answer_length, return_idxs=return_idxs,
            return_sent=return_sent, vecs_on_device=vecs_on_device)
        if vecs_on_device:
            return outs  # (results, (start_vecs, end_vecs)): search_phrase
        if aggregate:
            outs = self._aggregate(outs, q_texts, top_k, agg_strat)
        return outs

    def _aggregate(self, outs, q_texts, top_k: int, agg_strat: str):
        """``aggregate_results`` over each query's results."""
        q_texts = q_texts if q_texts is not None else [None] * len(outs)
        with profiling.span("index.aggregate"):
            return [self.aggregate_results(results, top_k, q_text, agg_strat)
                    for results, q_text in zip(outs, q_texts)]
