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
  and the doc bounds, and an argmax (``_rescore_spans``). Its results come
  to the host in ONE device→host copy (``_pack`` / ``_unpack``).
stage 3 — ``_assemble`` (host): char offsets and result dicts; then
  ``aggregate_results`` (opt1–opt4) and the context-window adjustments.

The rescore reads the int8 corpus in its original row order: a flat index
shares its padded code buffer, a PQ / OPQ IVF index with an int8 refine
shares its refine matrix (the store's own codes), and an SQ8 / SQ4 IVF
index (whose codes are sorted by list) gets the store's vectors uploaded.

Not ported yet: a query rotation (``MIPS.R``), the PQ decode-mode rescore
(``pq_serve``, a PQ index without refine), the host-tiered rescore,
``vecs_on_device``, and the tiered / sharded indexes.
"""

from __future__ import annotations

import re
from typing import Optional

import numpy as np
import torch

from densephrases_tpu_torch.eval.metrics import normalize_answer
from densephrases_tpu_torch.index.flat import FlatIndex
from densephrases_tpu_torch.index.ivf import IVFIndex, _upload
from densephrases_tpu_torch.index.store import PhraseStore
from densephrases_tpu_torch.utils.device import resolve_device
from densephrases_tpu_torch.utils.profiling import StageTimer

NEG_INF = -1e9
SCORE_FLOOR = -1e5  # host-side filter for masked/dummy results (ref: index.py:420)


def _rescore_spans(query_start, query_end, s_gids, e_gids, s_scores, e_scores,
                   vecs, f2o, doc_end_row, doc_base_row, offset: float,
                   scale: float, *, max_answer_length: int,
                   return_vecs: bool = False):
    """Constrained span rescoring for both anchor directions, on the device.

    query_start/query_end: [B, D] fp32. s_gids/e_gids: [B, K] row ids of the
    start/end hits; s_scores/e_scores: [B, K] their MIPS scores. vecs: the
    padded [R, D] int8 corpus; f2o, doc_end_row, doc_base_row: [N].
    Returns per-direction best partner offsets and joint scores (and the
    partner vectors when return_vecs)."""
    n = f2o.shape[0]
    L = max_answer_length
    dev = s_gids.device

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
    """Phrase search engine over a flat int8 or an IVF index on one device
    (API parity with ref MIPS, index.py:23)."""

    def __init__(self, store: PhraseStore, index=None, device=None):
        """index: a ``FlatIndex`` or ``IVFIndex`` (None: a flat index over
        the store). device: where to upload the corpus when no ``index`` is
        given (None: "cuda"); with an ``index``, None or its device."""
        self.store = store
        if index is None:
            index = FlatIndex(store.vecs, store.offset, store.scale,
                              device="cuda" if device is None else device)
        elif not isinstance(index, (FlatIndex, IVFIndex)):
            raise NotImplementedError(
                "the port serves a FlatIndex or an IVFIndex")
        elif device is not None and resolve_device(device).type != index.device.type:
            raise ValueError(f"index is on {index.device}, asked for {device}")
        self.index = index
        self.device = index.device

        # decompress all doc metadata in the background; per-doc meta()
        # decompresses on demand until the sweep catches up
        store.preload_metas(background=True)

        # per-row serve arrays: f2o from the store's sidecar, doc bounds as
        # a repeat over the doc lengths (no per-doc Python loop)
        f2o = store.f2o_flat()
        lens = np.diff(store.doc_bases).astype(np.int64)
        # int32 row ids (ref: search.py:279-281)
        rdt = np.int32 if store.n_vecs < 2**31 else np.int64
        doc_end_row = np.repeat(store.doc_bases[1:].astype(rdt), lens)
        doc_base_row = np.repeat(store.doc_bases[:-1].astype(rdt), lens)
        self.vecs_dev = self._rescore_corpus(store, index)
        self.f2o_dev = torch.tensor(f2o, device=self.device)
        self.doc_end_dev = torch.tensor(doc_end_row, device=self.device)
        self.doc_base_dev = torch.tensor(doc_base_row, device=self.device)
        self.timer = StageTimer()

    @staticmethod
    def _rescore_corpus(store: PhraseStore, index):
        """The original-order int8 corpus on the index's device for the
        rescore (which clips row ids, so pad rows are never candidates)."""
        if isinstance(index, FlatIndex):
            return index.codes  # shared: the padded flat buffer
        refine = index.refine_codes
        if (refine is not None and refine.shape[0] >= store.n_vecs
                and refine.shape[1] == store.dim):
            return refine  # PQ / OPQ with refine: the store's own codes
        if index.pq_books is not None:
            raise NotImplementedError(
                "a PQ / OPQ IVF index without an int8 refine needs the "
                "decode-mode rescore (the reference's pq_serve), which is "
                "not ported")
        # SQ8 / SQ4: the index's codes are sorted by list
        return _upload(store.vecs, torch.int8, index.device)

    # ---------------- stage 1 ----------------
    def search_dense(self, query, top_k: int = 10, nprobe: int = 256):
        """query: [B, 2D] — returns start/end hit ids + scores as DEVICE
        tensors (ref: index.py:189-218). nprobe: IVF lists probed (capped
        at nlist by the index; a flat index ignores it)."""
        query = torch.as_tensor(query, dtype=torch.float32, device=self.device)
        b = query.shape[0]
        qs, qe = query.chunk(2, dim=1)
        stacked = torch.cat([qs, qe], 0)
        with self.timer.stage("mips_device"):
            scores, gids = self.index.search(stacked, top_k, nprobe=nprobe,
                                             as_numpy=False)
        s_scores, e_scores = scores[:b], scores[b:]
        s_gids, e_gids = gids[:b], gids[b:]
        return s_gids, e_gids, s_scores, e_scores

    # ---------------- stage 2 ----------------
    def rescore(self, query, s_gids, e_gids, s_scores, e_scores,
                max_answer_length: int = 10, return_idxs: bool = False):
        """Device half of stage 2: the packed (not yet copied) rescore bundle
        with the hit ids, as ``_pack`` returns it."""
        query = torch.as_tensor(query, dtype=torch.float32, device=self.device)
        qs, qe = query.chunk(2, dim=1)
        res = _rescore_spans(
            qs, qe, s_gids, e_gids, s_scores, e_scores,
            self.vecs_dev, self.f2o_dev, self.doc_end_dev, self.doc_base_dev,
            self.store.offset, self.store.scale,
            max_answer_length=max_answer_length, return_vecs=return_idxs)
        res["s_gids"], res["e_gids"] = s_gids, e_gids
        return _pack(res)

    def search_phrase(self, query, s_gids, e_gids, s_scores, e_scores,
                      max_answer_length: int = 10, return_idxs: bool = False,
                      return_sent: bool = False):
        """Constrained span rescore + host result assembly
        (ref: index.py:220-422)."""
        with self.timer.stage("rescore_device"):
            buf, layout = self.rescore(
                query, s_gids, e_gids, s_scores, e_scores,
                max_answer_length=max_answer_length, return_idxs=return_idxs)
            # ONE device→host copy for everything stage 3 needs
            res = _unpack(buf.cpu().numpy(), layout)
        s_gids, e_gids = res.pop("s_gids"), res.pop("e_gids")
        return self._assemble(res, s_gids, e_gids, return_idxs=return_idxs,
                              return_sent=return_sent)

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

        with self.timer.stage("assemble_host"):
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
               return_sent: bool = False):
        s_gids, e_gids, s_scores, e_scores = self.search_dense(
            query, top_k=top_k, nprobe=nprobe)
        outs = self.search_phrase(
            query, s_gids, e_gids, s_scores, e_scores,
            max_answer_length=max_answer_length, return_idxs=return_idxs,
            return_sent=return_sent)
        if aggregate:
            q_texts = q_texts if q_texts is not None else [None] * len(outs)
            outs = [
                self.aggregate_results(results, top_k, q_text, agg_strat)
                for results, q_text in zip(outs, q_texts)
            ]
        return outs
