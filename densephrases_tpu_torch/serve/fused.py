"""Fused serve path: query text → span ids with one sync point.

The counterpart of ``densephrases_tpu/serve/fused.py``. ``submit``
tokenizes on the host and enqueues the whole device path — both query
towers, the stage-1 int8 scan and the stage-2 span rescore — without
waiting: CUDA kernels launch asynchronously, which plays the part of JAX's
async dispatch. ``submit`` also enqueues the one device→host copy of the
packed result bundle, into pinned memory; ``collect`` is the only sync
point: it waits for that copy, then assembles on the host. ``search_pipelined``
keeps ``depth`` batches in flight, so host tokenization and assembly of one
batch overlap the device work of the next.

It serves a single-device int8 ``FlatIndex`` only and refuses any other
index, as the reference does (an IVF index goes through
``DensePhrases.search``).
"""

from __future__ import annotations

from typing import Optional

import torch

from densephrases_tpu_torch.index.flat import FlatIndex
from densephrases_tpu_torch.index.search import _unpack


class FusedServer:
    """Wraps a DensePhrases model whose MIPS runs a single-device int8
    FlatIndex. Drop-in for ``.search`` with the phrase unit."""

    def __init__(self, model, chunk: Optional[int] = None):
        """chunk: the rows of the stage-1 scan's chunks (None: the index's).
        Each chunk's top-k is exact, so the ids do not depend on it."""
        index = model.mips.index
        if not (isinstance(index, FlatIndex) and index.mesh is None
                and index.quant == "int8"):
            raise AssertionError(
                "fused serving needs a single-device int8 FlatIndex")
        self.model = model
        self.mips = model.mips
        self.chunk = chunk or index.chunk

    def submit(self, queries, top_k: int = 10, max_answer_length: int = 10,
               aggregate: bool = True, agg_strat: str = "opt1",
               return_sent: bool = False, truecase: bool = True):
        """Tokenize + enqueue the device path without blocking; pass the
        returned handle to ``collect``."""
        model = self.model
        # the truecasing of DensePhrases.search: the fused and modular paths
        # see the same query text (ref: serve/fused.py:87-93)
        if truecase and model.truecase is not None:
            queries = [
                q if q != q.lower() else model.truecase.get_true_case(q)
                for q in queries
            ]
        query = model.query2vec(queries)
        hits = self.mips.search_dense(query, top_k=top_k, chunk=self.chunk)
        buf, layout = self.mips.rescore(query, *hits,
                                        max_answer_length=max_answer_length)
        done = None
        if buf.is_cuda:
            # enqueue this batch's ONE device→host copy now, behind its own
            # work only: a copy issued in collect() would queue behind the
            # batches submitted since, and wait for them too
            host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
            host.copy_(buf, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            buf = host
        return {"buf": buf, "done": done, "layout": layout, "queries": queries,
                "top_k": top_k, "aggregate": aggregate,
                "agg_strat": agg_strat, "return_sent": return_sent}

    def collect(self, handle):
        """Wait for a ``submit`` handle's copy and assemble result dicts."""
        if handle["done"] is not None:
            handle["done"].synchronize()  # the only sync point
        res = _unpack(handle["buf"].numpy(), handle["layout"])
        s_gids, e_gids = res.pop("s_gids"), res.pop("e_gids")
        outs = self.mips._assemble(res, s_gids, e_gids,
                                   return_sent=handle["return_sent"])
        if handle["aggregate"]:
            outs = [self.mips.aggregate_results(
                        r, handle["top_k"], q, handle["agg_strat"])
                    for r, q in zip(outs, handle["queries"])]
        return outs

    def search(self, queries, top_k: int = 10, max_answer_length: int = 10,
               aggregate: bool = True, agg_strat: str = "opt1",
               return_sent: bool = False, truecase: bool = True):
        return self.collect(self.submit(
            queries, top_k=top_k, max_answer_length=max_answer_length,
            aggregate=aggregate, agg_strat=agg_strat,
            return_sent=return_sent, truecase=truecase))

    def search_pipelined(self, query_batches, depth: int = 2, **kwargs):
        """Serve a stream of query batches with ``depth`` batches in flight
        (host assembly of batch i overlaps device work of batches
        i+1..i+depth)."""
        handles, outs = [], []
        for qb in query_batches:
            handles.append(self.submit(qb, **kwargs))
            if len(handles) >= depth:
                outs.append(self.collect(handles.pop(0)))
        while handles:
            outs.append(self.collect(handles.pop(0)))
        return outs
