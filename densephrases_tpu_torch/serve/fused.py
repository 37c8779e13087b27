"""Fused serve path: query text → span ids with one sync point.

The counterpart of ``densephrases_tpu/serve/fused.py``. ``submit``
tokenizes on the host and enqueues the whole device path — both query
towers, the stage-1 int8 scan and the stage-2 span rescore — without
waiting: CUDA kernels launch asynchronously, which plays the part of JAX's
async dispatch. ``submit`` also starts the one device→host copy of the
packed result bundle (``MIPS._send``); ``collect`` is the only sync point:
it waits for that copy and assembles on the host (``MIPS._receive``), the
hand-off ``MIPS.search_phrase`` makes in one call. ``search_pipelined``
keeps ``depth`` batches in flight, so host tokenization and assembly of one
batch overlap the device work of the next.

Each batch is one request of the tracer (``utils/profiling.py``): ``submit``
opens its ``serve.request`` span unless one is open, and the handle carries
the request id to ``collect``, so pipelined batches keep their spans apart.

It serves a single-device int8 ``FlatIndex`` only and refuses any other
index, as the reference does (an IVF index goes through
``DensePhrases.search``).
"""

from __future__ import annotations

from typing import Optional

from densephrases_tpu_torch.index.flat import FlatIndex
from densephrases_tpu_torch.utils import profiling


class FusedServer:
    """Wraps a DensePhrases model whose MIPS runs a single-device int8
    FlatIndex. Drop-in for ``.search`` with the phrase unit."""

    def __init__(self, model, chunk: Optional[int] = None):
        """chunk: the rows of the stage-1 scan's chunks (None: the index's),
        read only where the scan takes the chunked loop (CPU tensors, k
        past kernel E's limit; ``index/flat.py:kernel_route``). Each
        chunk's top-k is exact, so the ids do not depend on it."""
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
        with profiling.request():
            if truecase:  # the fused and modular paths see the same text
                queries = self.model._truecased(queries)
            query = self.model.query2vec(queries)
            hits = self.mips.search_dense(query, top_k=top_k,
                                          chunk=self.chunk)
            handle = self.mips._send(*self.mips.rescore(
                query, *hits, max_answer_length=max_answer_length))
            handle.update(queries=queries, top_k=top_k, aggregate=aggregate,
                          agg_strat=agg_strat, return_sent=return_sent,
                          request=profiling.current_request())
            return handle

    def collect(self, handle):
        """Wait for a ``submit`` handle's copy and assemble result dicts."""
        with profiling.request(handle["request"]):
            outs = self.mips._receive(handle,
                                      return_sent=handle["return_sent"])
            if handle["aggregate"]:
                outs = self.mips._aggregate(outs, handle["queries"],
                                            handle["top_k"],
                                            handle["agg_strat"])
            return outs

    def search(self, queries, top_k: int = 10, max_answer_length: int = 10,
               aggregate: bool = True, agg_strat: str = "opt1",
               return_sent: bool = False, truecase: bool = True):
        with profiling.request():
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
