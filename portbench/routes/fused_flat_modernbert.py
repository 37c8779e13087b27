"""The fused flat route with ModernBERT query towers: ``FusedServer.search``
over a single-device int8 ``FlatIndex``, as ``fused_flat``, with the two
towers built from the published HF key names through the port's
``models/hf_import.py`` and served in bf16.

One request is one batch of queries; its answers are the aggregated
phrase answers of each query. A checkout whose port has no ModernBERT
module fails in ``Served.__init__``, at set-up.
"""

from __future__ import annotations

import dataclasses

import torch

from portbench import inputs, inputs_modernbert, port, work
from portbench.reference import bert as ref_bert
from portbench.reference import modernbert as ref_mb
from portbench.reference import search as ref_search
from portbench.reference import tokenize as ref_tok
from portbench.work import modernbert as work_mb


def make_inputs(config: dict, seed: int, device) -> dict:
    """The corpus's int8 codes, drawn on the device, as a host array."""
    return {"codes": inputs.make_flat_codes(config["index"], seed,
                                            device).cpu().numpy()}


class Served:
    def __init__(self, config: dict, traffic: dict, seed: int, vocab: list,
                 device, made: dict):
        from densephrases_tpu_torch.index.search import MIPS
        from densephrases_tpu_torch.model import DensePhrases
        from densephrases_tpu_torch.models.hf_import import (
            modernbert_encoder_from_state_dict)
        from densephrases_tpu_torch.models.modernbert import ModernBertConfig
        from densephrases_tpu_torch.serve.fused import FusedServer

        idx = config["index"]
        self.traffic = traffic
        store = port.phrase_store(made["codes"], inputs.doc_layout(idx),
                                  idx["offset"], idx["scale"])
        store.preload_metas()  # the doc metadata in RAM before serving
        mips = MIPS(store, device=device)
        mb = ModernBertConfig(**{f.name: config["model"][f.name]
                                 for f in dataclasses.fields(ModernBertConfig)
                                 if f.name in config["model"]})
        sd = inputs_modernbert.make_weights(config["model"], config["weights"],
                                            seed, device)
        params = modernbert_encoder_from_state_dict(
            sd, mb, towers=("query_start", "query_end"))
        del sd
        self.model = DensePhrases(
            params, mb, port.tokenizer(vocab), mips,
            max_query_length=traffic["max_query_length"])
        self.fused = FusedServer(self.model)

    def serve(self, texts):
        return self.fused.search(
            texts, top_k=self.traffic["top_k"],
            max_answer_length=self.traffic["max_answer_length"],
            aggregate=True)

    def layers(self):
        """(object, attribute, layer) of each call a traced run times."""
        m = self.model.mips
        return [(self.model, "query2vec", "towers"),
                (m, "search_dense", "search"), (m, "rescore", "search"),
                (m, "_assemble", "assemble"),
                (m, "aggregate_results", "assemble")]

    def close(self):
        self.fused = self.model = None


def request_work(config: dict, traffic: dict) -> dict:
    """A request's work: kernel A's global and banded launches and (ops,
    bytes) a launch of each, the stage-1 scan's (ops, bytes), and the
    useful operations of the whole step (band-aware)."""
    model, idx = config["model"], config["index"]
    b, l = traffic["batch"], traffic["max_query_length"]
    h, nh = model["hidden_size"], model["num_attention_heads"]
    glob, local = work_mb.layer_kinds(model)
    n = idx["n_docs"] * idx["vecs_per_doc"]
    scan = work.flat_scan(2 * b, n, idx["dim"])
    return {
        "attn_fwd": {"launches": 2 * glob,
                     "per_launch": work.attention_fwd(b, nh, l, h // nh)},
        "attn_band": {"launches": 2 * local,
                      "per_launch": work_mb.attention_band(
                          b, nh, l, h // nh, model["local_attention"] // 2)},
        "search": scan,
        "step_flops": (2 * work_mb.tower_flops(model, b, l) + scan[0]
                       + work.rescore_flops(b, traffic["top_k"],
                                            traffic["max_answer_length"],
                                            idx["dim"])),
    }


def reference(config: dict, traffic: dict, seed: int, vocab: list,
              batches: list, made: dict, device, precision: str = "fp32"):
    """The reference's answers to the queries of ``batches`` (lists of
    texts), each query's score spread, and its scorer of served spans
    ``[(query, start row, end row)]``, queries counted across the
    batches."""
    idx, model = config["index"], config["model"]
    texts = [t for batch in batches for t in batch]
    corpus = torch.as_tensor(made["codes"]).to(device)
    sd = inputs_modernbert.make_weights(model, config["weights"], seed,
                                        device)
    ids, mask = ref_tok.encode(texts, vocab, traffic["max_query_length"])
    qs, qe = ref_mb.encode(sd, model, torch.as_tensor(ids, device=device),
                           torch.as_tensor(mask, device=device),
                           ref_bert.PRECISIONS[precision])
    del sd
    answers, units = ref_search.flat_search(
        corpus, idx["offset"], idx["scale"], qs, qe,
        vpd=idx["vecs_per_doc"], top_k=traffic["top_k"],
        max_len=traffic["max_answer_length"])
    return answers, units, ref_search.span_scorer(
        corpus, idx["offset"], idx["scale"], qs, qe)
