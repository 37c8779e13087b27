"""The modular IVF route: ``DensePhrases.search(..., retrieval_unit=
"phrase")`` over ``MIPS`` with an IVF-PQ ``IVFIndex`` (OPQ rotation,
residual PQ codes, the device int8 refine), the route ``serve/server.py``
takes for any index but a single-device int8 flat one; the two BERT
query towers in bf16.

The harness makes the index's arrays from the seed (``inputs.make_ivf``)
and hands them to ``IVFIndex(...)``, the host-array constructor that
``IVFIndex.load`` calls, as a served index is loaded, not trained. One
request is one batch of queries.
"""

from __future__ import annotations

import torch

from portbench import inputs, port, work
from portbench.reference import bert as ref_bert
from portbench.reference import search as ref_search
from portbench.reference import tokenize as ref_tok


def make_inputs(config: dict, seed: int, device) -> dict:
    return inputs.make_ivf(config["index"], seed, device)


class Served:
    def __init__(self, config: dict, traffic: dict, seed: int, vocab: list,
                 device, made: dict):
        from densephrases_tpu_torch.index.ivf import IVFConfig, IVFIndex
        from densephrases_tpu_torch.index.search import MIPS
        from densephrases_tpu_torch.model import DensePhrases
        from densephrases_tpu_torch.ops.pq import PQCodebook

        idx = config["index"]
        if traffic["nprobe"] != idx["nprobe"]:
            raise ValueError("DensePhrases.search probes the MIPS default "
                             f"of {idx['nprobe']} lists, not "
                             f"{traffic['nprobe']}")
        self.traffic, self.made, self.idx = traffic, made, idx
        cfg = IVFConfig(num_clusters=idx["nlist"],
                        fine_quant=idx["fine_quant"],
                        refine_factor=idx["refine_factor"], pq_residual=True)
        ivf = IVFIndex(cfg, made["centroids"], made["row_perm"],
                       made["list_offsets"], made["pq_codes"],
                       rotation=made["rotation"],
                       pq=PQCodebook(made["books"]), offset=idx["offset"],
                       scale=idx["scale"], n_total=idx["n_rows"],
                       refine_codes=made["codes"], device=device)
        store = port.phrase_store(made["codes"], inputs.doc_layout(idx),
                                  idx["offset"], idx["scale"])
        store.preload_metas()  # the doc metadata in RAM before serving
        mips = MIPS(store, index=ivf)
        sd = inputs.make_weights(config["model"], config["weights"], seed,
                                 device)
        params = port.encoder_params(config["model"], sd, device)
        del sd
        self.model = DensePhrases(
            params, port.bert_config(config["model"]), port.tokenizer(vocab),
            mips, max_query_length=traffic["max_query_length"])
        self.tracing, self.queries = False, []
        search = ivf.search

        def recorded(queries, *args, **kwargs):
            if self.tracing:  # the stacked queries D scores, for its bytes
                self.queries.append(torch.as_tensor(queries).detach())
            return search(queries, *args, **kwargs)

        ivf.search = recorded

    def serve(self, texts):
        _, rets = self.model.search(
            texts, retrieval_unit="phrase", top_k=self.traffic["top_k"],
            return_meta=True,
            max_answer_length=self.traffic["max_answer_length"])
        return rets

    def layers(self):
        m = self.model.mips
        return [(self.model, "query2vec", "towers"),
                (m, "search_dense", "search"), (m, "search_phrase", "search"),
                (m, "_assemble", "assemble"),
                (m, "aggregate_results", "assemble")]

    def traced_work(self):
        """Kernel D's (ops, bytes) for each traced search: the rows and
        blocks of the lists its queries probed, by the port's probe rule
        (bf16 operands)."""
        dev = self.queries[0].device if self.queries else None
        index = {"centroids": torch.as_tensor(self.made["centroids"],
                                              device=dev),
                 "list_offsets": torch.as_tensor(self.made["list_offsets"],
                                                 device=dev)}
        out = []
        for q in self.queries:
            rows, blocks = ref_search.probed_rows(
                index, q.float(), self.idx["nprobe"],
                rnd=lambda t: t.to(torch.bfloat16).to(torch.float32))
            out.append(work.pq_scan(q.shape[0], rows.numel(), self.idx["m"],
                                    2 ** self.idx["nbits"], blocks))
        return out

    def close(self):
        self.model = None
        self.queries = []


def request_work(config: dict, traffic: dict) -> dict:
    model, idx = config["model"], config["index"]
    b, l = traffic["batch"], traffic["max_query_length"]
    h, nh = model["hidden_size"], model["num_attention_heads"]
    k, d = traffic["top_k"], idx["dim"]
    return {
        "attn_fwd": {"launches": 2 * model["num_hidden_layers"],
                     "per_launch": work.attention_fwd(b, nh, l, h // nh)},
        "step_flops": (2 * work.bert_forward_flops(model, b, l)
                       + work.ivf_probe_flops(2 * b, idx["nlist"], d)
                       + work.refine_flops(2 * b, k * idx["refine_factor"],
                                           d)
                       + work.rescore_flops(b, k,
                                            traffic["max_answer_length"], d)),
    }


def reference(config: dict, traffic: dict, seed: int, vocab: list,
              batches: list, made: dict, device, precision: str = "fp32"):
    """As ``fused_flat.reference``, with IVF stage 1 over each batch."""
    idx, model = config["index"], config["model"]
    texts = [t for batch in batches for t in batch]
    n = idx["n_rows"]
    dev = lambda a: torch.as_tensor(a).to(device)  # noqa: E731
    corpus = dev(made["codes"])
    index = {"centroids": dev(made["centroids"]),
             "list_offsets": dev(made["list_offsets"]),
             "row_perm": dev(made["row_perm"][:n]),
             "rotation": dev(made["rotation"]), "books": dev(made["books"]),
             "pq_codes": dev(made["pq_codes"][:n])}
    sd = inputs.make_weights(model, config["weights"], seed, device)
    ids, mask = ref_tok.encode(texts, vocab, traffic["max_query_length"])
    qs, qe = ref_bert.encode(sd, model, torch.as_tensor(ids, device=device),
                             torch.as_tensor(mask, device=device),
                             ref_bert.PRECISIONS[precision])
    del sd
    spans, at = [], 0
    for batch in batches:
        spans.append((at, len(batch)))
        at += len(batch)
    answers, units = ref_search.ivf_search(
        index, corpus, idx["offset"], idx["scale"], qs, qe, spans,
        vpd=idx["vecs_per_doc"], top_k=traffic["top_k"],
        max_len=traffic["max_answer_length"], nprobe=traffic["nprobe"],
        refine_factor=idx["refine_factor"])
    return answers, units, ref_search.span_scorer(
        corpus, idx["offset"], idx["scale"], qs, qe)
