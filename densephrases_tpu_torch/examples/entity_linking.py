"""Runnable entity-linking example (KILT AIDA-YAGO2 shape).

The counterpart of ``examples/entity-linking/run.py``. The query is a
sentence with an entity mention; the prediction is the retrieved page,
scored with R-Precision over provenance (the reference's entity-linking
example). Document-level retrieval: the top-1 title is the linked entity.

Usage: python -m densephrases_tpu_torch.examples.entity_linking [--cpu]
           [--load_dir DIR]
           [--vocab_kind wordpiece|whole_word]
"""

from __future__ import annotations

import argparse
import sys

from densephrases_tpu_torch.examples import _common


def main(argv=None, device="cuda"):
    """Returns (metrics, [(query, answer)])."""
    argv, device = _common.parse_device(
        sys.argv[1:] if argv is None else argv, device)
    ap = argparse.ArgumentParser()
    ap.add_argument("--load_dir", default="")
    ap.add_argument("--workdir",
                    default=_common.default_workdir("dph_entity_linking"))
    ap.add_argument("--top_k", type=int, default=5)
    _common.add_vocab_arg(ap)
    args = ap.parse_args(argv)

    from densephrases_tpu_torch.eval.kilt import (
        evaluate_kilt, results_to_kilt_predictions)

    dp, _ = _common.build_tiny_model(args.workdir, args.load_dir,
                                     device=device,
                                     vocab_kind=args.vocab_kind)

    # AIDA-style: mention in context, gold = the linked wiki page
    records = [
        ("She discovered radium while working in Paris [ENT] Curie [ENT]",
         ["Marie Curie"]),
        ("The Analytical Engine program was written by [ENT] Lovelace "
         "[ENT]", ["Ada Lovelace"]),
        ("[ENT] Turing [ENT] broke the Enigma code during the war",
         ["Alan Turing"]),
    ]
    queries = [r[0] for r in records]
    title2wikiid = {d["title"]: str(i)
                    for i, d in enumerate(_common.TINY_WIKI)}
    golds = [{"answers": list(r[1]),
              "provenance": [[title2wikiid[t] for t in r[1]]]}
             for r in records]

    qvec = dp.query2vec(queries)
    results = dp.mips.search(qvec, q_texts=queries, top_k=args.top_k,
                             aggregate=True, agg_strat="opt3")  # doc-level
    preds = results_to_kilt_predictions(results, title2wikiid)
    # entity linking predicts the page title as the answer
    for p, res in zip(preds, results):
        p["answer"] = res[0]["title"][0] if res else ""
    metrics = evaluate_kilt(preds, golds)
    print("entity-linking metrics:", metrics)
    for q, p in zip(queries, preds):
        print(f"  {q[:50]!r} -> {p['answer']!r}")
    return metrics, [(q, p["answer"]) for q, p in zip(queries, preds)]


if __name__ == "__main__":
    main()
