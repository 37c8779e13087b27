"""Runnable slot-filling example (KILT T-REx / Zero-shot-RE shape).

The counterpart of ``examples/slot-filling/run.py``. Queries are
``subject [SEP] relation``; predictions are scored with KILT-Accuracy
(answer EM gated on provenance) through the KILT eval path (the
reference's slot-filling example).

Usage: python -m densephrases_tpu_torch.examples.slot_filling [--cpu]
           [--load_dir DIR]
           [--vocab_kind wordpiece|whole_word]
"""

from __future__ import annotations

import argparse
import sys

from densephrases_tpu_torch.examples import _common


def main(argv=None, device="cuda"):
    """Returns (metrics, [(query, answer, title)])."""
    argv, device = _common.parse_device(
        sys.argv[1:] if argv is None else argv, device)
    ap = argparse.ArgumentParser()
    ap.add_argument("--load_dir", default="")
    ap.add_argument("--workdir",
                    default=_common.default_workdir("dph_slot_filling"))
    ap.add_argument("--top_k", type=int, default=5)
    _common.add_vocab_arg(ap)
    args = ap.parse_args(argv)

    from densephrases_tpu_torch.eval.kilt import (
        evaluate_kilt, results_to_kilt_predictions)

    dp, _ = _common.build_tiny_model(args.workdir, args.load_dir,
                                     device=device,
                                     vocab_kind=args.vocab_kind)

    # KILT slot-filling records: subject [SEP] relation -> object
    records = [
        ("Marie Curie [SEP] discovered", ["polonium", "radium"],
         ["Marie Curie"]),
        ("Ada Lovelace [SEP] collaborator", ["Charles Babbage"],
         ["Ada Lovelace"]),
        ("Alan Turing [SEP] created", ["Turing machine"], ["Alan Turing"]),
    ]
    queries = [r[0] for r in records]
    title2wikiid = {d["title"]: str(i)
                    for i, d in enumerate(_common.TINY_WIKI)}
    # gold rows in the shape load_kilt_data produces from official jsonl
    golds = [{"answers": list(r[1]),
              "provenance": [[title2wikiid[t] for t in r[2]]]}
             for r in records]

    qvec = dp.query2vec(queries)
    results = dp.mips.search(qvec, q_texts=queries, top_k=args.top_k,
                             aggregate=True, agg_strat="opt4")
    preds = results_to_kilt_predictions(results, title2wikiid)
    metrics = evaluate_kilt(preds, golds)
    print("slot-filling metrics:", metrics)
    filled = []
    for q, res in zip(queries, results):
        top = res[0] if res else {}
        print(f"  {q!r} -> {top.get('answer')!r} "
              f"(title {top.get('title')})")
        filled.append((q, top.get("answer"), top.get("title")))
    return metrics, filled


if __name__ == "__main__":
    main()
