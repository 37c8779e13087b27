"""Runnable knowledge-grounded dialogue example (Wizard-of-Wikipedia shape).

The counterpart of ``examples/knowledge-dialogue/run.py``. The query is
the dialogue history (last turns joined); retrieval grounds the next
utterance, scored with R-Precision / Recall@5 over provenance (the
reference's knowledge-dialogue example).

Usage: python -m densephrases_tpu_torch.examples.knowledge_dialogue [--cpu]
           [--load_dir DIR]
           [--vocab_kind wordpiece|whole_word]
"""

from __future__ import annotations

import argparse
import sys

from densephrases_tpu_torch.examples import _common


def main(argv=None, device="cuda"):
    """Returns (metrics, [(query, grounding title)])."""
    argv, device = _common.parse_device(
        sys.argv[1:] if argv is None else argv, device)
    ap = argparse.ArgumentParser()
    ap.add_argument("--load_dir", default="")
    ap.add_argument("--workdir",
                    default=_common.default_workdir("dph_dialogue"))
    ap.add_argument("--top_k", type=int, default=5)
    _common.add_vocab_arg(ap)
    args = ap.parse_args(argv)

    from densephrases_tpu_torch.eval.kilt import (
        evaluate_kilt, results_to_kilt_predictions)

    dp, _ = _common.build_tiny_model(args.workdir, args.load_dir,
                                     device=device,
                                     vocab_kind=args.vocab_kind)

    # WoW-style: dialogue history -> the knowledge sentence's page
    dialogues = [
        (["I love the history of computing.",
          "Who wrote the first computer program?"], ["Ada Lovelace"]),
        (["Tell me about famous physicists.",
          "Who developed relativity?"], ["Albert Einstein"]),
        (["We were discussing DNA imaging.",
          "Who captured Photo 51?"], ["Rosalind Franklin"]),
    ]
    queries = [" [SEP] ".join(turns) for turns, _ in dialogues]
    title2wikiid = {d["title"]: str(i)
                    for i, d in enumerate(_common.TINY_WIKI)}
    golds = [{"answers": [], "provenance": [[title2wikiid[t] for t in gold]]}
             for _, gold in dialogues]

    qvec = dp.query2vec(queries)
    results = dp.mips.search(qvec, q_texts=queries, top_k=args.top_k,
                             aggregate=True, agg_strat="opt2")  # passages
    preds = results_to_kilt_predictions(results, title2wikiid)
    metrics = evaluate_kilt(preds, golds, k=args.top_k)
    print("knowledge-dialogue metrics:", metrics)
    grounded = []
    for q, res in zip(queries, results):
        top = res[0] if res else {}
        print(f"  {q[:48]!r} -> grounded on {top.get('title')!r}")
        grounded.append((q, top.get("title")))
    return metrics, grounded


if __name__ == "__main__":
    main()
