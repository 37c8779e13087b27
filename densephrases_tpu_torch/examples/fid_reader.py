"""Runnable FiD-reader export example.

The counterpart of ``examples/fid-reader/run.py``. Retrieves passages,
reports DPR-style has-answer recall@k, and writes the Fusion-in-Decoder
reader input file with ``<e>phrase</e>`` markers (the reference's
fusion-in-decoder example; ``eval_phrase_retrieval``'s passage mode).

Usage: python -m densephrases_tpu_torch.examples.fid_reader [--cpu]
           [--load_dir DIR]
           [--vocab_kind wordpiece|whole_word]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from densephrases_tpu_torch.examples import _common


def main(argv=None, device="cuda"):
    """Returns (passage recall metrics, the FiD rows written)."""
    argv, device = _common.parse_device(
        sys.argv[1:] if argv is None else argv, device)
    ap = argparse.ArgumentParser()
    ap.add_argument("--load_dir", default="")
    ap.add_argument("--workdir", default=_common.default_workdir("dph_fid"))
    ap.add_argument("--top_k", type=int, default=5)
    _common.add_vocab_arg(ap)
    args = ap.parse_args(argv)

    from densephrases_tpu_torch.eval.passage import (
        evaluate_passages, to_fid_format)

    dp, _ = _common.build_tiny_model(args.workdir, args.load_dir,
                                     device=device,
                                     vocab_kind=args.vocab_kind)

    questions = [
        "Who discovered radium?",
        "Who wrote the first computer program?",
        "Who broke the Enigma code?",
    ]
    answers = [["Marie Curie"], ["Ada Lovelace"], ["Alan Turing"]]

    qvec = dp.query2vec(questions)
    results = dp.mips.search(qvec, q_texts=questions, top_k=args.top_k,
                             aggregate=True, agg_strat="opt2")  # passages

    metrics = evaluate_passages(results, answers, ks=(1, args.top_k))
    print("passage recall:", metrics)

    out_path = os.path.join(args.workdir, "fid_input.json")
    to_fid_format(questions, answers, results, mark_phrase=True,
                  out_path=out_path)
    with open(out_path) as f:
        rows = json.load(f)
    print(f"wrote {out_path}: {len(rows)} rows, "
          f"{len(rows[0]['ctxs'])} ctxs each")
    print("first ctx:", json.dumps(rows[0]["ctxs"][0])[:120])
    return metrics, rows


if __name__ == "__main__":
    main()
