"""Runnable custom-index example: build a phrase index over an articles
file and answer a questions file (the reference's create-custom-index
walkthrough, self-contained; a tiny encoder is made from scratch when no
``--load_dir`` is given, since no pretrained weights ship here).

The counterpart of ``examples/create-custom-index/run.py``.

Usage:
  python -m densephrases_tpu_torch.examples.create_custom_index \\
      --articles articles.json --questions questions.json \\
      [--load_dir trained_encoder/] [--workdir DIR] [--cpu]
      [--vocab_kind wordpiece|whole_word]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from densephrases_tpu_torch.examples import _common


def main(argv=None, device="cuda"):
    """Returns [(question, gold answers, top-k answers)]."""
    argv, device = _common.parse_device(
        sys.argv[1:] if argv is None else argv, device)
    ap = argparse.ArgumentParser()
    ap.add_argument("--articles", required=True)
    ap.add_argument("--questions", required=True)
    ap.add_argument("--load_dir", default="")
    ap.add_argument("--workdir",
                    default=_common.default_workdir("custom_index"))
    ap.add_argument("--top_k", type=int, default=5)
    _common.add_vocab_arg(ap)
    args = ap.parse_args(argv)

    import torch

    from densephrases_tpu_torch import DensePhrases, MIPS
    from densephrases_tpu_torch.cli.common import load_encoder
    from densephrases_tpu_torch.data.tokenization import build_vocab
    from densephrases_tpu_torch.dump import dump_phrases
    from densephrases_tpu_torch.models.bert import BertConfig
    from densephrases_tpu_torch.models.encoder import init_encoder_params

    with open(args.articles) as f:
        arts = json.load(f)["data"]
    docs = [{"doc_id": i, "title": a["title"],
             "paragraphs": [p["context"] for p in a["paragraphs"]]}
            for i, a in enumerate(arts)]
    print(f"{len(docs)} documents")

    if args.load_dir:
        params, config, tokenizer = load_encoder(args.load_dir, device=device)
    else:
        print("no --load_dir: tiny from-scratch encoder (smoke-test quality)")
        texts = [p for d in docs for p in d["paragraphs"]]
        tokenizer = build_vocab(texts, vocab_size=4000,
                                kind=args.vocab_kind)
        config = BertConfig.tiny(vocab_size=tokenizer.vocab_size)
        params = init_encoder_params(config, torch.Generator().manual_seed(0),
                                     device=device)

    store = dump_phrases(params, config, tokenizer, docs,
                         os.path.join(args.workdir, "store"),
                         max_seq_length=min(
                             128, config.max_position_embeddings))
    print(f"store: {store.num_docs} docs / {store.n_vecs} phrase vectors")

    dp = DensePhrases(params, config, tokenizer,
                      MIPS(store, device=params.device), max_query_length=32)
    with open(args.questions) as f:
        questions = json.load(f)["data"]
    out = []
    for row in questions:
        answers = dp.search(row["question"], retrieval_unit="phrase",
                            top_k=args.top_k)
        print(f"\nQ: {row['question']}")
        print(f"   gold: {row.get('answers')}")
        print(f"   top-{args.top_k}: {answers}")
        out.append((row["question"], row.get("answers"), answers))
    return out


if __name__ == "__main__":
    main()
