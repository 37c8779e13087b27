"""Preprocessing driver: corpus construction subcommands.

Host copy of ``densephrases_tpu/cli/preprocess.py``: the port never imports the JAX
package, whose ``__init__`` imports jax. Keep the two in step.

Driver parity with the reference's scripts/preprocess entry points
(build_db.py, build_wikisquad.py, concat_wikisquad.py, create_openqa.py,
compress_metadata.py — the last is inherent to our store format).

Usage:
  python -m densephrases_tpu_torch.cli.preprocess build-db --input extracted/ --db docs.db
  python -m densephrases_tpu_torch.cli.preprocess build-corpus --db docs.db --out corpus/
  python -m densephrases_tpu_torch.cli.preprocess concat --in corpus/ --out corpus_cat/
  python -m densephrases_tpu_torch.cli.preprocess create-openqa --input qa.json \
      --input_type squad --out open.json
  python -m densephrases_tpu_torch.cli.preprocess check-store --store dump/phrase
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

logging.basicConfig(level=logging.INFO)
logger = logging.getLogger(__name__)


def main(argv=None):
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("build-db")
    p.add_argument("--input", required=True)
    p.add_argument("--db", required=True)

    p = sub.add_parser("build-corpus")
    p.add_argument("--db", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--docs_per_file", type=int, default=1000)

    p = sub.add_parser("concat")
    p.add_argument("--in", dest="in_dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--min_words", type=int, default=500)

    p = sub.add_parser("create-openqa")
    p.add_argument("--input", required=True)
    p.add_argument("--input_type", default="squad",
                   choices=["squad", "drqa", "kilt"])
    p.add_argument("--out", required=True)

    p = sub.add_parser("check-store")
    p.add_argument("--store", required=True)

    p = sub.add_parser("store-stats")
    p.add_argument("--store", required=True)

    p = sub.add_parser("train-truecase")
    p.add_argument("--input", required=True,
                   help="cased corpus: squad json or plain text file")
    p.add_argument("--out", required=True)

    args = parser.parse_args(argv)

    if args.cmd == "build-db":
        from densephrases_tpu_torch.preprocess.doc_db import build_db

        n = build_db(args.db, args.input)
        logger.info("inserted %d docs into %s", n, args.db)
    elif args.cmd == "build-corpus":
        from densephrases_tpu_torch.preprocess.wiki import db_to_squad_docs

        n = db_to_squad_docs(args.db, args.out, args.docs_per_file)
        logger.info("wrote %d corpus files to %s", n, args.out)
    elif args.cmd == "concat":
        from densephrases_tpu_torch.preprocess.wiki import concat_small_docs

        n = concat_small_docs(args.in_dir, args.out, args.min_words)
        logger.info("concatenated into %d files", n)
    elif args.cmd == "create-openqa":
        from densephrases_tpu_torch.preprocess.wiki import create_openqa

        if args.input_type == "kilt":
            rows = [json.loads(line) for line in open(args.input)
                    if line.strip()]
        else:
            data = json.load(open(args.input))
            rows = []
            if args.input_type == "squad":
                for art in data["data"]:
                    for par in art["paragraphs"]:
                        rows.extend(par.get("qas", []))
            else:
                rows = data
        n = create_openqa(rows, args.out, args.input_type)
        logger.info("wrote %d open-QA rows", n)
    elif args.cmd == "check-store":
        from densephrases_tpu_torch.tools.store_tools import check_store

        report = check_store(args.store)
        print(json.dumps({k: v for k, v in report.items()}, indent=1))
        sys.exit(0 if report["ok"] else 1)
    elif args.cmd == "store-stats":
        from densephrases_tpu_torch.tools.store_tools import store_stats

        print(json.dumps(store_stats(args.store), indent=1))
    elif args.cmd == "train-truecase":
        # train the ngram truecasing model from a cased corpus
        # (ref ships a prebuilt pickle; densephrases_tpu/data/truecase.py)
        import re

        from densephrases_tpu_torch.data.truecase import TrueCaser

        tc = TrueCaser()
        if args.input.endswith(".json"):
            data = json.load(open(args.input))["data"]
            texts = (p["context"] for art in data for p in art["paragraphs"])
        else:
            texts = (line for line in open(args.input) if line.strip())
        n = 0
        for text in texts:
            tc.train(re.split(r"(?<=[.!?])\s+", text))
            n += 1
        tc.save(args.out)
        logger.info("truecase model trained on %d texts → %s", n, args.out)


if __name__ == "__main__":
    main()
