"""Phrase dump driver.

The counterpart of ``densephrases_tpu/cli/generate_phrase_vecs.py`` (ref
generate_phrase_vecs.py:150-227 main(--do_dump)) with an explicit device:
the same flags, file-range sharding "start:end" over the sorted files of
``--data_dir``, resume, and a SQuAD-format corpus (one or many files). The
phrase tower runs on ``device``; a CUDA device that is missing raises.

Usage (``--device``, default "cuda", names the card of a process run
from the command line):
  python -m densephrases_tpu_torch.cli.generate_phrase_vecs \\
      --load_dir enc/ --data_dir wiki/ --predict_file 0:100 \\
      --dump_dir dump/ [--index_filter 1.0] [--device cuda:1]
"""

from __future__ import annotations

import logging
import os

from densephrases_tpu_torch.cli.common import ensure_tokenizer, load_encoder
from densephrases_tpu_torch.data.qa import load_squad_paragraphs
from densephrases_tpu_torch.dump import dump_phrases
from densephrases_tpu_torch.options import Options
from densephrases_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


def resolve_files(data_dir: str, predict_file: str):
    """predict_file is a filename or a 'start:end' shard range over the
    sorted file list (ref: generate_phrase_vecs.py:57-63)."""
    if ":" in predict_file and not os.path.exists(predict_file):
        start, end = map(int, predict_file.split(":"))
        names = sorted(os.listdir(data_dir))
        return [os.path.join(data_dir, n) for n in names[start:end]]
    path = predict_file if os.path.exists(predict_file) else \
        os.path.join(data_dir, predict_file)
    return [path]


def main(argv=None, device="cuda"):
    device = resolve_device(device)
    opts = Options().parse(argv, groups=["model", "data", "index"])
    m, d, ix = opts.model, opts.data, opts.index

    params, config, tokenizer = load_encoder(m.load_dir, draft=opts.draft,
                                             device=device)

    files = resolve_files(d.data_dir, d.predict_file)
    docs = []
    doc_id = 0
    for path in files:
        for doc in load_squad_paragraphs(path):
            doc["doc_id"] = doc_id
            doc_id += 1
            docs.append(doc)
    if opts.draft:
        docs = docs[:20]
    logger.info("dumping %d docs from %d files", len(docs), len(files))

    tokenizer = ensure_tokenizer(
        tokenizer, [p for doc in docs for p in doc["paragraphs"]])

    store_path = os.path.join(ix.dump_dir, ix.phrase_dir)
    store = dump_phrases(
        params, config, tokenizer, docs, store_path,
        max_seq_length=m.max_seq_length,
        filter_threshold=ix.index_filter,
        offset=ix.dense_offset, scale=ix.dense_scale,
        first_passage=ix.first_passage)
    logger.info("store: %d docs, %d vectors", store.num_docs, store.n_vecs)
    return store


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--device", default="cuda")
    args, rest = ap.parse_known_args()
    main(rest, device=args.device)
