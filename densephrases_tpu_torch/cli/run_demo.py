"""Serving driver: query-encoder server, index server, reader, or the
benchmark client.

The counterpart of ``densephrases_tpu/cli/run_demo.py`` (ref
run_demo.py:358-425) with an explicit device. ``--demo_mode``:

- ``q_serve`` / ``serve_query``: the query-encoder service on
  ``--query_port``;
- ``p_serve``: the index service on ``--index_port``, its query vectors
  from a ``q_serve`` process on this host (two-process mode);
- ``single_serve`` / ``serve``: the index service with the encoder in
  this process;
- ``serve_bert``: the single-passage reader on ``--index_port``, a
  cross-encoder (``cli.train_cross_encoder``'s output) read from
  ``--load_dir``;
- ``eval_request``: EM@1 and Q/sec of ``--test_path`` against a running
  index service.

The servers serve one request at a time (``serve/server.py``).

Usage:
  python -m densephrases_tpu_torch.cli.run_demo --demo_mode single_serve \\
      --load_dir enc/ --dump_dir dump/ --index_port 10002
  python -m densephrases_tpu_torch.cli.run_demo --demo_mode eval_request \\
      --test_path nq.json --index_port 10002
"""

from __future__ import annotations

import logging
import os

import torch

from densephrases_tpu_torch.cli.common import load_config
from densephrases_tpu_torch.cli.eval_phrase_retrieval import load_model
from densephrases_tpu_torch.data.qa import load_qa_pairs
from densephrases_tpu_torch.data.tokenization import WordPieceTokenizer
from densephrases_tpu_torch.options import Options
from densephrases_tpu_torch.serve.server import (
    RemoteQueryEncoder,
    eval_request,
    make_index_app,
    make_query_encoder_app,
    make_reader_app,
    serve,
)
from densephrases_tpu_torch.train.cross_encoder import init_cross_params
from densephrases_tpu_torch.utils.checkpoint import restore_checkpoint
from densephrases_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


def main(argv=None, device="cuda"):
    device = resolve_device(device)
    opts = Options().parse(
        argv, groups=["model", "index", "retrieval", "demo", "data"])
    mode = opts.demo.demo_mode

    if mode in ("q_serve", "serve_query"):
        model = load_model(opts, device=device)
        serve(make_query_encoder_app(model), opts.demo.query_port)
    elif mode == "p_serve":
        # two-process mode: this process holds the index; query encoding is
        # RPC'd to a q_serve process (ref: run_demo.py:278-316)
        model = load_model(opts, device=device)
        remote = RemoteQueryEncoder("127.0.0.1", opts.demo.query_port)
        serve(make_index_app(model, default_top_k=opts.retrieval.top_k,
                             remote_encoder=remote),
              opts.demo.index_port)
    elif mode in ("single_serve", "serve"):
        model = load_model(opts, device=device)
        serve(make_index_app(model, default_top_k=opts.retrieval.top_k),
              opts.demo.index_port)
    elif mode == "serve_bert":
        # single-passage reader service (ref: run_demo.py:151-272). The
        # reference loads the directory as an encoder first, which fails on
        # the teacher that train_cross_encoder saves; the port reads that
        # save's config and vocab, then restores its cross-encoder
        load_dir = opts.model.load_dir
        config = load_config(load_dir)
        tokenizer = WordPieceTokenizer.from_vocab_file(
            os.path.join(load_dir, "vocab.txt"))
        template = init_cross_params(config, torch.Generator().manual_seed(0),
                                     device=device)
        params = restore_checkpoint(os.path.join(load_dir, "params"),
                                    template)
        serve(make_reader_app(params, config, tokenizer),
              opts.demo.index_port)
    elif mode == "eval_request":
        _, questions, answers = load_qa_pairs(opts.retrieval.test_path,
                                              draft=opts.draft)
        metrics = eval_request(
            "127.0.0.1", opts.demo.index_port,
            list(zip(questions, answers)),
            batch_size=opts.retrieval.eval_batch_size,
            top_k=opts.retrieval.top_k)
        logger.info("metrics: EM@1=%.2f qps=%.1f",
                    metrics["em_top1"], metrics["qps"])
        return metrics
    else:
        raise SystemExit(f"unknown demo_mode {mode}")


if __name__ == "__main__":
    main()
