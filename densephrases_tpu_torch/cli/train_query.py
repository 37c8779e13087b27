"""Query-side fine-tuning driver.

The counterpart of ``densephrases_tpu/cli/train_query.py`` (ref
train_query.py:278-307) with an explicit device: load the encoder, the
store and the index (``cli/eval_phrase_retrieval.load_model``), train the
query towers with retrieval in the loop, keep the best-dev towers and save
the encoder.

Usage:
  python -m densephrases_tpu_torch.cli.train_query --load_dir enc/ \\
      --dump_dir dump/ --index_name start/1048576_flat_OPQ96 \\
      --train_file nq_train.json --dev_file nq_dev.json --output_dir out/ \\
      [--qsft_top_k 100]
"""

from __future__ import annotations

import logging

from densephrases_tpu_torch.cli.common import save_encoder
from densephrases_tpu_torch.cli.eval_phrase_retrieval import load_model
from densephrases_tpu_torch.data.qa import load_qa_pairs
from densephrases_tpu_torch.options import Options
from densephrases_tpu_torch.train.query import (
    QueryFTConfig,
    train_query_encoder,
)
from densephrases_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


def main(argv=None, device="cuda"):
    """Returns the training history (``train_query_encoder``'s)."""
    device = resolve_device(device)
    opts = Options().parse(
        argv, groups=["model", "index", "retrieval", "qsft", "data", "train"])
    q, r, d = opts.qsft, opts.retrieval, opts.data

    model = load_model(opts, device=device)
    _, questions, answers = load_qa_pairs(
        r.test_path or d.train_file, draft=opts.draft, truecase=model.truecase)
    train_pairs = list(zip(questions, answers))
    dev_pairs = None
    if d.dev_file:
        _, dq, da = load_qa_pairs(d.dev_file, draft=opts.draft,
                                  truecase=model.truecase)
        dev_pairs = list(zip(dq, da))

    cfg = QueryFTConfig(
        top_k=q.qsft_top_k, learning_rate=q.qsft_learning_rate,
        epochs=q.qsft_epochs, regex=r.regex, label_strat=q.label_strat,
        update_freq=q.update_freq,
        max_answer_length=opts.model.max_answer_length)
    _, history = train_query_encoder(
        model, train_pairs, cfg,
        batch_size=opts.train.per_device_train_batch_size,
        dev_pairs=dev_pairs, eval_top_k=r.top_k, seed=opts.train.seed,
        rng_impl=opts.train.rng_impl)
    logger.info("history: %s", history)

    if opts.model.output_dir:
        save_encoder(opts.model.output_dir, model.params, model.config,
                     model.tokenizer)
        logger.info("saved query-FT model to %s", opts.model.output_dir)
    return history


if __name__ == "__main__":
    main()
