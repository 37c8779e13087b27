"""Cross-encoder (teacher) training driver.

The counterpart of ``densephrases_tpu/cli/train_cross_encoder.py`` (ref
train_cross_encoder.py main flow) with an explicit device: SQuAD fine-
tuning of the teacher whose weights feed RC distillation
(``train_rc --lambda_kl > 0 --teacher_dir``). The config and vocab come
from ``--load_dir`` (or a fresh config and a trained vocab); the teacher
starts from ``init_cross_params`` seeded with ``--seed``. The output dir
holds ``config.json``, ``vocab.txt`` and ``params/`` (the teacher's
``cross`` and ``qa_outputs``).

Usage:
  python -m densephrases_tpu_torch.cli.train_cross_encoder \\
      --train_file squad.json --output_dir teacher/ [--draft]
"""

from __future__ import annotations

import json
import logging
import os

from densephrases_tpu_torch.cli.common import ensure_tokenizer, load_config
from densephrases_tpu_torch.data.qa import load_rc_examples
from densephrases_tpu_torch.data.rc_dataset import convert_rc_examples
from densephrases_tpu_torch.data.tokenization import WordPieceTokenizer
from densephrases_tpu_torch.models.bert import BertConfig
from densephrases_tpu_torch.options import Options
from densephrases_tpu_torch.train.cross_encoder import train_cross_encoder
from densephrases_tpu_torch.utils.checkpoint import save_checkpoint
from densephrases_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


def main(argv=None, device="cuda"):
    """Returns (the trained ``CrossParams``, the loss of every step)."""
    device = resolve_device(device)
    opts = Options().parse(argv, groups=["model", "data", "train"])
    m, d, t = opts.model, opts.data, opts.train

    # the reference loads the whole encoder here and uses its config and
    # vocab only; the port reads just those two
    if m.load_dir and os.path.isdir(m.load_dir):
        config = load_config(m.load_dir)
        tokenizer = WordPieceTokenizer.from_vocab_file(
            os.path.join(m.load_dir, "vocab.txt"))
    else:
        config = BertConfig.tiny() if opts.draft else BertConfig()
        tokenizer = None
    examples = load_rc_examples(d.train_file, draft=opts.draft)
    tokenizer = ensure_tokenizer(
        tokenizer, [e["context"] for e in examples[:5000]],
        vocab_size=config.vocab_size,
        save_path=os.path.join(m.output_dir, "vocab.txt") if m.output_dir else None)

    feats = convert_rc_examples(
        examples, tokenizer, max_seq_length=m.max_seq_length,
        doc_stride=m.doc_stride, max_query_length=m.max_query_length,
        with_teacher=True,
        max_cross_length=min(m.max_seq_length + m.max_query_length,
                             config.max_position_embeddings))
    logger.info("training teacher on %d features", len(feats))

    cross_params, losses = train_cross_encoder(
        config, feats, epochs=int(t.num_train_epochs),
        batch_size=t.per_device_train_batch_size, lr=t.learning_rate,
        seed=t.seed, rng_impl=t.rng_impl, device=device, remat=t.remat)

    if m.output_dir:
        os.makedirs(m.output_dir, exist_ok=True)
        with open(os.path.join(m.output_dir, "config.json"), "w") as f:
            json.dump(config.__dict__, f)
        tokenizer.save_vocab(os.path.join(m.output_dir, "vocab.txt"))
        save_checkpoint(os.path.join(m.output_dir, "params"), cross_params,
                        step=0)
        logger.info("teacher saved to %s", m.output_dir)
    return cross_params, losses


if __name__ == "__main__":
    main()
