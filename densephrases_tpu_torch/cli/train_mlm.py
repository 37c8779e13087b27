"""MLM pretraining driver: offline corpus -> pretrained encoder dir.

The counterpart of ``densephrases_tpu/cli/train_mlm.py`` with an explicit
device: the same flags and the same output blob. The output directory is an
encoder save (``cli.common.save_encoder``: config.json / vocab.txt /
params) whose three towers are the pretrained backbone, loadable by every
downstream trainer through ``cli.common.load_encoder``.

The vocab is trained with ``tokenizers`` (``train_wordpiece_vocab``), as in
the reference; ``--vocab_kind whole_word`` takes ``whole_word_vocab``'s
instead, which needs no package.

Run: python -m densephrases_tpu_torch.cli.train_mlm --out /path/enc \\
         [--corpus cache/mlm_corpus.txt] [--steps 20000]
"""

import argparse
import json
import logging
import os
import time

from densephrases_tpu_torch.data.tokenization import VOCAB_KINDS
from densephrases_tpu_torch.utils.device import resolve_device


def main(argv=None, device="cuda"):
    """Returns the output blob (the history included)."""
    device = resolve_device(device)
    logging.basicConfig(level=logging.INFO, force=True,
                        format="%(asctime)s %(name)s: %(message)s")
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True, help="encoder save dir")
    ap.add_argument("--corpus", default=None,
                    help="one-paragraph-per-line text file; default: "
                         "harvest the offline corpus (slow, ~minutes)")
    ap.add_argument("--steps", type=int, default=20000)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=8000)
    ap.add_argument("--vocab_kind", choices=VOCAB_KINDS, default="wordpiece")
    ap.add_argument("--max_pos", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--holdout", type=float, default=0.02)
    ap.add_argument("--hidden_act", default="gelu")
    ap.add_argument("--history_out", default=None,
                    help="optional JSON path for the loss history")
    args = ap.parse_args(argv)

    import torch

    from densephrases_tpu_torch.cli.common import save_encoder
    from densephrases_tpu_torch.data.tokenization import build_vocab
    from densephrases_tpu_torch.models.bert import BertConfig
    from densephrases_tpu_torch.preprocess.offline_corpus import (
        build_corpus,
        load_corpus,
    )
    from densephrases_tpu_torch.train.mlm import (
        encoder_params_from_backbone,
        pretrain_mlm,
    )

    if args.corpus and os.path.exists(args.corpus):
        texts = load_corpus(args.corpus)
    else:
        texts = build_corpus(out_path=args.corpus)
    print(f"corpus: {len(texts)} paragraphs", flush=True)

    tok = build_vocab(texts, vocab_size=args.vocab, kind=args.vocab_kind)
    config = BertConfig(
        vocab_size=tok.vocab_size, hidden_size=args.hidden,
        num_hidden_layers=args.layers, num_attention_heads=args.heads,
        intermediate_size=4 * args.hidden,
        max_position_embeddings=args.max_pos, hidden_act=args.hidden_act)

    t0 = time.perf_counter()
    params, history = pretrain_mlm(
        texts, tok, config, steps=args.steps, batch_size=args.batch,
        seq_len=args.seq, lr=args.lr, seed=args.seed,
        holdout_frac=args.holdout, device=device)
    train_s = round(time.perf_counter() - t0, 1)

    enc = encoder_params_from_backbone(
        params.bert, config, torch.Generator().manual_seed(args.seed))
    save_encoder(args.out, enc, config, tok)
    blob = {"steps": args.steps, "batch": args.batch, "seq": args.seq,
            "lr": args.lr, "train_s": train_s,
            "n_paragraphs": len(texts),
            "loss_first": history["loss"][0] if history["loss"] else None,
            "loss_last": history["loss"][-1] if history["loss"] else None,
            "acc_last": history["acc"][-1] if history["acc"] else None,
            "dev_loss_last": (history["dev_loss"][-1]
                              if history["dev_loss"] else None),
            "history": history}
    hist_path = args.history_out or os.path.join(args.out, "mlm_history.json")
    with open(hist_path, "w") as f:
        json.dump(blob, f, indent=1)
    print(json.dumps({k: v for k, v in blob.items() if k != "history"}))
    return blob


if __name__ == "__main__":
    main()
