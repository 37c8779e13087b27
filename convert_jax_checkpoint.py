#!/usr/bin/env python3
"""Convert a JAX package save directory into the PyTorch port's format.

``densephrases_tpu.cli.common.save_encoder`` (and the JAX teacher trainer)
write ``config.json``, ``vocab.txt`` and ``params/step_N`` as an orbax
checkpoint. The port (``densephrases_tpu_torch``) never imports jax or
orbax, and the machines it runs on need not have them, so it cannot read
that checkpoint; its ``load_encoder`` refuses one with an error that names
this script. This script stands outside both packages because it needs
both: it imports jax, orbax and ``densephrases_tpu`` to read the save, and
torch with ``densephrases_tpu_torch`` to write one. Run it where jax is
installed, then copy the output directory to the card's machine.

It reads the save with the JAX package's ``restore_checkpoint`` into a
fresh ``init_encoder_params`` tree (``--kind encoder``) or
``init_cross_params`` tree (``--kind cross``, a teacher from
``train_cross_encoder``), turns the tree into numpy, builds the port's
module on the CPU through ``models/from_jax.py`` (``encoder_from_jax`` or
``cross_from_jax``), and writes it with the port's ``save_encoder``:
``config.json``, ``vocab.txt`` and ``params/step_0/state.pt``.

Usage:
  python convert_jax_checkpoint.py --kind encoder jax_enc/ torch_enc/
  python convert_jax_checkpoint.py --kind cross jax_teacher/ torch_teacher/
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

logger = logging.getLogger("convert_jax_checkpoint")

KINDS = ("encoder", "cross")


def convert(src: str, dst: str, kind: str = "encoder") -> str:
    """Write the port's save of the JAX save at ``src`` into ``dst``;
    returns ``dst``."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    import jax
    import numpy as np

    from densephrases_tpu.cli.common import load_config as jax_load_config
    from densephrases_tpu.utils.checkpoint import restore_checkpoint
    from densephrases_tpu_torch.cli.common import save_encoder
    from densephrases_tpu_torch.data.tokenization import WordPieceTokenizer
    from densephrases_tpu_torch.models.bert import BertConfig
    from densephrases_tpu_torch.models.from_jax import (
        cross_from_jax, encoder_from_jax)

    jax_config = jax_load_config(src)
    if kind == "encoder":
        from densephrases_tpu.models.encoder import init_encoder_params as init
    else:
        from densephrases_tpu.train.cross_encoder import init_cross_params as init
    template = init(jax.random.PRNGKey(0), jax_config)
    params = restore_checkpoint(os.path.join(src, "params"), template)
    tree = jax.tree.map(np.asarray, params)

    config = BertConfig(**jax_config.__dict__)
    build = encoder_from_jax if kind == "encoder" else cross_from_jax
    module = build(tree, config, device="cpu")
    tokenizer = WordPieceTokenizer.from_vocab_file(
        os.path.join(src, "vocab.txt"))
    save_encoder(dst, module, config, tokenizer)
    logger.info("converted %s (%s) → %s", src, kind, dst)
    return dst


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--kind", choices=KINDS, default="encoder",
                        help="encoder: save_encoder's towers; cross: a "
                             "teacher from train_cross_encoder")
    parser.add_argument("src", help="the JAX package's save directory")
    parser.add_argument("dst", help="the port's save directory to write")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    convert(args.src, args.dst, args.kind)
    return 0


if __name__ == "__main__":
    sys.exit(main())
