"""Shared CLI plumbing: encoder/tokenizer loading and saving for the drivers.

The counterpart of ``densephrases_tpu/cli/common.py`` with an explicit
device. A save directory holds ``config.json``, ``vocab.txt`` and
``params/step_0`` in the port's checkpoint format (``utils/checkpoint.py``);
``load_encoder`` also reads a directory that holds a torch
``pytorch_model.bin`` (HF / the reference's released DensePhrases keys,
``models/hf_import.py``) instead of ``params/``. A JAX package save (orbax)
is refused with an error that names ``convert_jax_checkpoint.py``, which
writes this format from it where jax is installed.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Optional, Tuple

import torch

from densephrases_tpu_torch.data.tokenization import (
    WordPieceTokenizer,
    train_wordpiece_vocab,
)
from densephrases_tpu_torch.models.bert import BertConfig
from densephrases_tpu_torch.models.encoder import (
    EncoderParams,
    init_encoder_params,
)
from densephrases_tpu_torch.parallel import rank_and_size
from densephrases_tpu_torch.utils.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
)
from densephrases_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

logging.basicConfig(
    format="%(asctime)s - %(levelname)s - %(name)s - %(message)s",
    datefmt="%m/%d/%Y %H:%M:%S", level=logging.INFO)


def load_config(load_dir: str) -> BertConfig:
    cfg_path = os.path.join(load_dir, "config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            raw = json.load(f)
        fields = {k: v for k, v in raw.items() if k in BertConfig.__dataclass_fields__}
        return BertConfig(**fields)
    return BertConfig()


def save_encoder(save_dir: str, params, config: BertConfig,
                 tokenizer: WordPieceTokenizer):
    """params: an ``EncoderParams`` or its state dict. Under a process
    group of several ranks every rank calls this, rank 0 alone writes and
    all wait until it has (``save_checkpoint``)."""
    if rank_and_size()[0] == 0:
        os.makedirs(save_dir, exist_ok=True)
        with open(os.path.join(save_dir, "config.json"), "w") as f:
            json.dump(config.__dict__, f)
        tokenizer.save_vocab(os.path.join(save_dir, "vocab.txt"))
    save_checkpoint(os.path.join(save_dir, "params"), params, step=0)


def load_encoder(load_dir: str = "", draft: bool = False, seed: int = 42,
                 device="cuda"
                 ) -> Tuple[EncoderParams, BertConfig, Optional[WordPieceTokenizer]]:
    """Load (params, config, tokenizer) from a save dir onto ``device``, or
    fresh-init when no dir is given (then the tokenizer is None)."""
    device = resolve_device(device)
    if load_dir and os.path.isdir(load_dir):
        config = load_config(load_dir)
        tokenizer = WordPieceTokenizer.from_vocab_file(
            os.path.join(load_dir, "vocab.txt"))
        ckpt_dir = os.path.join(load_dir, "params")
        if os.path.isdir(ckpt_dir):
            params = restore_checkpoint(ckpt_dir,
                                        EncoderParams(config).to(device))
        else:
            # torch checkpoint (HF / DensePhrases released weights)
            from densephrases_tpu_torch.models.from_jax import encoder_from_jax
            from densephrases_tpu_torch.models.hf_import import (
                load_encoder_from_torch)

            tree = load_encoder_from_torch(
                os.path.join(load_dir, "pytorch_model.bin"), config)
            params = encoder_from_jax(tree, config, device=device)
        return params, config, tokenizer
    config = BertConfig.tiny() if draft else BertConfig()
    logger.warning("no load_dir: fresh random init (%s)",
                   "tiny draft config" if draft else "bert-base config")
    params = init_encoder_params(config, torch.Generator().manual_seed(seed),
                                 device=device)
    return params, config, None


def ensure_tokenizer(tokenizer, corpus_texts, vocab_size: int = 8000,
                     save_path: Optional[str] = None) -> WordPieceTokenizer:
    if tokenizer is not None:
        return tokenizer
    logger.info("training WordPiece vocab (%d) from corpus", vocab_size)
    return train_wordpiece_vocab(corpus_texts, vocab_size=vocab_size,
                                 save_path=save_path)
