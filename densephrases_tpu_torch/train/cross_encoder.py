"""The cross-encoder (distillation teacher)'s parameters.

The counterpart of ``init_cross_params`` in
``densephrases_tpu/train/cross_encoder.py``: one BERT tower over merged
question + passage inputs (``cross``) and its 2-logit QA head
(``qa_outputs``). For RC distillation they join the student's
``EncoderParams`` as its frozen teacher. The cross-encoder trainer
(``make_cross_train_step``, ``train_cross_encoder``) is not ported.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from densephrases_tpu_torch.models.bert import BertConfig, BertModel
from densephrases_tpu_torch.models.encoder import LinearHead
from densephrases_tpu_torch.utils.device import resolve_device


class CrossParams(nn.Module):
    def __init__(self, config: BertConfig):
        super().__init__()
        self.cross = BertModel(config)
        self.qa_outputs = LinearHead(config.hidden_size, 2)


def init_cross_params(config: BertConfig,
                      generator: Optional[torch.Generator] = None,
                      device="cuda") -> CrossParams:
    """A random fp32 teacher, drawn on the CPU from ``generator`` (seed 0
    when None), then moved to ``device``."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    params = CrossParams(config)
    params.cross.init_weights(generator)
    with torch.no_grad():
        params.qa_outputs.w.copy_(torch.randn(
            params.qa_outputs.w.shape, generator=generator)
            * config.initializer_range)
        params.qa_outputs.b.zero_()
    return params.to(device)
