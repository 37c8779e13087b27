"""Phrase/query encoder towers and the span filter head, for inference.

The counterpart of the inference half of
``densephrases_tpu/models/encoder.py``:

- ``EncoderParams`` holds the three towers (``phrase``, ``query_start``,
  ``query_end``) and the 2-logit ``filter`` head, the reference's params
  dict as one ``nn.Module``;
- ``embed_phrase``: token-wise start = end = last hidden state of the
  phrase tower, plus the filter logits;
- ``embed_query``: the [CLS] hidden state of each query tower. The
  reference runs the two towers as one vmapped forward; here they run as
  two forwards, which gives the same outputs.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from densephrases_tpu_torch.models.bert import BertConfig, BertModel, _param
from densephrases_tpu_torch.utils.device import resolve_device

TOWERS = ("phrase", "query_start", "query_end")


class LinearHead(nn.Module):
    """``x @ w + b`` with ``w`` stored [in, out] (the reference's layout)."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.w = _param(d_in, d_out)
        self.b = _param(d_out)


class EncoderParams(nn.Module):
    def __init__(self, config: BertConfig):
        super().__init__()
        self.config = config
        self.phrase = BertModel(config)
        self.query_start = BertModel(config)
        self.query_end = BertModel(config)
        self.filter = LinearHead(config.hidden_size, 2)

    @property
    def device(self) -> torch.device:
        return self.filter.w.device


def init_encoder_params(config: BertConfig,
                        generator: Optional[torch.Generator] = None,
                        device="cpu") -> EncoderParams:
    """Random fp32 towers. The query towers start as copies of the phrase
    tower (ref: encoder.py:50-52 deepcopy). Drawn on the CPU from
    ``generator`` (seed 0 when None), then moved to ``device``."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    params = EncoderParams(config)
    params.phrase.init_weights(generator)
    state = params.phrase.state_dict()
    params.query_start.load_state_dict(state)
    params.query_end.load_state_dict(state)
    with torch.no_grad():
        params.filter.w.copy_(torch.randn(params.filter.w.shape,
                                          generator=generator)
                              * config.initializer_range)
    return params.to(device)


@torch.no_grad()
def embed_phrase(params: EncoderParams, input_ids, attention_mask,
                 token_type_ids=None, attn_impl: str = "auto",
                 compute_dtype: torch.dtype = torch.bfloat16):
    """Returns (start, end, filter_start_logits, filter_end_logits); start
    and end are the same [B, L, H] fp32 hidden states (ref: encoder.py:92-99)."""
    hidden = params.phrase(input_ids, attention_mask, token_type_ids,
                           attn_impl=attn_impl, compute_dtype=compute_dtype)
    head = params.filter
    flt = hidden @ head.w.to(hidden.dtype) + head.b.to(hidden.dtype)
    return hidden, hidden, flt[..., 0], flt[..., 1]


@torch.no_grad()
def embed_query(params: EncoderParams, input_ids, attention_mask,
                token_type_ids=None, attn_impl: str = "auto",
                compute_dtype: torch.dtype = torch.bfloat16):
    """Returns (query_start [B, H], query_end [B, H]): the [CLS] states of
    the two query towers (ref: encoder.py:101-118)."""
    outs = [tower(input_ids, attention_mask, token_type_ids,
                  attn_impl=attn_impl, compute_dtype=compute_dtype)[:, 0, :]
            for tower in (params.query_start, params.query_end)]
    return outs[0], outs[1]


class PhraseEncoder:
    """Holds (config, params) and mirrors the reference ``Encoder`` surface
    (ref: encoder.py:17-118)."""

    def __init__(self, config: BertConfig, params: Optional[EncoderParams] = None,
                 generator: Optional[torch.Generator] = None, device="cpu"):
        self.config = config
        if params is None:
            params = init_encoder_params(config, generator, device)
        self.params = params

    def embed_phrase(self, input_ids, attention_mask, token_type_ids=None, **kw):
        return embed_phrase(self.params, input_ids, attention_mask,
                            token_type_ids, **kw)

    def embed_query(self, input_ids, attention_mask, token_type_ids=None, **kw):
        return embed_query(self.params, input_ids, attention_mask,
                           token_type_ids, **kw)
