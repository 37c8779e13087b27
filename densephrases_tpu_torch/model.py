"""DensePhrases facade: the user-facing API.

The counterpart of ``densephrases_tpu/model.py``: ``search`` over retrieval
units phrase / sentence / paragraph / document with the reference's
unit→aggregation-strategy map and 2× over-retrieval for the coarser units
(ref: model.py:76-87), plus ``evaluate``. The query towers run on the
params' device; the MIPS engine must sit on the same device. With a
truecaser (``data/truecase.py``), ``search(truecase=True)`` truecases each
all-lowercase query before encoding it, as the reference does
(model.py:93-97); without one it is a no-op.
"""

from __future__ import annotations

import copy
import logging
from typing import List, Optional, Union

import numpy as np
import torch

from densephrases_tpu_torch.data.features import convert_questions_to_features
from densephrases_tpu_torch.data.tokenization import WordPieceTokenizer
from densephrases_tpu_torch.index.search import MIPS
from densephrases_tpu_torch.models.encoder import (EncoderParams, TowerConfig,
                                                   embed_query)
from densephrases_tpu_torch.utils import profiling

logger = logging.getLogger(__name__)


class DensePhrases:
    """Load an encoder + phrase index and answer queries
    (ref: densephrases/model.py)."""

    UNIT_TO_STRAT = {  # ref: model.py:76-87
        "phrase": "opt1",
        "sentence": "opt2",
        "paragraph": "opt2",
        "document": "opt3",
    }

    def __init__(self, params: EncoderParams, config: TowerConfig,
                 tokenizer: WordPieceTokenizer, mips: MIPS,
                 max_query_length: int = 64, truecase=None,
                 attn_impl: str = "auto", serve_dtype: Optional[str] = None):
        """serve_dtype: None keeps the params' dtype; "bf16" serves from a
        bf16 copy of the weights (the reference's serve_dtype, model.py:54-65;
        the caller's params are not changed)."""
        if serve_dtype is not None:
            if serve_dtype != "bf16":
                raise ValueError(f"serve_dtype must be None or 'bf16', got "
                                 f"{serve_dtype!r}")
            params = copy.deepcopy(params).to(torch.bfloat16)
        if params.device != mips.device:
            raise ValueError(f"params on {params.device}, MIPS on {mips.device}")
        self.params = params
        self.config = config
        self.tokenizer = tokenizer
        self.mips = mips
        self.max_query_length = max_query_length
        self.truecase = truecase
        self.attn_impl = attn_impl

    def encode(self, queries: List[str]):
        """Tokenize + both query towers → (query_start, query_end) [B, H]
        device tensors."""
        with profiling.span("towers.tokenize"):
            feats = convert_questions_to_features(
                queries, self.tokenizer, self.max_query_length)
            host = [np.stack([getattr(f, k) for f in feats])
                    for k in ("input_ids", "attention_mask",
                              "token_type_ids")]
        if profiling.active():
            profiling.count("towers.tokens_real", int(host[1].sum()))
            profiling.count("towers.tokens_padded", host[1].size)
        with profiling.span("towers.upload"):  # pageable: may wait
            ids, am, tt = (torch.as_tensor(a, device=self.params.device)
                           for a in host)
        with profiling.span("towers.forward"):
            return embed_query(self.params, ids, am, tt,
                               attn_impl=self.attn_impl)

    def _truecased(self, queries: List[str]) -> List[str]:
        """Each all-lowercase query truecased (ref: model.py:93-97); the
        queries as they are without a truecaser. ``search`` and
        ``FusedServer.submit`` both call it."""
        if self.truecase is None:
            return queries
        return [q if q != q.lower() else self.truecase.get_true_case(q)
                for q in queries]

    # ----- query encoding (ref: open_utils.py:83-101 query2vec) -----
    def query2vec(self, queries: List[str]):
        """[B, 2H] query vectors as a DEVICE tensor."""
        qs, qe = self.encode(queries)
        return torch.cat([qs, qe], 1)

    # ----- search (ref: model.py:55-109) -----
    def search(self, query: Union[str, List[str]], retrieval_unit: str = "phrase",
               top_k: int = 10, truecase: bool = True,
               return_meta: bool = False, max_answer_length: int = 10):
        with profiling.request():
            single = isinstance(query, str)
            queries = [query] if single else list(query)
            if truecase:
                queries = self._truecased(queries)

            if retrieval_unit not in self.UNIT_TO_STRAT:
                raise NotImplementedError(f"unknown retrieval unit {retrieval_unit}")
            agg_strat = self.UNIT_TO_STRAT[retrieval_unit]
            # 2x over-retrieval for coarser units (ref: model.py:79-81)
            search_top_k = top_k if retrieval_unit == "phrase" else top_k * 2

            query_vec = self.query2vec(queries)
            rets = self.mips.search(
                query_vec, q_texts=queries, top_k=search_top_k, aggregate=True,
                agg_strat=agg_strat, return_sent=(retrieval_unit == "sentence"),
                max_answer_length=max_answer_length,
            )
            if retrieval_unit == "phrase":
                answers = [[r["answer"] for r in ret[:top_k]] for ret in rets]
            elif retrieval_unit in ("sentence", "paragraph"):
                answers = [[r["context"] for r in ret[:top_k]] for ret in rets]
            else:  # document
                answers = [[r["title"][0] for r in ret[:top_k]] for ret in rets]
            rets = [ret[:top_k] for ret in rets]

            if single:
                answers, rets = answers[0], rets[0]
            return (answers, rets) if return_meta else answers

    def evaluate(self, qa_pairs, top_k: int = 10, regex: bool = False,
                 max_answer_length: int = 10):
        """qa_pairs: list of (question, [answers]). Returns metrics dict
        (ref: model.py:118-128 delegating to eval_phrase_retrieval)."""
        from densephrases_tpu_torch.eval.retrieval import evaluate_retrieval
        return evaluate_retrieval(self, qa_pairs, top_k=top_k, regex=regex,
                                  max_answer_length=max_answer_length)
