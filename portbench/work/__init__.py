"""Operations and bytes by layer and kernel, and the card's peaks: the
yardstick of the roofline shares and of ``step_mfu``.

Copied from the port's measurement tools so that a change to the program
cannot move it: the peaks and ``least_s`` from
``densephrases_tpu_torch/tools/_bench.py`` (``bound``), kernel A's count
from ``chip_smoke.py:attention_bound`` and kernel D's from
``chip_smoke.py:check_ivf_kernel``. Each input byte counts once as read and
each output byte once as written.
"""

from __future__ import annotations

# NVIDIA H100 SXM, dense: HBM3 bytes/s and tensor-core / CUDA-core ops/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}


def least_s(ops: float, nbytes: float, kind: str = "bfloat16") -> float:
    """The least time the card could take: the larger of the operations
    at the peak rate of ``kind`` and the bytes at the memory's."""
    return max(ops / PEAK_OPS_PER_S[kind], nbytes / PEAK_BYTES_PER_S)


def attention_fwd(b: int, h: int, l: int, d: int, esize: int = 2):
    """Kernel A on [b, h, l, d]: (ops, bytes). 4·b·h·l²·d operations
    (QKᵀ and PV); q, k, v and the output once each, and the fp32 [b, l]
    mask."""
    return 4 * b * h * l * l * d, 4 * b * h * l * d * esize + 4 * b * l


def bert_forward_flops(model: dict, b: int, l: int) -> int:
    """Multiply-adds ×2 of one BERT tower's forward over [b, l] tokens: per
    layer the q, k, v and output projections (4·h²), the feed-forward
    (2·h·f) and attention's two products (2·l·h a token)."""
    h, f = model["hidden_size"], model["intermediate_size"]
    per_token = 2 * (4 * h * h + 2 * h * f) + 4 * l * h
    return model["num_hidden_layers"] * b * l * per_token


def rescore_flops(b: int, k: int, max_len: int, d: int) -> int:
    """Stage 2: each of 2k hits scores max_len candidate rows a query."""
    return 2 * (2 * b * k * max_len * d)


def flat_scan(q_rows: int, n: int, d: int):
    """The flat int8 scan of q_rows query vectors over n rows: (ops,
    bytes), the corpus read once."""
    return 2 * q_rows * n * d, n * d


def ivf_probe_flops(q_rows: int, nlist: int, d: int) -> int:
    return 2 * q_rows * nlist * d


def pq_scan(q_rows: int, rows: int, m: int, ksub: int, entries: int):
    """Kernel D over ``rows`` valid rows named by ``entries`` block-table
    entries: (ops, bytes). q_rows·m fp32 adds a row; the rows' m code
    bytes, the bf16 LUTs [q_rows, m, ksub], the int32 block table and the
    fp32 scores of the valid columns."""
    ops = q_rows * rows * m
    nbytes = (rows * m + 2 * q_rows * m * ksub + 4 * entries
              + 4 * q_rows * rows)
    return ops, nbytes


def refine_flops(q_rows: int, cands: int, d: int) -> int:
    return 2 * q_rows * cands * d
