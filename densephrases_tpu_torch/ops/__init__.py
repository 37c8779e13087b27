from densephrases_tpu_torch.ops.quant import (
    float_to_int8,
    int8_to_float,
    float_to_int4,
    int4_to_float,
    DEFAULT_OFFSET,
    DEFAULT_SCALE,
)
from densephrases_tpu_torch.ops.topk import topk, topk_merge
