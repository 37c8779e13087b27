"""The plain reference that decides ``correct``: plain PyTorch in float32
with TF32 off, which imports nothing of the port (nor jax, nor the JAX
package) and takes nothing the port made. The harness hands it the inputs
it made from the seed (vocab, weights, corpus, index arrays) and the port's
served answers, which it only judges.
"""

import torch


def no_tf32() -> None:
    """float32 products in float32: TF32 would be a lower precision than
    the reference states."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
