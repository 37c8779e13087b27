"""densephrases_tpu_torch — the phrase index-and-query engine on PyTorch + CUDA.

The port of ``densephrases_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA
Hopper GPU. Module paths and names mirror the JAX package, which stays
beside it as the reference the port is tested against. This package never
imports jax or ``densephrases_tpu``; the framework-free host modules are
copies (``data/``, ``eval/``, ``index/store.py``, ``options.py``).

The public surface is the reference's (``Options``, ``PhraseEncoder`` /
``Encoder``, ``MIPS``, ``DensePhrases``) and the index classes:

  - ``Options``        — the config registry (``options.py``, a host copy)
  - ``PhraseEncoder``  — BERT phrase/query towers (``models/``), with the
    attention forward and backward as hand-written CUDA kernels (``csrc/``)
  - ``IVFIndex``       — IVF-SQ8/SQ4/PQ/OPQ build (two-level k-means at
    reference scale), save, load and search (``index/ivf.py``), its list
    scans as CUDA kernels (``csrc/``)
  - ``TieredIVF``, ``TieredFlatIndex`` — serving from host memory for a
    corpus larger than the card (``index/tiered.py``)
  - ``MIPS``           — flat or IVF MIPS + span rescore (``index/``)
  - ``DensePhrases``   — the user-facing facade (``model.py``)
  - ``dump_phrases``   — the phrase dump into the reference's store format
  - ``FusedServer``    — the serve path with one sync point (``serve/``)
  - ``cli.train_rc``   — the RC training driver over ``train/rc.py`` and
    ``models/encoder.py:rc_loss``
"""

from densephrases_tpu_torch.options import Options
from densephrases_tpu_torch.models.encoder import PhraseEncoder
from densephrases_tpu_torch.index.ivf import IVFConfig, IVFIndex
from densephrases_tpu_torch.index.search import MIPS
from densephrases_tpu_torch.model import DensePhrases

Encoder = PhraseEncoder  # reference-compatible alias

__version__ = "0.1.0"
__all__ = ["Options", "PhraseEncoder", "Encoder", "IVFConfig", "IVFIndex",
           "MIPS", "DensePhrases"]
