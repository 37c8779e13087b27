"""Index build driver.

The counterpart of ``densephrases_tpu/cli/build_phrase_index.py`` (ref
build_phrase_index.py:341-405 run_index) with an explicit device: one IVF
build on ``device`` from the store under ``--dump_dir``, saved as
``start/{num_clusters}_flat_{fine_quant}`` (ref: :19-44) in the shared save
format. ``--num_clusters`` is capped at a quarter of the store's vectors;
from 8,192 lists (``IVFConfig.two_level_clusters``) the coarse quantizer
is two-level k-means with hierarchical assignment.

Usage:
  python -m densephrases_tpu_torch.cli.build_phrase_index \\
      --dump_dir dump/ --num_clusters 1024 --fine_quant OPQ96
"""

from __future__ import annotations

import logging
import os

import numpy as np

from densephrases_tpu_torch.index.ivf import IVFConfig, IVFIndex
from densephrases_tpu_torch.index.store import PhraseStore
from densephrases_tpu_torch.options import Options
from densephrases_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


def main(argv=None, device="cuda"):
    device = resolve_device(device)
    opts = Options().parse(argv, groups=["index"])
    ix = opts.index

    store_path = os.path.join(ix.dump_dir, ix.phrase_dir)
    store = PhraseStore.load(store_path, mmap=True)
    logger.info("store: %d docs / %d vecs", store.num_docs, store.n_vecs)

    name = f"{ix.num_clusters}_flat_{ix.fine_quant}"
    out_dir = os.path.join(ix.dump_dir, "start", name)
    if os.path.exists(os.path.join(out_dir, "ivf.pkl")):
        logger.info("index exists at %s (use a new name to rebuild)", out_dir)
        return IVFIndex.load(out_dir, device=device)

    cfg = IVFConfig(
        num_clusters=min(ix.num_clusters, max(store.n_vecs // 4, 1)),
        fine_quant=ix.fine_quant if ix.fine_quant != "none" else "SQ8",
        sample_ratio=min(1.0, ix.doc_sample_ratio + ix.vec_sample_ratio),
    )
    index = IVFIndex.build(np.asarray(store.vecs), cfg,
                           offset=store.offset, scale=store.scale,
                           verbose=opts.verbose, device=device)
    index.save(out_dir)
    logger.info("index saved to %s", out_dir)
    return index


if __name__ == "__main__":
    main()
