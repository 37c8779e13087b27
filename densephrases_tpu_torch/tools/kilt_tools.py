"""KILT auxiliary tooling.

Host copy of ``densephrases_tpu/tools/kilt_tools.py``: the port never
imports the JAX package, whose ``__init__`` imports jax. Keep the two
in step.

Parity with ref: scripts/kilt/build_title2wikiid.py (title → wikipedia_id
map over the KILT knowledge source) + prediction stripping/sampling helpers.
"""

from __future__ import annotations

import json
import logging
from typing import Dict, Iterable

logger = logging.getLogger(__name__)


def build_title2wikiid(ks_jsonl_path: str, out_path: str) -> Dict[str, str]:
    """KILT knowledge-source jsonl ({'wikipedia_id', 'wikipedia_title'}) →
    {title: wikipedia_id} json (ref: build_title2wikiid.py)."""
    mapping: Dict[str, str] = {}
    with open(ks_jsonl_path) as f:
        for line in f:
            if not line.strip():
                continue
            row = json.loads(line)
            title = row.get("wikipedia_title") or row.get("title")
            wid = row.get("wikipedia_id") or row.get("id")
            if title and wid is not None:
                mapping[title] = str(wid)
    with open(out_path, "w") as f:
        json.dump(mapping, f)
    logger.info("title2wikiid: %d entries → %s", len(mapping), out_path)
    return mapping


def strip_predictions(pred_jsonl_path: str, out_path: str,
                      keep_keys=("id", "input", "output")) -> int:
    """Strip prediction files to the official submission schema
    (ref: scripts/kilt strip helpers)."""
    n = 0
    with open(pred_jsonl_path) as f, open(out_path, "w") as out:
        for line in f:
            if not line.strip():
                continue
            row = json.loads(line)
            out.write(json.dumps({k: row[k] for k in keep_keys if k in row})
                      + "\n")
            n += 1
    return n


def sample_jsonl(path: str, out_path: str, n: int, seed: int = 0) -> int:
    import random

    rows = [line for line in open(path) if line.strip()]
    rng = random.Random(seed)
    rng.shuffle(rows)
    with open(out_path, "w") as f:
        f.writelines(rows[:n])
    return min(n, len(rows))
