"""Training metrics logging: JSONL ledger + optional wandb.

Host copy of ``densephrases_tpu/utils/metrics_log.py``: the port never imports the JAX
package, whose ``__init__`` imports jax. Keep the two in step.

Observability parity with the reference's Weights & Biases integration
(ref: train_rc.py:476-478,266-275 wandb.init/log) — here the primary sink is
an append-only metrics.jsonl (works offline); wandb attaches when the
package is importable and WANDB_API_KEY is set.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricsLogger:
    def __init__(self, out_dir: Optional[str] = None, project: str = "densephrases-tpu",
                 run_name: Optional[str] = None, use_wandb: bool = False):
        self.path = None
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            self.path = os.path.join(out_dir, "metrics.jsonl")
        self._wandb = None
        if use_wandb:
            try:
                import wandb  # optional; not in this image

                if os.environ.get("WANDB_API_KEY"):
                    self._wandb = wandb
                    wandb.init(project=project, name=run_name)
            except ImportError:
                pass

    def log(self, step: int, **metrics):
        row = {"step": int(step), "time": time.time()}
        row.update({k: float(v) for k, v in metrics.items()})
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(row) + "\n")
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def read(self):
        if not self.path or not os.path.exists(self.path):
            return []
        return [json.loads(line) for line in open(self.path) if line.strip()]
