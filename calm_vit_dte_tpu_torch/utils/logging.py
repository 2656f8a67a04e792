"""Metrics logging and per-step timing.

JAX counterpart: calm_vit_dte_tpu/utils/logging.py. The reference's
observability is a rank-0 print every 100 batches (distributed_trainer_cls.py
:103-104); kept at the same cadence, plus optional JSONL metrics and host
clock step times with their median.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch


def is_chief() -> bool:
    """Rank 0 of an initialized torch.distributed group, else True (one
    process)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


class MetricLogger:
    def __init__(self, log_every: int = 100, jsonl_path: str | None = None):
        self.log_every = log_every
        self.jsonl_path = jsonl_path
        self.step_times: list[float] = []
        self._last = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self.step_times.append(now - self._last)
        self._last = now

    def p50_step_time(self) -> float | None:
        if not self.step_times:
            return None
        return float(np.percentile(self.step_times, 50))

    def log(self, epoch: int, step: int, metrics: dict) -> None:
        """Print the 0-d metrics every `log_every` steps (reading them waits
        for the device)."""
        if not is_chief() or step % self.log_every != 0:
            return
        vals = {k: float(v) for k, v in metrics.items() if np.ndim(v) == 0}
        msg = ", ".join(f"{k}: {v:.6g}" for k, v in vals.items())
        print(f"Epoch: {epoch + 1}, Batch: {step + 1}, {msg}", flush=True)
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps({"epoch": epoch, "step": step, **vals})
                        + "\n")
