"""Cross-layer latent residual accumulator.

JAX counterpart: calm_vit_dte_tpu/ops/latent_state.py (the reference's
ResidualStateManager). Combine modes:
  "sum"  running sum,
  "sma"  simple moving average (sum / count returned),
  "ema"  momentum = smooth_factor / (count + 1),
  "lp"   momentum = count / (count + 1),
  other  static momentum.
The running combination restarts whenever the latent shape changes (the
reference crashes there); the KL sum keeps accumulating across every layer.
"""

from __future__ import annotations

import torch

from calm_vit_dte_tpu_torch.ops.variational import kl_divergence


class LatentState:
    def __init__(self, mode: str = "ema", smooth_factor: float = 2.0,
                 momentum: float = 0.9):
        self.mode = mode
        self.smooth_factor = smooth_factor
        self.momentum = momentum
        self.zq_sum: torch.Tensor | None = None
        self.zkv_sum: torch.Tensor | None = None
        self.kl_sum: torch.Tensor | float = 0.0
        self.count = 0      # combine count (resets on shape change)
        self.kl_count = 0   # total updates (KL divisor)

    def update(self, zq, zkv, mean_q, var_q, mean_kv, var_kv):
        """Accumulate one layer's latents; returns the combined (zq, zkv)."""
        self.kl_sum = (kl_divergence(mean_q, var_q)
                       + kl_divergence(mean_kv, var_kv) + self.kl_sum)
        self.kl_count += 1
        if self.zq_sum is None or self.zq_sum.shape != zq.shape:
            self.zq_sum = zq
            self.zkv_sum = zkv
            self.count = 1
        elif self.mode not in ("sum", "sma"):
            self.count += 1
            m = self.momentum
            if self.mode == "ema":
                m = self.smooth_factor / (self.count + 1)
            elif self.mode == "lp":
                m = self.count / (self.count + 1)
            self.zq_sum = m * zq + (1.0 - m) * self.zq_sum
            self.zkv_sum = m * zkv + (1.0 - m) * self.zkv_sum
        else:
            self.count += 1
            self.zq_sum = self.zq_sum + zq
            self.zkv_sum = self.zkv_sum + zkv
            if self.mode == "sma":
                return self.zq_sum / self.count, self.zkv_sum / self.count
        return self.zq_sum, self.zkv_sum

    def carry(self) -> tuple:
        """The whole state, (zq_sum, zkv_sum, kl_sum, count, kl_count): what
        a checkpointed segment takes in and hands back."""
        return (self.zq_sum, self.zkv_sum, self.kl_sum, self.count,
                self.kl_count)

    def set_carry(self, carry: tuple) -> None:
        (self.zq_sum, self.zkv_sum, self.kl_sum, self.count,
         self.kl_count) = carry

    def kl_loss(self) -> torch.Tensor:
        if self.kl_count == 0:
            return torch.zeros((), dtype=torch.float32)
        kl_sum = torch.as_tensor(self.kl_sum, dtype=torch.float32)
        return kl_sum / self.kl_count
