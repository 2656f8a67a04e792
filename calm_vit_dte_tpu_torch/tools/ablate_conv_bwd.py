"""Ablation of the conv residual's backward kernel: the production kernel
(FULL) and six variants, each built without one of its parts, timed on the
card to attribute its time.

    python -m calm_vit_dte_tpu_torch.tools.ablate_conv_bwd \
        [--batch 128] [--size 224] [--reps 10]

JAX counterpart: scripts/ablate_conv_bwd.py, whose Pallas variants (:119)
drop six parts of the TPU backward; here five of them are a compile-time
mask of the bf16 production kernel in csrc/conv_residual_bwd.cu (entry
`conv_residual_bwd_ablate`), and the source says what each part is. The
sixth, trans (the hand-off of g2 and da1 between two layouts through shared
memory), has no counterpart in that design: `run` reports it as absent,
with no time. As there, each variant runs
chained twice (x, g -> dx, then x, dx -> dx) and its time is per backward:
the kernel and its ordered weight-grad sum. FULL must equal the production
kernel bit for bit, which `main` checks first; the variants compute
something else on purpose and have no plain version.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from calm_vit_dte_tpu_torch.kernels import conv_residual as kc

PARTS = ("recompute", "dgelu2", "wdots", "dh", "dgelu1")   # bit i: PARTS[i]
FULL = (1 << len(PARTS)) - 1
# The script's parts that the kernel's design no longer has.
ABSENT = {"trans": "no hand-off between layouts in the kernel's design"}


def variants() -> list[tuple[str, int]]:
    """(label, part mask): FULL, then each part dropped alone."""
    return [("FULL", FULL)] + [(f"-{p}", FULL & ~(1 << i))
                               for i, p in enumerate(PARTS)]


def inputs(batch: int, size: int, device, seed: int = 0) -> tuple:
    """x, g (B,S,S,3) bf16 and the fp32 weights (w1, b1, wd, bd, w2), at
    the scales of the JAX script."""
    rng = np.random.default_rng(seed)

    def n(*shape, scale, dt=torch.float32):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).to(device=device, dtype=dt)

    bf16 = torch.bfloat16
    return (n(batch, size, size, 3, scale=0.5, dt=bf16),
            n(batch, size, size, 3, scale=0.5, dt=bf16),
            n(32, 3, scale=0.2), torch.zeros(32, device=device),
            n(3, 3, 32, scale=0.2), torch.zeros(32, device=device),
            n(3, 32, scale=0.2))


def ablated_bwd(x, g, w1, b1, wd, bd, w2, parts: int) -> tuple:
    """One backward built with the part mask `parts` (bf16): (dx, the packed
    (32, 24) weight grads)."""
    dx, part = kc.launch_bwd(x, g, w1, b1, wd, bd, w2, dtype=torch.bfloat16,
                             parts=parts)
    ablated_bwd.launches += 1
    return dx, kc.conv_weight_grad_sum(part)


ablated_bwd.launches = 0


def full_equals_production(args) -> bool:
    """FULL and the production kernel give the same bits, dx and weight
    grads."""
    x, g, *w = args
    full = ablated_bwd(x, g, *w, FULL)
    prod = kc.conv_residual_bwd(x, g, *w, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for a, b in zip(full, prod))


def _ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def run(args, reps: int = 10) -> list[dict]:
    """Each variant chained twice, `reps` times: ms per backward; then a row
    (ms None) for each part in ABSENT."""
    x, g, *w = args
    rows = []
    for label, parts in variants():
        def chained():
            dx, _ = ablated_bwd(x, g, *w, parts)
            return ablated_bwd(x, dx, *w, parts)

        ms = _ms(chained, reps) / 2
        dx, _ = chained()
        rows.append({"variant": label, "parts": parts, "ms": ms,
                     "dx_sum": float(dx.float().sum())})
    rows += [{"variant": f"-{p}", "parts": None, "ms": None, "absent": why}
             for p, why in ABSENT.items()]
    return rows


def describe(row: dict) -> str:
    """One line of the tool's output for a row of `run`."""
    if row["ms"] is None:
        return f"{row['variant']:<12} absent: {row['absent']}"
    return (f"{row['variant']:<12} {row['ms']:8.4f} ms  (dx sum "
            f"{row['dx_sum']:.4e})")


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--reps", type=int, default=10)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the ablation times CUDA kernels: no card")
    args = inputs(a.batch, a.size, torch.device("cuda"))
    if not full_equals_production(args):
        raise AssertionError("FULL differs from the production backward")
    rows = run(args, a.reps)
    for r in rows:
        print(describe(r), flush=True)
    return rows


if __name__ == "__main__":
    main()
