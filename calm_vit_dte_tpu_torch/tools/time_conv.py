"""Time the conv residual's bf16 kernels on the card at a config's conv
sizes, beside their bytes bound and their CUDA-core floor.

For every conv S of one forward of each config (imagenet-cls-224 and
hires-cls-1024 by default) it times, with CUDA events on random inputs from
a seed, in bf16: the forward (`fused_conv_residual`), the forward that
saves h and acc (`conv_residual_fwd_resid`) and the recomputing backward
with its ordered weight-grad sum (`conv_residual_bwd`); each as the median
of `--reps` runs of 5 launches, and a digest of each kernel's outputs
(two versions of the kernels that agree bit for bit on these inputs print
the same digests). It prints one JSON line per (config, S),
then per config the sums weighted by the launches per forward (8 conv
stages: per training step for the forward with residuals and the
backward), with the card's name, power limit and SM clock.

    python -m calm_vit_dte_tpu_torch.tools.time_conv \\
        [--config imagenet-cls-224 hires-cls-1024] [--batch 128 8] \\
        [--reps 5] [--label NAME]

It times the package found first on `sys.path`: to compare two versions of
the kernels on one card in one run, start it from each checkout's root in
turn (`PYTHONPATH=. python3 <repo>/calm_vit_dte_tpu_torch/tools/
time_conv.py --label old`; each builds its own kernels under its own
`build/`), for example old, new, new, old. Where the package has them it
also prints each conv kernel's registers, spills, shared memory and CTAs
per SM as the card reports them.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess

import numpy as np
import torch

from calm_vit_dte_tpu_torch.kernels import conv_residual as kc
from calm_vit_dte_tpu_torch.utils.configs import get_config

PEAK_BYTES = 3.35e12       # H100 SXM HBM3
LANES_PER_SM = 128         # fp32 lanes of one SM
GELU_OPS = 13              # one GELU, csrc/conv_residual_common.cuh
# Lane-ops per pixel of the work itself (no halo, no loads or stores):
#   forward: W1 96 + taps 288 + W2 96 FMAs, 2 x 32 GELUs;
#   forward with residuals: the same;
#   backward: h (96 FMAs + 32 GELUs), acc 288, dg2 = W2^T g 96, gelu(acc)
#     and gelu'(acc) 32 x (GELU + 3), dacc 32, dh 288, gelu'(a1) from h's
#     exp 32 x 4, da1 32, dx = W1^T da1 96, weight-grad products 17 x 32.
LANE_OPS = {
    "fwd": 480 + 64 * GELU_OPS,
    "fwd_resid": 480 + 64 * GELU_OPS,
    "bwd": (96 + 32 * GELU_OPS + 288 + 96 + 32 * (GELU_OPS + 3) + 32 + 288
            + 32 * 4 + 32 + 96 + 17 * 32),
}
# Values per pixel each kernel must move: x (and g) read, y (and h, acc, or
# dx) written.
VALUES = {"fwd": 6, "fwd_resid": 70, "bwd": 9}
WEIGHT_BYTES = (96 + 32 + 288 + 32 + 96 + 3) * 4


def conv_sizes(model_cfg) -> dict[int, int]:
    """{S: launches} of the conv residual in one forward."""
    sizes: dict[int, int] = {}
    for _, bcfg in model_cfg.backbone_cfg().block_configs():
        sizes[bcfg.seq_len_new] = sizes.get(bcfg.seq_len_new, 0) + 1
    return sizes


def card_clock() -> tuple[int, float]:
    """(SMs, the SM clock's maximum in Hz) of card 0."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, timeout=60,
        check=True).stdout.split()[0]
    return torch.cuda.get_device_properties(0).multi_processor_count, \
        float(mhz) * 1e6


def bound_ms(kind: str, b: int, s: int) -> float:
    """Bytes each input read once and each output written once, bf16, over
    the HBM rate (the operations' time on the tensor cores is smaller)."""
    extra = WEIGHT_BYTES + (32 * 24 * 4 if kind == "bwd" else 0)
    return (b * s * s * VALUES[kind] * 2 + extra) / PEAK_BYTES * 1e3


def floor_ms(kind: str, b: int, s: int, sms: int, clock_hz: float) -> float:
    """The CUDA-core floor: LANE_OPS[kind] x B S^2 / (SMs x 128 x clock)."""
    return LANE_OPS[kind] * b * s * s / (sms * LANES_PER_SM * clock_hz) * 1e3


def inputs(b: int, s: int, seed: int) -> tuple:
    """x, g (B,S,S,3) bf16 on the card and the fp32 weights (w1, b1, wd,
    bd, w2, b2) at the scales of the GPU tests."""
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0, dt=torch.float32):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).to(device="cuda", dtype=dt)

    bf16 = torch.bfloat16
    return (n(b, s, s, 3, dt=bf16), n(b, s, s, 3, scale=0.5, dt=bf16),
            (n(32, 3, scale=0.3), n(32, scale=0.1), n(3, 3, 32, scale=0.3),
             n(32, scale=0.1), n(3, 32, scale=0.2), n(3, scale=0.1)))


def median_ms(fn, reps: int, inner: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def digest(out) -> str:
    """A hash of the bytes of a kernel's output tensor(s)."""
    h = hashlib.blake2b(digest_size=8)
    for t in out if isinstance(out, tuple) else (out,):
        h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy())
    return h.hexdigest()


def time_config(name: str, b: int, reps: int, sms: int,
                clock_hz: float) -> list[dict]:
    bf16 = torch.bfloat16
    rows = []
    for s, launches in sorted(conv_sizes(get_config(name).model).items(),
                              reverse=True):
        x, g, w = inputs(b, s, seed=s)
        calls = {
            "fwd": lambda: kc.fused_conv_residual(x, *w, dtype=bf16),
            "fwd_resid": lambda: kc.conv_residual_fwd_resid(x, *w,
                                                            dtype=bf16),
            "bwd": lambda: kc.conv_residual_bwd(x, g, *w[:5], dtype=bf16),
        }
        row = {"config": name, "S": s, "B": b, "launches": launches}
        for kind, fn in calls.items():
            row[f"{kind}_ms"] = median_ms(fn, reps)
            row[f"{kind}_digest"] = digest(fn())
            row[f"{kind}_bound_ms"] = bound_ms(kind, b, s)
            row[f"{kind}_floor_ms"] = floor_ms(kind, b, s, sms, clock_hz)
        print(json.dumps(row), flush=True)
        rows.append(row)
        del x, g, w
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", nargs="+",
                    default=["imagenet-cls-224", "hires-cls-1024"])
    ap.add_argument("--batch", type=int, nargs="+", default=[128, 8])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--label", default="")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("time_conv times CUDA kernels: no card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    sms, clock_hz = card_clock()
    out = {"label": a.label, "package": kc.__file__, "card": smi,
           "sms": sms, "clock_mhz": clock_hz / 1e6}
    if hasattr(kc, "card_occupancy"):
        out["occupancy"] = kc.card_occupancy()
    for name, b in zip(a.config, a.batch):
        rows = time_config(name, b, a.reps, sms, clock_hz)
        out[name] = {
            f"{kind}_{what}": sum(r["launches"] * r[f"{kind}_{what}"]
                                  for r in rows)
            for kind in LANE_OPS for what in ("ms", "bound_ms", "floor_ms")}
        out[name]["batch"] = b
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
