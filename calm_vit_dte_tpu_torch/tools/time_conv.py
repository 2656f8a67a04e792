"""Time the conv residual's kernels on the card at a config's conv sizes,
beside their bound and their CUDA-core floor.

For every conv S of one forward of each config (imagenet-cls-224 and
hires-cls-1024 by default) it times, on random inputs from a seed, in bf16
(or the --dtype given): the forward (`fused_conv_residual`), the forward
that saves h and acc (`conv_residual_fwd_resid`) and the recomputing
backward with its ordered weight-grad sum (`conv_residual_bwd`); each as
the median of `--reps` replays of one CUDA graph of 5 launches, so that
the wrappers' host work between launches drops out of the time (at B=8 a
launch's host work lasts about as long as its kernel); and a digest of
each kernel's outputs (two versions of the kernels that agree bit for bit
on these inputs print the same digests). With --plain it also times each
kernel's plain version (`fused_conv_residual_plain`,
`conv_residual_fwd_resid_plain`, `conv_residual_bwd_plain`: torch ops on
the card) with CUDA events, each `<kind>_plain_ms` beside its kernel's
`<kind>_ms`. It prints one JSON line per (config, B, S), then per (config,
B) the sums weighted by the launches per forward (8 conv stages: per
training step for the forward with residuals and the backward), with the
card's name, power limit and SM clock. A config may be given twice with
two batches.

    python -m calm_vit_dte_tpu_torch.tools.time_conv \\
        [--config imagenet-cls-224 hires-cls-1024] [--batch 128 8] \\
        [--reps 5] [--dtype bfloat16|float32] [--plain] [--label NAME]

The bound is the larger of the bytes (each input read once, each output
written once) over the HBM rate and the operations over the compute type's
peak (bf16: the bytes, at every size; fp32: the operations at 67 TFLOP/s,
but the bytes for the forward with residuals). The CUDA-core floor counts
each kernel's lane-ops per pixel in its compute type (`LANE_OPS`: the bf16
GELU of 13 lane-ops; `LANE_OPS_F32`: the exact GELU of 25 and GELU' of 12
more, counted in the SASS of the fp32 GELU probe) over 128 lanes an SM at
the SM clock.

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
PEAK_FLOPS = {torch.bfloat16: 989e12,   # H100 SXM dense bf16 tensor cores
              torch.float32: 67e12}     # H100 SXM fp32 outside them
# Operations per pixel of each kernel's products (2 x 32 x 15 a forward;
# the backward three times that), as chip_smoke.py counts them.
FLOPS = {"fwd": 2 * 32 * 15, "fwd_resid": 2 * 32 * 15, "bwd": 6 * 32 * 15}
LANES_PER_SM = 128         # fp32 lanes of one SM
GELU_OPS = 13              # one bf16 GELU, csrc/conv_residual_common.cuh
# The exact fp32 GELU (one erff, branch-free) and what GELU' from its Phi
# (one expf and an FMA) adds, in lane-ops. Counted in `cuobjdump -sass` of
# libconv_residual.so as nvcc 12.9 built it for sm_90a: the instructions
# of gelu_f32_probe_kernel<false> (and, beyond them, of <true>) that compute
# the stored values from the loaded x, found by walking back from the
# stores; address arithmetic and constant moves not counted. Recount when
# the GELU or the compiler changes.
GELU_OPS_F32 = 25
DGELU_OPS_F32 = 12


def lane_ops(gelu: int, dgelu: int) -> dict[str, int]:
    """Lane-ops per pixel of the work itself (no halo, no loads or stores)
    for a GELU of `gelu` lane-ops and a GELU' from its Phi of `dgelu`:
      forward: W1 96 + taps 288 + W2 96 FMAs, 2 x 32 GELUs;
      forward with residuals: the same;
      backward: h (96 FMAs + 32 GELUs), acc 288, dg2 = W2^T g 96, gelu(acc)
        and gelu'(acc) 32 x (GELU + GELU'), dacc 32, dh 288, gelu'(a1) from
        h's Phi 32 x GELU', da1 32, dx = W1^T da1 96, weight-grad products
        17 x 32."""
    fwd = 480 + 64 * gelu
    return {"fwd": fwd, "fwd_resid": fwd,
            "bwd": (96 + 32 * gelu + 288 + 96 + 32 * (gelu + dgelu) + 32
                    + 288 + 32 * dgelu + 32 + 96 + 17 * 32)}


# The bf16 GELU' shares the GELU's exp and reciprocal: 3 lane-ops on the
# acc plane, 4 on a1's.
LANE_OPS = {
    "fwd": 480 + 64 * GELU_OPS,
    "fwd_resid": 480 + 64 * GELU_OPS,
    "bwd": (96 + 32 * GELU_OPS + 288 + 96 + 32 * (GELU_OPS + 3) + 32 + 288
            + 32 * 4 + 32 + 96 + 17 * 32),
}
LANE_OPS_F32 = lane_ops(GELU_OPS_F32, DGELU_OPS_F32)
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


def bound_ms(kind: str, b: int, s: int, dtype=torch.bfloat16) -> float:
    """The larger of the bytes each input read once and each output
    written once in `dtype` over the HBM rate, and the operations over
    `dtype`'s peak (in bf16 always the bytes)."""
    extra = WEIGHT_BYTES + (32 * 24 * 4 if kind == "bwd" else 0)
    item = torch.finfo(dtype).bits // 8
    return max((b * s * s * VALUES[kind] * item + extra) / PEAK_BYTES,
               FLOPS[kind] * b * s * s / PEAK_FLOPS[dtype]) * 1e3


def floor_ms(kind: str, b: int, s: int, sms: int, clock_hz: float,
             dtype=torch.bfloat16) -> float:
    """The CUDA-core floor: the lane-ops per pixel of `kind` in `dtype`
    (LANE_OPS or LANE_OPS_F32) x B S^2 / (SMs x 128 x clock)."""
    ops = LANE_OPS_F32 if dtype == torch.float32 else LANE_OPS
    return ops[kind] * b * s * s / (sms * LANES_PER_SM * clock_hz) * 1e3


def inputs(b: int, s: int, seed: int, dt=torch.bfloat16) -> tuple:
    """x, g (B,S,S,3) in `dt` on the card and the fp32 weights (w1, b1,
    wd, bd, w2, b2) at the scales of the GPU tests."""
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0, dt=torch.float32):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).to(device="cuda", dtype=dt)

    return (n(b, s, s, 3, dt=dt), n(b, s, s, 3, scale=0.5, dt=dt),
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


def graph_ms(fn, reps: int, inner: int = 5) -> float:
    """The kernels' time a call: `inner` calls captured once in a CUDA
    graph, the median over `reps` replays of it, over `inner`."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    return median_ms(graph.replay, reps, inner=1) / inner


def digest(out) -> str:
    """A hash of the bytes of a kernel's output tensor(s)."""
    h = hashlib.blake2b(digest_size=8)
    for t in out if isinstance(out, tuple) else (out,):
        h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy())
    return h.hexdigest()


def time_config(name: str, b: int, reps: int, sms: int,
                clock_hz: float, dtype=torch.bfloat16,
                plain: bool = False) -> list[dict]:
    rows = []
    for s, launches in sorted(conv_sizes(get_config(name).model).items(),
                              reverse=True):
        x, g, w = inputs(b, s, seed=s, dt=dtype)
        calls = {
            "fwd": lambda: kc.fused_conv_residual(x, *w, dtype=dtype),
            "fwd_resid": lambda: kc.conv_residual_fwd_resid(x, *w,
                                                            dtype=dtype),
            "bwd": lambda: kc.conv_residual_bwd(x, g, *w[:5], dtype=dtype),
        }
        plains = {
            "fwd": lambda: kc.fused_conv_residual_plain(x, *w, dtype=dtype),
            "fwd_resid": lambda: kc.conv_residual_fwd_resid_plain(
                x, *w, dtype=dtype),
            "bwd": lambda: kc.conv_residual_bwd_plain(x, g, *w[:5],
                                                      dtype=dtype),
        }
        row = {"config": name, "S": s, "B": b, "launches": launches}
        for kind, fn in calls.items():
            row[f"{kind}_ms"] = graph_ms(fn, reps)
            if plain:
                row[f"{kind}_plain_ms"] = median_ms(plains[kind], reps,
                                                    inner=1)
            row[f"{kind}_digest"] = digest(fn())
            row[f"{kind}_bound_ms"] = bound_ms(kind, b, s, dtype)
            row[f"{kind}_floor_ms"] = floor_ms(kind, b, s, sms, clock_hz,
                                               dtype)
        print(json.dumps(row), flush=True)
        rows.append(row)
        del x, g, w, calls, plains
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", nargs="+",
                    default=["imagenet-cls-224", "hires-cls-1024"])
    ap.add_argument("--batch", type=int, nargs="+", default=[128, 8])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--label", default="")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    ap.add_argument("--plain", action="store_true",
                    help="also time the plain versions on the card")
    a = ap.parse_args(argv)
    if len(a.config) != len(a.batch):
        ap.error("give one --batch for each --config")
    if not torch.cuda.is_available():
        raise RuntimeError("time_conv times CUDA kernels: no card")
    # The plain versions' products and convolutions in true fp32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    sms, clock_hz = card_clock()
    out = {"label": a.label, "package": kc.__file__, "card": smi,
           "dtype": a.dtype,
           "sms": sms, "clock_mhz": clock_hz / 1e6}
    if hasattr(kc, "card_occupancy"):
        out["occupancy"] = kc.card_occupancy()
    whats = ("ms", "bound_ms", "floor_ms") + (("plain_ms",) if a.plain
                                              else ())
    for name, b in zip(a.config, a.batch):
        rows = time_config(name, b, a.reps, sms, clock_hz,
                           getattr(torch, a.dtype), a.plain)
        out[f"{name} B={b}"] = {
            f"{kind}_{what}": sum(r["launches"] * r[f"{kind}_{what}"]
                                  for r in rows)
            for kind in LANE_OPS for what in whats}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
