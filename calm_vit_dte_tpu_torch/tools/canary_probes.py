"""Layout canaries on the card: whether a hand-written head-split relayout
beats the library transpose, and whether a head-split einsum beats the
port's merged projection + transpose.

JAX counterpart: scripts/canary_probes.py, whose two probes decided two
layouts of the JAX package on the TPU. The port performs the same
transpose on every projection (models/vmla.py `_heads`: view, then
transpose(1, 2).contiguous()) and its inverse after attention, so on the
card the probes ask about the port's own main path:

  swap   kernels/relayout.swap_seq_heads (CUDA, csrc/relayout.cu) against
         x.transpose(1, 2).contiguous() at the flagship head split
         (128, 224, 12, 56) bf16. Blocked while kernel_ms >= torch_ms.
  proj   forward + backward of the port's merged F.linear + split + view +
         transpose against torch.einsum("bsk,hdk->bhsd") into (b, h, s, d).

A run compares against this package's own baselines file,
tools/canary_baselines.json, written only on the card by --rebaseline with
the card's name and power limit (the JAX package's
docs/evidence/canary_baselines.json holds TPU numbers and is not read).
Without the file a run reports "no baseline" and no flip. A crash or a
wrong result of a probe raises.

    python -m calm_vit_dte_tpu_torch.tools.canary_probes [--rebaseline]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess

import numpy as np
import torch
import torch.nn.functional as F

from calm_vit_dte_tpu_torch.kernels.relayout import (
    swap_seq_heads,
    swap_seq_heads_plain,
)

BASELINES = pathlib.Path(__file__).resolve().parent / "canary_baselines.json"
PEAK_BYTES = 3.35e12   # H100 SXM HBM3, bytes/s


def _event_ms(fn, reps: int) -> float:
    """Mean ms per call of `reps` back-to-back calls, by CUDA events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20) -> float:
    """Device ms per call of `fn`: `reps` calls captured in one CUDA graph,
    the graph's replay timed by CUDA events. A call of a few microseconds
    launched from Python costs more on the host than on the card; the
    replay times the card alone."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    return _event_ms(graph.replay, 5) / reps


def probe_swap(b: int = 128, h: int = 12, s: int = 224, d: int = 56) -> dict:
    """The relayout kernel against the transpose, bit for bit, then their
    device times (graph_ms) in turns, three times, keeping each one's
    minimum."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (b, s, h, d)).astype(np.float32)).to("cuda", torch.bfloat16)
    if not torch.equal(swap_seq_heads(x), swap_seq_heads_plain(x)):
        raise AssertionError(f"swap_seq_heads differs from the transpose at "
                             f"{tuple(x.shape)} bf16")
    kernel_ms, torch_ms = [], []
    for _ in range(3):
        kernel_ms.append(graph_ms(lambda: swap_seq_heads(x)))
        torch_ms.append(graph_ms(lambda: swap_seq_heads_plain(x)))
    k, t = min(kernel_ms), min(torch_ms)
    return {"status": "ok", "kernel_ms": k, "torch_ms": t,
            "bound_ms": 2 * x.numel() * x.element_size() / PEAK_BYTES * 1e3,
            "blocked": k >= t}


def probe_proj(b: int = 128, s: int = 224, dim: int = 672,
               h: int = 12) -> dict:
    """Forward + backward of the q, k, v head split, bf16: the port's form
    (one F.linear, split, view, transpose(1, 2).contiguous()) against one
    einsum per projection into (b, h, s, d). Each iteration's inputs depend
    on the last one's gradients, so the timed loop cannot overlap."""
    d = dim // h
    rng = np.random.default_rng(0)
    x0 = torch.from_numpy((rng.standard_normal((b, s, dim)) * 0.3).astype(
        np.float32)).to("cuda", torch.bfloat16)
    w0 = torch.from_numpy((rng.standard_normal((3 * dim, dim)) * 0.05)
                          .astype(np.float32)).to("cuda", torch.bfloat16)

    def split_linear(x, w):
        return tuple(y.view(b, s, h, d).transpose(1, 2).contiguous()
                     for y in F.linear(x, w).chunk(3, dim=-1))

    def split_einsum(x, w):
        wh = w.view(3, h, d, dim)
        return tuple(torch.einsum("bsk,hdk->bhsd", x, wh[i])
                     for i in range(3))

    def timed(f) -> float:
        state = [x0.clone(), w0.clone()]

        def step():
            x, w = (t.detach().requires_grad_() for t in state)
            loss = sum((y.float() ** 2).sum() for y in f(x, w))
            gx, gw = torch.autograd.grad(loss, (x, w))
            state[0] = x.detach() + 1e-6 * gx
            state[1] = w.detach() + 1e-6 * gw

        return _event_ms(step, 20)

    base, eins = [], []
    for _ in range(3):
        base.append(timed(split_linear))
        eins.append(timed(split_einsum))
    base_ms, eins_ms = min(base), min(eins)
    return {"status": "ok", "baseline_ms": base_ms, "einsum_ms": eins_ms,
            "einsum_speedup": base_ms / eins_ms}


FOLLOWUP = {
    "swap": ("the relayout kernel now beats the transpose: route the head "
             "split of models/vmla.py `_heads` (and the merge after "
             "attention in VMLA.forward) through "
             "kernels/relayout.swap_seq_heads and compare chip_smoke.py's "
             "classify images/s and training ms per step in one call."),
    "proj": ("the einsum's standalone advantage moved by more than 10%: "
             "try torch.einsum('bsk,hdk->bhsd') projections in "
             "models/vmla.py `_heads` and compare chip_smoke.py's training "
             "ms per step and classify images/s in one call."),
}


def _card() -> dict:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return {"name": torch.cuda.get_device_name(0),
            "nvidia_smi": smi.stdout.strip().splitlines()[0],
            "torch": torch.__version__, "cuda": torch.version.cuda}


def _measure() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("the canaries measure the card: "
                           "torch.cuda.is_available() is False")
    return {"swap": probe_swap(), "proj": probe_proj(), "card": _card()}


def run_canaries() -> tuple[dict, list]:
    """Measure both probes and compare with the baselines file. Returns
    (results, flips), flips a list of (name, follow-up text)."""
    results = _measure()
    flips = []
    if not BASELINES.exists():
        results["baseline"] = "no baseline"
        return results, flips
    base = json.loads(BASELINES.read_text())
    results["baseline"] = str(BASELINES.name)
    if not results["swap"]["blocked"]:
        flips.append(("swap", FOLLOWUP["swap"]))
    pb = base.get("proj", {}).get("einsum_speedup")
    pr = results["proj"]["einsum_speedup"]
    if pb and abs(pr - pb) > 0.10 * pb:
        flips.append(("proj", FOLLOWUP["proj"]))
    return results, flips


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rebaseline", action="store_true",
                    help="measure and write tools/canary_baselines.json")
    args = ap.parse_args(argv)
    if args.rebaseline:
        results = _measure()
        BASELINES.write_text(json.dumps(results, indent=1) + "\n")
        print(json.dumps(results, indent=1))
        print(f"baselines written to {BASELINES}")
        return
    results, flips = run_canaries()
    print(json.dumps(results, indent=1))
    sw, pr = results["swap"], results["proj"]
    if not flips:
        print(f"\nCANARY: no change ({results['baseline']}): swap kernel "
              f"{sw['kernel_ms']:.4f} vs torch {sw['torch_ms']:.4f} ms "
              f"(bound {sw['bound_ms']:.4f}); proj einsum speedup "
              f"{pr['einsum_speedup']:.3f}")
    for name, todo in flips:
        print(f"\nCANARY OPPORTUNITY [{name}]: {todo}")


if __name__ == "__main__":
    main()
