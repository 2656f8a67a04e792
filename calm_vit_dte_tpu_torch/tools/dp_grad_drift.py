"""Phase 13's DP 2x1 state check taken apart at its first step: how far the
data-parallel gradient and the one-process gradient each are from a float64
one-process gradient, from the same carried start.

`chip_smoke.py` phase 13 holds the flagship's fp32 state after 3 steps of
DP 2x1 (two gloo ranks) against one process at rtol 3e-3 / atol 3e-5, and
passes by a margin that depends on the start. This tool starts where the
phase does (`parallel_step.carry_state`: the config's seed-0 weights and one
fp32 step taken), with cuDNN's deterministic algorithms, and takes the
phase's first step (global batch 8, noise seed 1000, state seed 3):

  * in one process, fp32;
  * as DP 2x1 over gloo: each rank's own gradient and their mean
    (`parallel/mesh.py::average_`, an fp32 all-reduce and a division);
  * in one process in float64 (every tensor, and every upcast the port
    writes as `.float()` or `.to(torch.float32)`, in float64; the same
    injected noise; attention on the torch `xla` route, since the kernels
    take fp32 and bf16 only), the reference.

For each named weight it reports, at the named elements and over the whole
tensor, the one-process and DP gradients' distances from float64 (largest
and root mean square, and their ratio), the error the mean alone adds (the
fp32 mean of the two ranks' gradients against their float64 mean), and the
parameter after the step in all three runs.

    python -m calm_vit_dte_tpu_torch.tools.dp_grad_drift [--device cuda]
        [--config imagenet-cls-224] \
        [--out docs/evidence/torch_h100/dp_grad_drift.json]

`--device cpu --config tiny-cls` rehearses it on the CPU (gloo ranks with
one thread each). Prints one JSON object and writes it to --out.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import tempfile
from pathlib import Path

import torch

from calm_vit_dte_tpu_torch.ops import attention as ops_attention
from calm_vit_dte_tpu_torch.tools import parallel_step as ps

# The weights and flat elements phase 13 named (PERF.md §6): the
# element past the atol from one start, the worst one from another, and the
# worst one from the fixed start in use.
ELEMENTS = {"encoder_blocks.0.encoder.q_proj.weight_orig": (10070, 106082),
            "encoder_blocks.1.decoder.linear_mask.2.weight_orig": (46915,)}


@contextlib.contextmanager
def float64():
    """Run the port in float64: new tensors, `.float()` and `.to(float32)`
    all give float64."""
    f, to, default = torch.Tensor.float, torch.Tensor.to, \
        torch.get_default_dtype()

    def as_f64(self, *a, **k):
        return self.double() if self.dtype == torch.float64 else f(
            self, *a, **k)

    def to_f64(self, *a, **k):
        a = tuple(torch.float64 if x is torch.float32 else x for x in a)
        if k.get("dtype") is torch.float32:
            k["dtype"] = torch.float64
        return to(self, *a, **k)

    torch.Tensor.float, torch.Tensor.to = as_f64, to_f64
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.Tensor.float, torch.Tensor.to = f, to
        torch.set_default_dtype(default)


def distances(got: torch.Tensor, want: torch.Tensor) -> dict:
    """Largest and root-mean-square |got - want|, both float64."""
    d = (got.double() - want.double()).flatten()
    return {"max_abs": float(d.abs().max()),
            "rms": float(d.square().mean().sqrt())}


def report(one: dict, ranks: list[dict], ref: dict, names: list[str],
           elements: dict) -> dict:
    """The comparison described in the module docstring, from the records
    of `parallel_step.run_one` (fp32 one process, the DP ranks, float64)."""
    out = {}
    for name in names:
        key = next(k for k in elements if name.endswith(k))
        g64 = ref["grads"][name].double()
        g1, gdp = one["grads"][name], ranks[0]["grads"][name]
        local = [r["local_grads"][name] for r in ranks]
        mean64 = sum(x.double() for x in local) / len(local)
        e1, edp = distances(g1, g64), distances(gdp, g64)
        row = {
            "one_process_vs_float64": e1,
            "dp_vs_float64": edp,
            "dp_over_one_process_rms": edp["rms"] / e1["rms"],
            "mean_vs_float64_mean_of_ranks": distances(gdp, mean64),
            "grad_scale_rms": float(g64.square().mean().sqrt()),
            "elements": {}}
        for i in (i for i in elements[key] if i < g64.numel()):
            w = {tag: rec["state"][name].flatten()[i].item()
                 for tag, rec in (("one_process", one), ("dp", ranks[0]),
                                  ("float64", ref))}
            row["elements"][str(i)] = {
                "grad_float64": g64.flatten()[i].item(),
                "grad_one_process": g1.flatten()[i].item(),
                "grad_dp": gdp.flatten()[i].item(),
                "grad_ranks": [x.flatten()[i].item() for x in local],
                "param_after": w}
        out[name] = row
    return out


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--config", default="imagenet-cls-224")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--out", type=Path,
                    default=Path("docs/evidence/torch_h100/"
                                 "dp_grad_drift.json"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("dp_grad_drift --device cuda needs a CUDA card")
    device = torch.device(args.device, 0) if args.device == "cuda" else \
        torch.device("cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    work = Path(tempfile.mkdtemp(prefix="dp_grad_drift_"))
    run = {"name": "flagship", "config": args.config, "batch": args.batch,
           "steps": 1, "preprocess": False, "noise_seed": 1000,
           "state_seed": 3, "restore": str(work / "carried"),
           "meshes": [[2, 1]], "min_shard_dim": 512,
           "grads": list(ELEMENTS)}
    with ps.deterministic_cudnn():
        ps.carry_state(run, run["restore"], device)
        one = ps.run_one(run, None, device)
        # float64 on the torch attention route: the kernels take fp32 and
        # bf16 only.
        with float64(), ops_attention.attention_impl("xla"):
            ref = ps.run_one(run, None, device)
    names = sorted(ref["grads"])
    if not names or any(g.dtype != torch.float64
                        for g in ref["grads"].values()):
        raise AssertionError("the float64 step did not run in float64")
    spec = {"out": str(work / "ranks"), "device": args.device,
            "timeout_s": 600, "runs": [run]}
    (work / "spec.json").write_text(json.dumps(spec))
    env = {"OMP_NUM_THREADS": "1"} if args.device == "cpu" else None
    ps.collect(ps.spawn(str(work / "spec.json"), 2, env=env), timeout=900)
    ranks = [torch.load(work / "ranks" / f"flagship_2x1_rank{r}.pt",
                        weights_only=False) for r in range(2)]
    out = {"config": args.config, "batch": args.batch,
           "device": (torch.cuda.get_device_name(0) if args.device == "cuda"
                      else "cpu"),
           "loss": {"one_process": one["metrics"][0]["loss"],
                    "dp": ranks[0]["metrics"][0]["loss"],
                    "float64": ref["metrics"][0]["loss"]},
           "weights": report(one, ranks, ref, names, ELEMENTS)}
    if not all(math.isfinite(v) for v in out["loss"].values()):
        raise AssertionError(f"non-finite loss {out['loss']}")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    os.environ.setdefault("PYTHONHASHSEED", "0")
    main()
