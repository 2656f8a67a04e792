"""Data- and tensor-parallel training steps over several processes, and
the same steps in one process: the rehearsal the CPU tests
(tests/test_torch_parallel.py) and chip_smoke.py's parallel phase run.

Each rank is one process:

    python -m calm_vit_dte_tpu_torch.tools.parallel_step SPEC.json \
        --rank R --world W --port P

joins a world of W ranks (on 127.0.0.1:P) and runs every run of the spec on every mesh of that run that
covers W ranks, writing OUT/<name>_<D>x<M>_rank<R>.pt; `--world 1` (no
process group) runs each run once alone, written as
OUT/<name>_single_rank0.pt. `spawn` starts the W ranks, `collect` waits for
them with a timeout; `run_all` does a rank's work in process;
`carry_state` writes the state a comparison starts from.

SPEC.json: {"out": dir, "device": "cpu" | "cuda", "backend": "gloo" (the
default: every rank on card 0, which NCCL refuses) | "nccl" (rank r on
card r), "timeout_s": the process group's timeout, "runs": [run, ...]},
where a run
is {"name", "config" (its model and task), "batch" (global), "steps",
"preprocess" (true: uint8 images at the config's image_size with integer
labels through its training preprocessing; false: normal images at the
crop with soft labels), "noise_seed" (null: the state's generators; n:
injected standard normals, call i of each step from seed n + i),
"microbatches", "state_seed", "restore" (a checkpoint directory to start
from), "meshes" ([[D, M], ...]), "min_shard_dim", "time_noise" (also time
the step's noise drawn from a generator at the global and at the local
shapes)}. Every run is fp32, from the config's seed-0 weights, without
remat, with the optimizer of `OPT`. A run may also name "grads": weight
names (or their ends), whose gradients after its last step (the mean over
the ranks, as the optimizer takes it) and, on a mesh, each rank's own
gradient before that mean go into the output (`tools/dp_grad_drift.py`).

Each output holds the step's metrics, host ms and kernel launches per
step, the full final state gathered from the ranks (state_dict, moments,
counters), the preprocessed rows of each step when the run preprocesses,
the shapes of the injected noise, and the bytes of parameters and moments
the rank stores.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from calm_vit_dte_tpu_torch.data.pipeline import (
    make_cls_preprocess,
    make_reg_preprocess,
)
from calm_vit_dte_tpu_torch.models.factory import create_vit
from calm_vit_dte_tpu_torch.nn.spectral_norm import normalize_tree
from calm_vit_dte_tpu_torch.ops.variational import noise_override
from calm_vit_dte_tpu_torch.parallel.mesh import make_mesh
from calm_vit_dte_tpu_torch.train.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
)
from calm_vit_dte_tpu_torch.train.optim import make_optimizer
from calm_vit_dte_tpu_torch.train.state import (
    create_train_state,
    full_tensors,
    place_state,
)
from calm_vit_dte_tpu_torch.train.step import make_train_step
from calm_vit_dte_tpu_torch.utils.configs import get_config
from calm_vit_dte_tpu_torch.utils.profiling import launch_counts

ROOT = Path(__file__).resolve().parents[2]
# The JAX parity tests' optimizer (tests/_train_step_jax.py).
OPT = {"base_lr": 3.1e-3, "weight_decay": 0.02, "b1": 0.9, "b2": 0.98,
       "epochs": 5, "steps_per_epoch": 2, "clip_norm": 1.0}


class NoiseSeq:
    """Call i returns standard normals of the asked shape from seed
    `seed + i` (the JAX parity tests' sequence); records the shapes."""

    def __init__(self, seed: int):
        self.seed = seed
        self.shapes: list[tuple] = []

    def __call__(self, shape):
        self.shapes.append(tuple(shape))
        rng = np.random.default_rng(self.seed + len(self.shapes) - 1)
        return rng.standard_normal(shape).astype(np.float32)


def global_batch(run: dict) -> dict[str, np.ndarray]:
    """The run's global batch, the same on every rank."""
    cfg = get_config(run["config"])
    b = run["batch"]
    rng = np.random.default_rng(0)
    classes = cfg.model.out_features
    if run.get("preprocess"):
        size = cfg.image_size
        return {"image": rng.integers(0, 256, (b, size, size, 3),
                                      dtype=np.uint8),
                "label": rng.integers(0, classes, b).astype(np.int64)}
    t = rng.random((b, classes)).astype(np.float32)
    return {"image": rng.standard_normal(
                (b, cfg.crop, cfg.crop, 3)).astype(np.float32),
            "label": t / t.sum(-1, keepdims=True)}


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms, autotuning off, for a scope (the
    settings restored after it). By default the chain route's convolution
    backward varies the last bits of the fp32 gradients from run to run on
    the card; the ranks (`main`) and the one-process step they are held
    against both run under these settings."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def noise_draw_ms(shapes: list[tuple], data: int, device: torch.device,
                  reps: int = 10) -> tuple[float, float]:
    """Median host ms of drawing one step's noise (`shapes`, global) from
    a generator on `device`: at the global shapes, and at the local
    shapes (rows / data)."""
    gen = torch.Generator(device).manual_seed(0)

    def draw(rows_div):
        for shape in shapes:
            torch.empty((shape[0] // rows_div, *shape[1:]),
                        device=device).normal_(generator=gen)

    out = []
    for rows_div in (1, data):
        draw(rows_div)
        times = []
        for _ in range(reps):
            _sync(device)
            t0 = time.perf_counter()
            draw(rows_div)
            _sync(device)
            times.append((time.perf_counter() - t0) * 1e3)
        out.append(float(np.median(times)))
    return out[0], out[1]


def carry_state(run: dict, path: str, device: torch.device) -> str:
    """Save under `path`, as a port checkpoint, the state a comparison
    starts from (`restore`): the config's seed-0 weights with u/v
    converged (30 power iterations) and one fp32 step taken on the run's
    unprocessed batch under injected noise (seed 1000), so the moments are
    not zero: Adam's first step divides each gradient by its own
    magnitude, which turns fp32 noise in a near-zero gradient into a
    whole update."""
    cfg = get_config(run["config"])
    _, model = create_vit(cfg.name, seed=0, device=device)
    with torch.no_grad():
        for _ in range(30):
            normalize_tree(model, training=True)
    tx = make_optimizer(**OPT)
    state = create_train_state(model, tx, seed=run.get("state_seed", 0))
    step = make_train_step(cfg.model, tx, cfg.task, dtype=torch.float32,
                           remat=False)
    with noise_override(NoiseSeq(1000)):
        step(state, global_batch(dict(run, preprocess=False)))
    save_checkpoint(path, state)
    return path


def excess(got: dict, want: dict, rtol: float, atol: float) -> dict:
    """Where the state of record `got` is furthest past rtol / atol of
    `want`'s: {"tensor": its name, "index": the flat index, "got", "want":
    the two values, "excess": by how much} at that element (excess <= 0:
    every element within the limits)."""
    worst = {"tensor": None, "index": None, "got": None, "want": None,
             "excess": -float("inf")}
    for k, w in want["state"].items():
        w = w.double().flatten()
        x = got["state"][k].double().flatten()
        if not w.numel():
            continue
        past = (x - w).abs() - (atol + rtol * w.abs())
        i = int(past.argmax())
        if float(past[i]) > worst["excess"]:
            worst = {"tensor": k, "index": i, "got": float(x[i]),
                     "want": float(w[i]), "excess": float(past[i])}
    return worst


def run_one(run: dict, mesh, device: torch.device,
            wrap_preprocess=None) -> dict:
    """`run`'s steps on this rank of `mesh` (None: alone). Returns the
    record described in the module's docstring."""
    cfg = get_config(run["config"])
    _, model = create_vit(cfg.name, seed=0, device=device)
    tx = make_optimizer(**OPT)
    state = create_train_state(model, tx, seed=run.get("state_seed", 0))
    if run.get("restore"):
        if restore_checkpoint(run["restore"], state) is None:
            raise FileNotFoundError(f"no checkpoint under {run['restore']}")
    if mesh is not None:
        place_state(state, mesh, run.get("min_shard_dim", 512))
    data, data_rank = ((mesh.data, mesh.data_rank) if mesh is not None
                       else (1, 0))
    rows = run["batch"] // data
    batch = {k: v[data_rank * rows:(data_rank + 1) * rows]
             for k, v in global_batch(run).items()}
    pre, seen = None, []
    if run.get("preprocess"):
        pre = (make_cls_preprocess(cfg.model.out_features, cfg.crop)
               if cfg.task == "cls" else make_reg_preprocess(cfg.crop))
        if wrap_preprocess is not None:
            pre = wrap_preprocess(pre)
        inner = pre

        def pre(generator, b):
            out = inner(generator, b)
            seen.append({k: v.detach().cpu() for k, v in out.items()})
            return out

    step = make_train_step(cfg.model, tx, cfg.task, dtype=torch.float32,
                           remat=False, preprocess=pre,
                           microbatches=run.get("microbatches", 1))
    rec = {"metrics": [], "ms": [], "launches": [], "noise_shapes": []}
    named = [(name, p) for name, p in model.named_parameters()
             if any(name.endswith(w) for w in run.get("grads", ()))]
    local: dict = {}
    def spy():
        return (_local_grads(model, [n for n, _ in named], local) if named
                else contextlib.nullcontext())

    for _ in range(run["steps"]):
        noise = (NoiseSeq(run["noise_seed"])
                 if run.get("noise_seed") is not None else None)
        before = launch_counts()
        _sync(device)
        t0 = time.perf_counter()
        with noise_override(noise), spy():
            state, metrics = step(state, batch)
        _sync(device)
        rec["ms"].append((time.perf_counter() - t0) * 1e3)
        after = launch_counts()
        rec["launches"].append({k: n - before[k] for k, n in after.items()
                                if n > before[k]})
        rec["metrics"].append({k: float(v) for k, v in metrics.items()})
        rec["noise_shapes"].append(noise.shapes if noise else [])
    if run.get("time_noise") and rec["noise_shapes"][-1]:
        rec["noise_global_ms"], rec["noise_local_ms"] = noise_draw_ms(
            rec["noise_shapes"][-1], data, device)
    if named:
        rec["grads"] = {n: p.grad.detach().cpu().clone() for n, p in named}
        rec["local_grads"] = local
    sd, mu, nu = full_tensors(state)
    opt = state.opt_state
    rec.update(
        state={k: v.detach().cpu().clone() for k, v in sd.items()},
        mu=[m.detach().cpu().clone() for m in mu],
        nu=[v.detach().cpu().clone() for v in nu],
        counters={"step": state.step, "count": opt.count,
                  "notfinite": opt.notfinite},
        preprocessed=seen,
        stored={"params": sum(p.numel() * p.element_size()
                              for p in model.parameters()),
                "moments": sum(m.numel() * m.element_size()
                               for m in opt.mu + opt.nu),
                "sharded": {name: [list(p.shape), list(state.sharded[name])]
                            for name, p in model.named_parameters()
                            if name in state.sharded},
                "moment_shapes": {name: list(m.shape) for (name, _), m in
                                  zip(model.named_parameters(), opt.mu)
                                  if name in state.sharded}},
        rank=mesh.rank if mesh is not None else 0,
        mesh=[mesh.data, mesh.model] if mesh is not None else [1, 1])
    return rec


@contextlib.contextmanager
def _local_grads(model, names: list[str], out: dict):
    """Within the scope, each step's rank-local gradients of the named
    weights, as `train/step.py` hands them to the mean over the ranks, go
    to `out` (nothing without a mesh: the step takes no mean)."""
    from calm_vit_dte_tpu_torch.train import step as step_module

    inner = step_module._mean_over_ranks
    order = [n for n, _ in model.named_parameters()]

    def spy(grads, *args, **kwargs):
        for n in names:
            out[n] = grads[order.index(n)].detach().cpu().clone()
        return inner(grads, *args, **kwargs)

    step_module._mean_over_ranks = spy
    try:
        yield
    finally:
        step_module._mean_over_ranks = inner


def _device(spec: dict, rank: int) -> torch.device:
    if spec["device"] == "cpu":
        return torch.device("cpu")
    return torch.device(
        "cuda", rank if spec.get("backend", "gloo") == "nccl" else 0)


def run_all(spec: dict, rank: int, world: int,
            wrap_preprocess=None) -> list[Path]:
    """Every run of `spec` on this rank (world 1: alone, no process
    group; otherwise the process group must be initialized). Returns the
    files written."""
    device = _device(spec, rank)
    out = Path(spec["out"])
    out.mkdir(parents=True, exist_ok=True)
    written = []
    for run in spec["runs"]:
        layouts = ([None] if world == 1 else
                   [(d, m) for d, m in run["meshes"] if d * m == world])
        for layout in layouts:
            mesh = make_mesh(*layout) if layout is not None else None
            rec = run_one(run, mesh, device, wrap_preprocess)
            tag = "single" if layout is None else f"{layout[0]}x{layout[1]}"
            path = out / f"{run['name']}_{tag}_rank{rank}.pt"
            torch.save(rec, path)
            written.append(path)
    return written


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(spec_path: str, world: int, port: int | None = None,
          env: dict | None = None) -> list[subprocess.Popen]:
    """Start the `world` rank processes of the spec, output piped."""
    port = free_port() if port is None else port
    env = dict(os.environ, **(env or {}))
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return [subprocess.Popen(
        [sys.executable, "-m", "calm_vit_dte_tpu_torch.tools.parallel_step",
         spec_path, "--rank", str(r), "--world", str(world),
         "--port", str(port)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]


def collect(procs: list[subprocess.Popen], timeout: float) -> list[str]:
    """Wait for every rank (at most `timeout` s each); kill them all on a
    timeout or a failure, which raises with the ranks' output."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired as exc:
        raise RuntimeError(f"rank {len(outs)} did not finish in {timeout} "
                           "s") from exc
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        raise RuntimeError("ranks %s failed:\n%s" % (failed, "\n".join(
            f"--- rank {r}\n{outs[r][-3000:]}" for r in failed)))
    return outs


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("spec")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--port", type=int, default=0)
    args = ap.parse_args(argv)
    spec = json.loads(Path(args.spec).read_text())
    if spec["device"] == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(_device(spec, args.rank))
    # fp32 comparisons: true fp32 products on the card, and convolutions
    # that give the same bits from run to run (`deterministic_cudnn`).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    if args.world > 1:
        dist.init_process_group(
            spec.get("backend", "gloo"),
            init_method=f"tcp://127.0.0.1:{args.port}",
            world_size=args.world, rank=args.rank,
            timeout=datetime.timedelta(seconds=spec.get("timeout_s", 60)))
    try:
        for path in run_all(spec, args.rank, args.world):
            print(f"wrote {path}", flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
