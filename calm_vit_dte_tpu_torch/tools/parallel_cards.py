"""Data and tensor parallelism across the cards of one host, over NCCL:
the step held against one process, and the trainer's images/s on one
card and on N.

    python -m calm_vit_dte_tpu_torch.tools.parallel_cards [--cards 4] \
        [--steps 6] [--out parallel_cards.json]

(1) tools/parallel_step.py's flagship run (imagenet-cls-224 at full width,
fp32, global batch 8, injected global noise, three steps from the carried
state of `parallel_step.carry_state`) on N ranks over NCCL, a card each,
as DP Nx1 and TP (N/2)x2 (tp_min_shard_dim 512), against one process on
card 0: loss rtol 1e-5, state rtol 3e-3 / atol 3e-5 (DP) or 3e-4 (TP)
(tests/test_sharding.py's limits), every rank's state bit for bit rank
0's, 24 + 24 rope launches a step on every rank.
(2) `train_cls` through torchrun on imagenet-cls-224 (bf16, remat,
synthetic data, 128 images a data rank, `steps` steps): on one card, on N
cards (DP), and on N cards at mesh_model=2; each run's p50 ms a step,
images/s and rope launches, every loss finite, and the DP scaling (the
images/s on N cards over N times one card's).

Exits non-zero without N cards or when a check fails; prints every card's
`nvidia-smi` name and power limit and the numbers, and writes them as JSON
to `--out`.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from calm_vit_dte_tpu_torch.kernels import _build
from calm_vit_dte_tpu_torch.tools import parallel_step as ps

CONFIG = "imagenet-cls-224"
STEP_RUN = {"name": "flagship", "config": CONFIG, "batch": 8, "steps": 3,
            "preprocess": False, "noise_seed": 1000, "state_seed": 3,
            "min_shard_dim": 512}
ROPE_PER_STEP = {"fused_rope_attention": 24, "fused_rope_attention_bwd": 24}
PER_RANK_BATCH = 128


def _check_launches(what: str, per_step: list[dict]) -> None:
    for i, got in enumerate(per_step):
        if got != ROPE_PER_STEP:
            raise AssertionError(f"{what}: step {i + 1} launched {got}, "
                                 f"want {ROPE_PER_STEP}")


def step_against_one_process(cards: int, work: Path, env: dict) -> dict:
    """(1): DP cards x 1 and TP (cards/2) x 2 over NCCL against one
    process on card 0."""
    run = dict(STEP_RUN, restore=str(work / "carried"),
               meshes=[[cards, 1], [cards // 2, 2]])
    with ps.deterministic_cudnn():   # as the ranks run
        ps.carry_state(run, run["restore"], torch.device("cuda", 0))
        single = ps.run_one(run, None, torch.device("cuda", 0))
    _check_launches("one process", single["launches"])
    torch.cuda.empty_cache()
    spec = {"out": str(work / "ranks"), "device": "cuda", "backend": "nccl",
            "timeout_s": 600, "runs": [run]}
    (work / "spec.json").write_text(json.dumps(spec))
    ps.collect(ps.spawn(str(work / "spec.json"), cards, env=env), 600)
    out = {"one_process_ms": float(np.median(single["ms"][1:])),
           "one_process_losses": [m["loss"] for m in single["metrics"]]}
    for (data, model), atol in zip(run["meshes"], (3e-5, 3e-4)):
        layout = f"{data}x{model}"
        recs = [torch.load(work / "ranks" / f"flagship_{layout}_rank{r}.pt",
                           weights_only=False) for r in range(cards)]
        for r, rec in enumerate(recs):
            _check_launches(f"{layout} rank {r}", rec["launches"])
            apart = [k for k, v in recs[0]["state"].items()
                     if not torch.equal(rec["state"][k], v)]
            if apart:
                raise AssertionError(f"{layout}: rank {r}'s state differs "
                                     f"from rank 0's in {apart[:8]}")
        losses = [m["loss"] for m in recs[0]["metrics"]]
        rel = max(abs(a - b) / abs(b)
                  for a, b in zip(losses, out["one_process_losses"]))
        past = ps.excess(recs[0], single, 3e-3, atol)
        if rel > 1e-5 or past["excess"] > 0:
            raise AssertionError(f"{layout} against one process: loss rel "
                                 f"{rel:.3g} (limit 1e-5), state past rtol "
                                 f"3e-3 / atol {atol} by {past['excess']:.3g}"
                                 f" at {past['tensor']}[{past['index']}] "
                                 f"({past['got']!r} against "
                                 f"{past['want']!r})")
        out[layout] = {
            "losses": losses, "loss_max_rel": rel,
            "ms_per_step": [float(np.median(r["ms"][1:])) for r in recs],
            "stored_bytes": recs[0]["stored"]["params"]
            + recs[0]["stored"]["moments"],
            "sharded_weights": len(recs[0]["stored"]["sharded"])}
    return out


def trainer(cards: int, mesh_model: int, steps: int, work: Path,
            env: dict) -> dict:
    """(2): train_cls through torchrun on `cards` cards."""
    name = f"{cards}cards_model{mesh_model}"
    stats = work / f"{name}.jsonl"
    data = cards // mesh_model
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={cards}", "-m",
           "calm_vit_dte_tpu_torch.train.train_cls", "--config", CONFIG,
           "--max-steps", str(steps),
           f"global_batch_size={PER_RANK_BATCH * data}",
           f"mesh_model={mesh_model}", "dataset_root=synthetic",
           "log_every=1", f"checkpoint_dir={work / name}",
           f"epoch_stats_path={stats}"]
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=ps.ROOT, env=env, capture_output=True,
                          text=True, timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"{name} failed:\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-3000:]}")
    losses = [float(x) for x in re.findall(
        r"^Epoch: \d+, Batch: \d+, loss: ([-+0-9.eEnaif]+)", proc.stdout,
        re.M)]
    if len(losses) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"{name}: losses {losses}")
    launches: dict[str, int] = {}   # over the run's epochs
    for line in stats.read_text().splitlines():
        for k, n in json.loads(line)["kernel_launches"].items():
            launches[k] = launches.get(k, 0) + n
    # The chief's own counters: its launches a step.
    _check_launches(name, [{k: n // steps for k, n in launches.items()}])
    p50 = float(re.search(r"p50 step: ([0-9.]+)s", proc.stdout).group(1))
    return {"cards": cards, "mesh_model": mesh_model,
            "global_batch": PER_RANK_BATCH * data, "losses": losses,
            "p50_ms": p50 * 1e3,
            "images_per_s": PER_RANK_BATCH * data / p50,
            "chief_launches": launches, "seconds": time.time() - t0}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cards", type=int, default=4)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--out", default="parallel_cards.json")
    args = ap.parse_args(argv)
    if torch.cuda.device_count() < args.cards or args.cards % 2:
        raise SystemExit(f"needs an even {args.cards} cards; this host has "
                         f"{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    t0 = time.time()
    _build.build(_build.sources())
    result = {"cards": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_s": time.time() - t0}
    env = dict(os.environ, PYTHONPATH=str(ps.ROOT))
    work = Path(tempfile.mkdtemp(prefix="parallel_cards_"))
    try:
        result["step"] = step_against_one_process(args.cards, work, env)
        print(json.dumps({"step": result["step"]}), flush=True)
        runs = []
        for n, m in ((1, 1), (args.cards, 1), (args.cards, 2)):
            runs.append(trainer(n, m, args.steps, work, env))
            print(json.dumps(runs[-1]), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    result["trainer"] = runs
    result["dp_scaling"] = runs[1]["images_per_s"] / (
        args.cards * runs[0]["images_per_s"])
    for line in smi:
        print(line)
    print(json.dumps(result))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
