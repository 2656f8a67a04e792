"""What the ported scripts under tools/ share: the card they ran on, where
their JSON goes, device synchronisation and the median of timed chains.

Every number a tool writes carries the card's name and power limit, as
`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives them
(`card`); a CPU run writes None there and no device figure. torch is
imported inside the functions, so the corpus workers that import this
module (tools/soak.py's spawned processes) start without it.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[2]
OUT = REPO / "docs" / "evidence" / "torch_h100"


def card(dev) -> dict:
    """{"name": torch's device name, "nvidia_smi": "<name>, <limit> W"};
    both None off the card."""
    import torch

    if dev.type != "cuda":
        return {"name": None, "nvidia_smi": None}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    return {"name": torch.cuda.get_device_name(dev), "nvidia_smi": smi}


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def median_chain_s(fn, dev, chains: int, chain: int) -> float:
    """Median over `chains` of the host seconds per call of `chain` calls
    of `fn()`, the card synchronised before each clock read."""
    times = []
    for _ in range(chains):
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(chain):
            fn()
        sync(dev)
        times.append((time.perf_counter() - t0) / chain)
    return float(np.median(times))


def time_predict(p, images, dev, warmup: int, chains: int, chain: int):
    """`Predictor.predict` on resident uint8 `images`: (median seconds a
    forward over `chains` chains of `chain` forwards after `warmup`, the
    last logits, the kernels launched by the first forward)."""
    from calm_vit_dte_tpu_torch.utils.profiling import launch_counts

    before = launch_counts()
    p.predict(images)
    per_forward = launches_since(before)
    for _ in range(warmup - 1):
        p.predict(images)
    last = {}

    def fwd():
        last["logits"] = p.predict(images)[0]

    secs = median_chain_s(fwd, dev, chains, chain)
    return secs, last["logits"], per_forward


def peak_gib(dev) -> float | None:
    import torch

    return (torch.cuda.max_memory_allocated(dev) / 2**30
            if dev.type == "cuda" else None)


def reset_peak(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def write_json(out_dir, name: str, obj: dict) -> pathlib.Path:
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / name
    path.write_text(json.dumps(obj, indent=1) + "\n")
    print(f"wrote {path}", flush=True)
    return path


def launches_since(before: dict[str, int]) -> dict[str, int]:
    """The kernel wrappers' launches since `before` (a
    utils.profiling.launch_counts() reading), the nonzero ones."""
    from calm_vit_dte_tpu_torch.utils.profiling import launch_counts

    return {k: n - before[k] for k, n in launch_counts().items()
            if n != before[k]}
