"""Multi-epoch endurance soak of the port's trainer on the card.

Port of scripts/soak.py (the JAX package's soak), with its arguments,
defaults and summary fields. The flagship cls config trains over a staged
on-disk JPEG corpus across many epoch boundaries (per-epoch sampler
reshuffle, seed 2006; a `step_<n>.pt` checkpoint per epoch, the newest 3
kept; the BatchLoader and the native decoder running the whole time), and
the trainer writes p50 step time, steps/s, peak RSS and its kernels'
launches per epoch to a JSONL.

Phases:
  1. stage: write a synthetic JPEG ImageFolder corpus (default 100 classes
     x 320 images at 256 px) under --corpus, skipped when already staged.
     The bytes are the JAX script's `stage_corpus`'s; STAGE_WORKERS
     processes encode the classes in parallel, each from the generator
     state its class starts at, which this process reaches by making the
     same draws in order;
  2. run: launch the unmodified trainer CLI
     (`python -m calm_vit_dte_tpu_torch.train.train_cls`) as a subprocess
     with epoch_stats_path set, let it run --minutes (or --max-steps), then
     SIGTERM it, which exercises the checkpoint-and-exit path;
     --resume-steps N then relaunches it for N steps, so the same soak
     shows the SIGTERM checkpoint restored and training resumed;
  3. summarize: fold the per-epoch JSONL into soak.json (epochs crossed, p50
     drift first -> last, RSS growth, checkpoint rotation, SIGTERM
     checkpoint), with the card's `nvidia-smi` name and power limit.

Writes soak.json, soak_epochs.jsonl and soak_train.log under --out
(docs/evidence/torch_h100 by default; never the JAX package's
docs/evidence/soak*). The trainer runs on the card unless `--device cpu`.

    python -m calm_vit_dte_tpu_torch.tools.soak --minutes 12 --resume-steps 4
    python -m calm_vit_dte_tpu_torch.tools.soak --stage-only
"""

from __future__ import annotations

import argparse
import io
import json
import os
import pathlib
import re
import signal
import subprocess
import sys
import time

from calm_vit_dte_tpu_torch.tools._common import OUT, REPO

DEFAULT_CORPUS = REPO / ".soak_corpus"
DEFAULT_CKPT = REPO / ".soak_ckpt"
_CKPT = re.compile(r"^step_(\d+)\.pt$")
_WORKER = "calm_vit_dte_tpu_torch.tools.soak"   # stage_corpus's workers
# stage_corpus's worker processes: the host's cores but one, which makes
# the draws.
STAGE_WORKERS = max(1, (os.cpu_count() or 2) - 1)
RESUME_TIMEOUT_S = 1800   # the resumed segment is SIGTERMed after this


def _image_draws(rng, noise):
    """One image's draws, in the JAX script's order: (phases, frequencies),
    with the standard normals of its noise written into `noise`. The
    script's normal(0, 12) is 12 times these, bit for bit, and consumes the
    stream as standard_normal does."""
    ph = rng.uniform(0, 6.28, 3)
    fr = rng.uniform(3, 9, 3)
    rng.standard_normal(out=noise)
    return ph, fr


def _stage_class(root: str, split: str, c: int, per_class: int, size: int,
                 rng_state: dict) -> None:
    """Write class `c`'s JPEGs, drawing from a generator restored to
    `rng_state`: the JAX script's loop body, byte for byte."""
    import numpy as np
    from PIL import Image

    rng = np.random.Generator(np.random.PCG64())
    rng.bit_generator.state = rng_state
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    d = pathlib.Path(root) / split / f"class_{c:04d}"
    d.mkdir(parents=True, exist_ok=True)
    noise = np.empty((size, size, 3))
    for i in range(per_class):
        ph, fr = _image_draws(rng, noise)
        img = np.stack([
            127 + 120 * np.sin(fr[k] * (xx + yy * (c % 7 - 3) / 3)
                               + ph[k]) for k in range(3)], -1)
        img = (img + 12 * noise).clip(0, 255)
        buf = io.BytesIO()
        Image.fromarray(img.astype(np.uint8)).save(buf, "JPEG", quality=85)
        (d / f"img_{i:05d}.jpg").write_bytes(buf.getvalue())


def stage_corpus(root: pathlib.Path, classes: int, per_class: int,
                 size: int, split: str = "train") -> None:
    """Synthetic JPEG ImageFolder corpus: structured images (per-class hue
    gradient + per-image phase) so decode cost and file sizes resemble
    photos rather than noise or solids. The same files, byte for byte, as
    scripts/soak.py::stage_corpus writes for the same arguments: class c
    is encoded by a worker process from the generator state after the
    draws of classes 0..c-1, which this process reaches by drawing."""
    import numpy as np

    root = pathlib.Path(root)
    marker = root / f".staged_{split}"
    want = {"classes": classes, "per_class": per_class, "size": size}
    if marker.exists() and json.loads(marker.read_text()) == want:
        print(f"corpus already staged at {root}/{split}", flush=True)
        return
    t0 = time.time()
    rng = np.random.default_rng(2006 if split == "train" else 7)
    # One worker process a class, at most STAGE_WORKERS at once; each is a
    # fresh interpreter (this process may hold a CUDA context and loader
    # threads, and its __main__ may not be importable).
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get(
            "PYTHONPATH", "").split(os.pathsep) if p]))
    running: list[tuple[int, subprocess.Popen]] = []

    def reap(block: bool) -> None:
        while running and (block or running[0][1].poll() is not None):
            c, proc = running.pop(0)
            if proc.wait() != 0:
                raise RuntimeError(f"staging class {c} failed "
                                   f"(exit {proc.returncode})")
            if c % 10 == 0:
                print(f"staged class {c}/{classes} "
                      f"({time.time() - t0:.0f}s)", flush=True)
            block = False

    noise = np.empty((size, size, 3))
    try:
        for c in range(classes):
            while len(running) >= STAGE_WORKERS:
                reap(block=True)
            job = json.dumps([str(root), split, c, per_class, size,
                              rng.bit_generator.state])
            running.append((c, subprocess.Popen(
                [sys.executable, "-m", _WORKER, "--stage-class", job],
                env=env)))
            for _ in range(per_class):   # on to class c + 1's state
                _image_draws(rng, noise)
        while running:
            reap(block=True)
    finally:
        for _, proc in running:
            proc.kill()
            proc.wait()
    marker.write_text(json.dumps(want))
    n = classes * per_class
    mb = sum(f.stat().st_size for f in root.rglob("*.jpg")) / 1e6
    print(f"corpus staged: {n} JPEGs, {mb:.0f} MB, "
          f"{time.time() - t0:.0f}s", flush=True)


def checkpoint_steps(ckpt_dir) -> list[int]:
    """The steps of the trainer's `step_<n>.pt` files in `ckpt_dir`."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_CKPT.match,
                                               os.listdir(ckpt_dir)) if m)


def _trainer_cmd(args, stats_path: pathlib.Path,
                 max_steps: int | None) -> list[str]:
    cmd = [sys.executable, "-m", "calm_vit_dte_tpu_torch.train.train_cls",
           "--config", args.config, "--device", args.device]
    if max_steps is not None:
        cmd += ["--max-steps", str(max_steps)]
    return cmd + [
        f"dataset_root={args.corpus}",
        f"checkpoint_dir={args.ckpt_dir}",
        f"global_batch_size={args.batch}",
        f"microbatch={args.microbatch}",
        f"epoch_stats_path={stats_path}",
        f"log_every={args.log_every}",
        *args.overrides,
    ]


def _segment(cmd: list[str], log, deadline: float | None,
             sigterm_after_epochs: int | None = None,
             stats_path: pathlib.Path | None = None,
             rows_before: int = 0) -> tuple[int, bool]:
    """Run one trainer process to its end, or SIGTERM it at `deadline` (or
    once `sigterm_after_epochs` epoch lines of this segment are written).
    Returns (exit code, whether SIGTERM was sent)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    print("launching:", " ".join(cmd), flush=True)
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=log,
                            stderr=subprocess.STDOUT, env=env)
    sent = False
    try:
        while True:
            rc = proc.poll()
            if rc is not None:
                return rc, sent
            epochs = (_count_rows(stats_path) - rows_before
                      if sigterm_after_epochs is not None else 0)
            if ((deadline is not None and time.time() >= deadline)
                    or (sigterm_after_epochs is not None
                        and epochs >= sigterm_after_epochs)):
                print("sending SIGTERM (exercises checkpoint-and-exit)",
                      flush=True)
                proc.send_signal(signal.SIGTERM)
                sent = True
                try:
                    return proc.wait(timeout=600), sent
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
                    return -9, sent
            time.sleep(0.5)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _count_rows(stats_path: pathlib.Path | None) -> int:
    if stats_path is None or not stats_path.exists():
        return 0
    return len(stats_path.read_text().splitlines())


def fold(rows: list[dict], log_text: str, ckpt_steps: list[int],
         rc, wall: float, config: dict) -> dict:
    """The JAX script's summary of the soak segment's epoch rows and the
    trainer's log."""
    return {
        "wall_s": round(wall, 1),
        "rc": rc,
        "epochs_completed": len(rows),
        "steps_total": sum(r["steps"] for r in rows),
        "p50_first_epoch_s": rows[0]["p50_step_s"] if rows else None,
        "p50_last_epoch_s": rows[-1]["p50_step_s"] if rows else None,
        "p50_all": sorted(r["p50_step_s"] for r in rows if r["p50_step_s"])
        if rows else [],
        "img_per_s_first": rows[0]["img_per_s"] if rows else None,
        "img_per_s_last": rows[-1]["img_per_s"] if rows else None,
        "rss_mb_first": rows[0]["rss_mb"] if rows else None,
        "rss_mb_last": rows[-1]["rss_mb"] if rows else None,
        "loss_first": rows[0]["loss"] if rows else None,
        "loss_last": rows[-1]["loss"] if rows else None,
        "sigterm_checkpointed": "SIGTERM: checkpointed at step" in log_text,
        "resumed_segments": log_text.count("resumed from step"),
        "checkpoints_kept": ckpt_steps,
        "max_to_keep_respected": len(ckpt_steps) <= 3,
        "config": config,
        "ts": time.time(),
    }


def _launches(rows: list[dict]) -> dict[str, int]:
    total: dict[str, int] = {}
    for r in rows:
        for k, n in r.get("kernel_launches", {}).items():
            total[k] = total.get(k, 0) + n
    return total


def run_soak(args) -> dict:
    import torch

    from calm_vit_dte_tpu_torch.tools._common import card, write_json
    from calm_vit_dte_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    stats_path = out / "soak_epochs.jsonl"
    log_path = out / "soak_train.log"
    if stats_path.exists() and not args.keep_stats:
        stats_path.unlink()
    rows_before = _count_rows(stats_path)
    t0 = time.time()
    with open(log_path, "a" if args.keep_stats else "w") as log:
        deadline = t0 + args.minutes * 60 if args.minutes else None
        rc, sent = _segment(_trainer_cmd(args, stats_path, args.max_steps),
                            log, deadline, args.sigterm_after_epochs,
                            stats_path, rows_before)
    wall = time.time() - t0
    all_rows = [json.loads(line) for line in
                stats_path.read_text().splitlines()] \
        if stats_path.exists() else []
    rows = all_rows[rows_before:]
    log_text = log_path.read_text() if log_path.exists() else ""
    soak_ckpts = checkpoint_steps(args.ckpt_dir)
    config = {"config": args.config, "batch": args.batch,
              "microbatch": args.microbatch, "corpus": str(args.corpus),
              "minutes": args.minutes, "max_steps": args.max_steps,
              "device": dev.type, "torch": torch.__version__}
    summary = fold(rows, log_text, soak_ckpts, rc, wall, config)
    summary["card"] = card(dev)
    summary["sigterm_sent"] = sent
    summary["sigterm_step"] = _last_int(
        r"SIGTERM: checkpointed at step (\d+)", log_text)
    summary["kernel_launches"] = _launches(rows)

    if args.resume_steps:
        t1 = time.time()
        with open(log_path, "a") as log:
            rc2, _ = _segment(_trainer_cmd(args, stats_path,
                                           args.resume_steps), log,
                              time.time() + RESUME_TIMEOUT_S)
        text2 = log_path.read_text()[len(log_text):]
        rows2 = [json.loads(line) for line in
                 stats_path.read_text().splitlines()][len(all_rows):]
        summary["resumed_segments"] = (log_text + text2).count(
            "resumed from step")
        summary["resume"] = {
            "rc": rc2, "steps": args.resume_steps,
            "resumed_from_step": _last_int(r"resumed from step (\d+)",
                                           text2),
            "wall_s": round(time.time() - t1, 1),
            "rows": rows2, "kernel_launches": _launches(rows2),
            "checkpoints_kept": checkpoint_steps(args.ckpt_dir)}
        summary["max_to_keep_respected"] = (
            summary["max_to_keep_respected"]
            and len(summary["resume"]["checkpoints_kept"]) <= 3)
    write_json(out, "soak.json", summary)
    print(json.dumps({k: v for k, v in summary.items()
                      if k not in ("resume", "p50_all")}, indent=1),
          flush=True)
    return summary


def _last_int(pattern: str, text: str) -> int | None:
    found = re.findall(pattern, text)
    return int(found[-1]) if found else None


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--corpus", type=pathlib.Path, default=DEFAULT_CORPUS)
    ap.add_argument("--ckpt-dir", default=str(DEFAULT_CKPT))
    ap.add_argument("--classes", type=int, default=100)
    ap.add_argument("--per-class", type=int, default=320)
    ap.add_argument("--img-size", type=int, default=256)
    ap.add_argument("--minutes", type=float, default=50,
                    help="SIGTERM the trainer after this long (0: never)")
    ap.add_argument("--config", default="imagenet-cls-224")
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--microbatch", type=int, default=4)
    ap.add_argument("--stage-only", action="store_true")
    ap.add_argument("--keep-stats", action="store_true",
                    help="append to the existing epoch JSONL (a resumed "
                    "soak segment: the trainer restores the checkpoint and "
                    "continues)")
    ap.add_argument("--resume-steps", type=int, default=0,
                    help="after the soak segment, relaunch the trainer for "
                    "this many steps from its checkpoint")
    ap.add_argument("--max-steps", type=int, default=None,
                    help="the soak segment's --max-steps for the trainer")
    ap.add_argument("--sigterm-after-epochs", type=int, default=None,
                    help="SIGTERM once this many epoch lines are written "
                    "(besides --minutes)")
    ap.add_argument("--log-every", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("overrides", nargs="*",
                    help="further TrainConfig overrides for the trainer, "
                    "key=value")
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> dict | None:
    args = parse_args(argv)
    stage_corpus(args.corpus, args.classes, args.per_class, args.img_size)
    if args.stage_only:
        return None
    summary = run_soak(args)
    failed = [what for what, bad in (
        ("trainer exit code", summary["rc"] != 0),
        ("resume exit code", summary.get("resume", {}).get("rc", 0) != 0),
        ("no epoch completed", summary["epochs_completed"] == 0),
        ("SIGTERM sent but no checkpoint",
         summary["sigterm_sent"] and not summary["sigterm_checkpointed"]),
        ("more than 3 checkpoints kept",
         not summary["max_to_keep_respected"])) if bad]
    if failed:
        raise SystemExit(f"soak failed: {', '.join(failed)}")
    return summary


if __name__ == "__main__":
    if sys.argv[1:2] == ["--stage-class"]:   # a stage_corpus worker
        _stage_class(*json.loads(sys.argv[2]))
    else:
        main()
