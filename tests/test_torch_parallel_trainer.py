"""The port's trainer, evaluation and preemption over several processes:
gloo on 127.0.0.1, one process a rank (tests/_torch_parallel_trainer_main
.py, OMP_NUM_THREADS=1, process group timeout 60 s), tiny-cls on the CPU.
The counterparts of tests/test_multiprocess.py and of the SIGTERM case of
tests/test_trainer_e2e.py, through train_cls.main under torchrun's
environment. Every wait on a rank has a timeout of 120 s.
"""

import json
import os
import pathlib
import re
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from _torch_parallel_trainer_main import state_digest

from calm_vit_dte_tpu_torch.models.factory import create_vit
from calm_vit_dte_tpu_torch.tools.parallel_step import collect, free_port
from calm_vit_dte_tpu_torch.train.checkpoint import (
    latest_step,
    restore_checkpoint,
)
from calm_vit_dte_tpu_torch.train.evaluate import evaluate
from calm_vit_dte_tpu_torch.train.optim import make_optimizer
from calm_vit_dte_tpu_torch.train.samples import write_png
from calm_vit_dte_tpu_torch.train.state import create_train_state
from calm_vit_dte_tpu_torch.train.trainer import train
from calm_vit_dte_tpu_torch.utils.configs import get_config

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
MAIN = str(ROOT / "tests" / "_torch_parallel_trainer_main.py")
TIMEOUT = 120


def _ranks(world, mode, ckpt, *extra):
    port = str(free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    return [subprocess.Popen(
        [sys.executable, MAIN, port, str(r), str(world), mode, str(ckpt),
         *extra], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]


def _found(pattern, outs):
    """{rank: match group 2} of `pattern` (rank in group 1) over outputs."""
    got = {}
    for out in outs:
        for m in re.finditer(pattern, out):
            got[int(m.group(1))] = m.group(2)
    return got


def _val_split(root: pathlib.Path, n: int = 11) -> str:
    rng = np.random.default_rng(3)
    for i in range(n):
        d = root / "val" / f"n{i % 2:08d}"
        d.mkdir(parents=True, exist_ok=True)
        write_png(str(d / f"{i}.png"),
                  rng.integers(0, 256, (56, 56, 3), dtype=np.uint8))
    return str(root)


def test_trainer_and_evaluation_over_two_ranks(tmp_path):
    """(e) train() on 2 ranks (2x1): disjoint sampler shards, the same
    final state on both, one checkpoint and one epoch-stats line; (f)
    evaluate() of that checkpoint over the 2 ranks counts each of 11 val
    images once, with the single process's top-1."""
    ckpt = tmp_path / "ckpt"
    stats = tmp_path / "epochs.jsonl"
    val = _val_split(tmp_path / "data")
    outs = collect(_ranks(2, "train", ckpt, "steps=2", "global_batch_size=8",
                          f"epoch_stats_path={stats}", f"val_root={val}"),
                   TIMEOUT)
    shards = {r: set(json.loads(v)) for r, v in
              _found(r"SHARD (\d+): (\[[0-9, ]+\])", outs).items()}
    assert len(shards) == 2 and shards[0].isdisjoint(shards[1])
    digests = _found(r"DIGEST (\d+): (\w+)", outs)
    assert len(digests) == 2 and digests[0] == digests[1]
    assert sorted(os.listdir(ckpt)) == ["step_2.pt"]
    rows = stats.read_text().splitlines()
    assert len(rows) == 1 and json.loads(rows[0])["steps"] == 2

    top1 = _found(r"TOP1 (\d+): (.*)", outs)
    assert len(top1) == 2 and top1[0] == top1[1]
    acc, images = top1[0].split(" over ")
    assert int(images) == 11
    want = evaluate(get_config("tiny-cls", dataset_root=val,
                               checkpoint_dir=str(ckpt), num_workers=0,
                               global_batch_size=4), device="cpu")
    assert float(acc) == want


def test_single_checkpoint_resumes_on_2x2_and_restores_alone(tmp_path):
    """(e) A one-process checkpoint resumes on a 2x2 mesh (tensor parallel
    at tp_min_shard_dim 64); the checkpoint that mesh writes restores in
    one process equal to the state its ranks gathered; (f) evaluate() on
    the 2x2 mesh counts each val image once, with one process's top-1."""
    ckpt = tmp_path / "ckpt"
    cfg = get_config("tiny-cls", checkpoint_dir=str(ckpt), epochs=1,
                     dataset_root="synthetic", global_batch_size=8,
                     num_workers=0)
    train(cfg, max_steps=1, device="cpu")
    assert latest_step(str(ckpt)) == 1
    val = _val_split(tmp_path / "data")
    outs = collect(_ranks(4, "train", ckpt, "steps=1", "global_batch_size=8",
                          "mesh_model=2", "tp_min_shard_dim=64",
                          f"val_root={val}"), TIMEOUT)
    assert "resumed from step 1" in outs[0]
    digests = _found(r"DIGEST (\d+): (\w+)", outs)
    assert len(digests) == 4 and len(set(digests.values())) == 1
    assert latest_step(str(ckpt)) == 2

    _, model = create_vit("tiny-cls", seed=7, device="cpu")
    state = create_train_state(model, make_optimizer(), seed=0)
    restore_checkpoint(str(ckpt), state)
    opt = state.opt_state
    assert state_digest(model.state_dict(), opt.mu, opt.nu,
                        (state.step, opt.count, opt.notfinite)) == \
        digests[0]
    top1 = _found(r"TOP1 (\d+): (.*)", outs)
    assert len(top1) == 4 and len(set(top1.values())) == 1
    acc, images = top1[0].split(" over ")
    assert int(images) == 11
    assert float(acc) == evaluate(get_config(
        "tiny-cls", dataset_root=val, checkpoint_dir=str(ckpt),
        num_workers=0, global_batch_size=4), device="cpu")


def test_sigterm_to_one_rank_checkpoints_both(tmp_path):
    """(g) SIGTERM sent to rank 1 alone: both ranks agree on the flag at
    the same step, checkpoint together and return 0."""
    ckpt = tmp_path / "ckpt"
    procs = _ranks(2, "run", ckpt, "global_batch_size=8", "log_every=1")
    lines = []
    deadline = time.time() + TIMEOUT
    try:
        while time.time() < deadline:
            line = procs[0].stdout.readline()
            if not line:
                break
            lines.append(line)
            if line.startswith("Epoch: 1, Batch: 1,"):
                break
        assert lines and lines[-1].startswith("Epoch: 1, Batch: 1,"), \
            "".join(lines)[-3000:]
        procs[1].send_signal(signal.SIGTERM)
        outs = collect(procs, TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out0 = "".join(lines) + outs[0]
    m = re.search(r"SIGTERM: checkpointed at step (\d+)", out0)
    assert m, out0[-3000:]
    step = int(m.group(1))
    returned = _found(r"RETURNED (\d+): step=(\d+)", [out0, outs[1]])
    assert returned == {0: str(step), 1: str(step)}
    assert latest_step(str(ckpt)) == step < 128


@pytest.mark.parametrize("entry", ["train_cls", "train_reg"])
def test_entry_points_under_torchrun_env_fail_without_a_world(entry,
                                                              tmp_path):
    """An init that fails (here: WORLD_SIZE without RANK) raises instead
    of training as a single process."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT),
               WORLD_SIZE="2", LOCAL_RANK="1", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()))
    env.pop("RANK", None)
    proc = subprocess.run(
        [sys.executable, "-m", f"calm_vit_dte_tpu_torch.train.{entry}",
         "--config", "tiny-cls", "--device", "cpu", "--max-steps", "1",
         f"checkpoint_dir={tmp_path}", "dataset_root=synthetic"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode != 0
    assert "not training as a single process" in proc.stderr, \
        proc.stderr[-3000:]
    assert latest_step(str(tmp_path)) is None
