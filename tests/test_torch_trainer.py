"""The port's trainer end to end on the CPU, at the tiny configs: the
counterparts of tests/test_trainer_e2e.py (synthetic or image-folder data ->
loader -> on-device preprocessing -> step -> checkpoint -> resume), through
the CLI's `main(argv)` with `--device cpu`, in one process; the runs over
several processes are tests/test_torch_parallel_trainer.py's.
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

from calm_vit_dte_tpu_torch.data.pipeline import make_reg_preprocess
from calm_vit_dte_tpu_torch.models.factory import create_vit
from calm_vit_dte_tpu_torch.nn.spectral_norm import (
    normalize_tree,
    prenormalized_scope,
)
from calm_vit_dte_tpu_torch.ops.variational import noise_override
from calm_vit_dte_tpu_torch.train import train_cls, train_reg
from calm_vit_dte_tpu_torch.train.checkpoint import (
    checkpoint_meta,
    latest_step,
    restore_checkpoint,
    warm_start_params,
)
from calm_vit_dte_tpu_torch.train.optim import make_optimizer
from calm_vit_dte_tpu_torch.train.samples import write_png
from calm_vit_dte_tpu_torch.train.state import create_train_state
from calm_vit_dte_tpu_torch.train.step import make_train_step
from calm_vit_dte_tpu_torch.train.trainer import _dump_samples, train
from calm_vit_dte_tpu_torch.utils.configs import get_config

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _args(ckpt, *extra, config="tiny-cls", steps=2):
    return ["--config", config, "--max-steps", str(steps), "--device", "cpu",
            f"checkpoint_dir={ckpt}", "epochs=1", "dataset_root=synthetic",
            "log_every=100", *extra]


def _fresh_state(config="tiny-cls"):
    cfg = get_config(config)
    _, model = create_vit(config, seed=5, device="cpu")
    return create_train_state(model, make_optimizer(), seed=0), cfg


def test_train_checkpoint_resume_exact(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    s1 = train_cls.main(_args(ckpt))
    assert s1.step == 2 and latest_step(ckpt) == 2
    assert checkpoint_meta(ckpt)["step"] == 2
    # The saved state restores bit for bit into a fresh one.
    state, _ = _fresh_state()
    assert restore_checkpoint(ckpt, state) is state
    saved = s1.model.state_dict()
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, saved[k]), k
    for a, b in zip(state.opt_state.mu + state.opt_state.nu,
                    s1.opt_state.mu + s1.opt_state.nu):
        assert torch.equal(a, b)
    assert (state.step, state.seed, state.opt_state.count) == (
        2, s1.seed, s1.opt_state.count)
    # The next run resumes there and keeps training.
    s2 = train_cls.main(_args(ckpt))
    assert s2.step == 4
    diff = sum(float((a - b).abs().sum()) for a, b in zip(
        saved.values(), s2.model.state_dict().values()))
    assert diff > 0.0


def test_restore_without_checkpoint_returns_none(tmp_path):
    state, _ = _fresh_state()
    assert restore_checkpoint(str(tmp_path / "none"), state) is None
    assert latest_step(str(tmp_path / "none")) is None


def test_warm_start_loads_a_reference_state_dict(tmp_path):
    """strict=False: the original's names load as they are; unknown keys are
    skipped."""
    _, src = create_vit("tiny-cls", seed=1, device="cpu")
    sd = dict(src.state_dict(), **{"not.a.key": torch.zeros(1)})
    path = str(tmp_path / "model_cls.pth")
    torch.save(sd, path)
    _, dst = create_vit("tiny-cls", seed=2, device="cpu")
    warm_start_params(path, dst)
    for k, v in dst.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_reg_trainer_dumps_samples_of_the_eval_forward(tmp_path):
    """The PNGs are the sigmoid of the eval-normalized bf16 forward (the
    function the eval step runs) on the augmented batch, off by at most one
    level (tests/test_trainer_e2e.py:101-151)."""
    from PIL import Image

    out_dir = tmp_path / "samples"
    state = train_reg.main(_args(tmp_path / "ckpt", f"save_samples_dir="
                                 f"{out_dir}", config="tiny-reg", steps=1),
                           default_config="tiny-reg")
    assert any(f.endswith(".png") for f in os.listdir(out_dir))
    cfg = get_config("tiny-reg", save_samples_dir=str(out_dir))
    rng = np.random.default_rng(7)
    batch = {"image": torch.from_numpy(rng.integers(
        0, 255, (4, cfg.image_size, cfg.image_size, 3), dtype=np.uint8))}
    _dump_samples(cfg, state, batch)
    proc = make_reg_preprocess(cfg.crop)(torch.Generator().manual_seed(0),
                                         batch)
    model = state.model.eval()
    with torch.no_grad(), prenormalized_scope(
            normalize_tree(model, training=False)):
        tokens, _ = model(proc["image"], dtype=torch.bfloat16)
    t = tokens.float().numpy()
    b, s, _ = t.shape
    expected = (1.0 / (1.0 + np.exp(-t.reshape(b, s, s, 3))) * 255).astype(
        np.uint8)
    for i in range(b):
        got = np.asarray(Image.open(out_dir / f"sample_{i}.png"))
        assert got.shape == (s, s, 3)
        assert np.abs(got.astype(int) - expected[i].astype(int)).max() <= 1


def test_epoch_stats_jsonl_over_an_image_folder(tmp_path):
    """One well-formed line per epoch boundary; the data come from an
    ImageNet-layout folder of PNGs (decoded with Pillow), 2 steps per
    epoch."""
    rng = np.random.default_rng(0)
    for c in range(3):
        d = tmp_path / "data" / "train" / f"n{c:08d}"
        d.mkdir(parents=True)
        for i in range(11):
            write_png(str(d / f"{i}.png"), rng.integers(
                0, 256, (40 + c, 50, 3), dtype=np.uint8))
    stats = tmp_path / "epochs.jsonl"
    cfg = get_config("tiny-cls", checkpoint_dir=str(tmp_path / "ckpt"),
                     epochs=2, global_batch_size=16, log_every=100,
                     dataset_root=str(tmp_path / "data"),
                     epoch_stats_path=str(stats))
    state = train(cfg, device="cpu")
    assert state.step == 4
    rows = [json.loads(line) for line in stats.read_text().splitlines()]
    assert len(rows) == 2
    for n, row in enumerate(rows):
        assert row["epoch"] == n and row["steps"] == 2
        assert row["wall_s"] > 0 and row["img_per_s"] > 0
        assert row["p50_step_s"] > 0 and row["rss_mb"] > 0
        assert np.isfinite(row["loss"])


def test_mesh_model_raises(tmp_path):
    """One process cannot hold a model axis of 2: the mesh must cover the
    world (tests/test_torch_parallel_trainer.py runs mesh_model=2 on four
    processes)."""
    cfg = get_config("tiny-cls", checkpoint_dir=str(tmp_path), mesh_model=2)
    with pytest.raises(ValueError, match="mesh_model=2"):
        train(cfg, device="cpu")


def test_sigterm_checkpoints_and_resumes(tmp_path):
    """A SIGTERM mid-training checkpoints and exits 0; a fresh process
    resumes at the saved step (tests/test_trainer_e2e.py:44-99)."""
    ckpt = str(tmp_path / "ckpt")
    cmd = [sys.executable, "-m", "calm_vit_dte_tpu_torch.train.train_cls",
           "--config", "tiny-cls", "--device", "cpu",
           f"checkpoint_dir={ckpt}", "epochs=1", "dataset_root=synthetic",
           "log_every=1"]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines = []
    deadline = time.time() + 60
    try:
        while time.time() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            if line.startswith("Epoch: 1, Batch: 1,"):
                break
        assert lines and lines[-1].startswith("Epoch: 1, Batch: 1,"), \
            "".join(lines)[-3000:]
        proc.send_signal(signal.SIGTERM)
        out = "".join(lines) + proc.communicate(timeout=60)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, out[-3000:]
    m = re.search(r"SIGTERM: checkpointed at step (\d+)", out)
    assert m, out[-3000:]
    step = int(m.group(1))
    assert latest_step(ckpt) == step < 64
    out2 = subprocess.run(cmd + ["--max-steps", "1"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=60)
    assert out2.returncode == 0, out2.stdout[-2000:] + out2.stderr[-2000:]
    assert f"resumed from step {step}" in out2.stdout, out2.stdout[-2000:]


class _Noise:
    """The same standard normals, call by call, on both sides."""

    def __init__(self):
        self.i = 0

    def __call__(self, shape):
        self.i += 1
        return np.random.default_rng(100 + self.i).standard_normal(
            shape).astype(np.float32)


@pytest.mark.parametrize("route", ["pallas", "xla"])
def test_fused_conv_step_matches_the_conv_chain(route, monkeypatch):
    """One fp32 tiny-cls step with CALM_CONV_FUSED=1 (under remat, so the
    Function's outputs are kept across the replay) against the same step on
    the F.conv2d chain: the same function through another formulation, at
    docs/ADR-bitexact.md's limits (loss rtol 1e-4, grad norm 1e-3,
    gradients rtol 5e-3 with a per-leaf atol of 2e-4 of the leaf's
    largest)."""
    cfg = get_config("tiny-cls")
    rng = np.random.default_rng(3)
    soft = rng.random((4, cfg.model.out_features)).astype(np.float32)
    batch = {"image": rng.standard_normal((4, cfg.crop, cfg.crop, 3)).astype(
        np.float32), "label": soft / soft.sum(-1, keepdims=True)}
    _, start = create_vit("tiny-cls", seed=4, device="cpu")
    sd = start.state_dict()

    def step(fused, remat):
        monkeypatch.setenv("CALM_CONV_FUSED", fused)
        monkeypatch.setenv("CALM_CONV_BWD", route)
        _, model = create_vit("tiny-cls", device="cpu")
        model.load_state_dict(sd)
        tx = make_optimizer(steps_per_epoch=10)
        fn = make_train_step(cfg.model, tx, "cls", dtype=torch.float32,
                             remat=remat)
        with noise_override(_Noise()):
            _, m = fn(create_train_state(model, tx, seed=0), batch)
        return ({k: float(v) for k, v in m.items()},
                {k: p.grad.clone() for k, p in model.named_parameters()})

    (m_f, g_f), (m_c, g_c) = step("1", True), step("", False)
    np.testing.assert_allclose(m_f["loss"], m_c["loss"], rtol=1e-4)
    np.testing.assert_allclose(m_f["grad_norm"], m_c["grad_norm"], rtol=1e-3)
    for k, want in g_c.items():
        top = float(want.abs().max())
        torch.testing.assert_close(g_f[k], want, rtol=5e-3, atol=2e-4 * top,
                                   msg=lambda m, k=k: f"{k}: {m}")
