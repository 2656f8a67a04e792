"""The port stands alone: importing it (and chip_smoke.py) loads neither JAX
nor the JAX package, and its entry points never fall back to the CPU."""

import json
import pathlib
import subprocess
import sys

import pytest
import torch

from calm_vit_dte_tpu_torch.models.factory import create_vit
from calm_vit_dte_tpu_torch.serve import Predictor

ROOT = pathlib.Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, importlib.util, json, pkgutil, sys
import calm_vit_dte_tpu_torch as pkg
names = [m.name for m in
         pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps({"imported": names, "modules": sorted(sys.modules)}))
"""


def test_port_imports_no_jax():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "calm_vit_dte_tpu_torch.serve" in report["imported"]
    assert "calm_vit_dte_tpu_torch.kernels.axial_attention" in \
        report["imported"]
    for name in ("train.step", "train.state", "train.optim", "train.losses",
                 "train.checkpoint", "train.samples", "train.trainer",
                 "train.train_cls", "train.train_reg", "data.sampler",
                 "data.loader", "data.augment", "data.mixup",
                 "data.pipeline", "utils.logging", "tools.ablate_conv_bwd",
                 "tools.canary_probes", "kernels.relayout", "quantize",
                 "train.evaluate", "utils.profiling", "data.corpus",
                 "data.native", "data.csv_dataset", "tools.train_proof",
                 "tools.reg_witness", "compat.orbax", "compat.jax_init",
                 "models.encoder_decoder", "parallel.mesh",
                 "tools.parallel_step", "tools.parallel_cards",
                 "tools.stage_dataset", "tools.bench_dataplane",
                 "tools.bench_eval_50k", "tools.soak",
                 "tools.bench_hires_train", "tools.bench_hires_serve",
                 "tools.bench_quantize", "tools.profile_opt"):
        assert f"calm_vit_dte_tpu_torch.{name}" in report["imported"]
    leaked = [m for m in report["modules"]
              if m.split(".")[0].startswith("jax")
              or m == "calm_vit_dte_tpu"
              or m.startswith("calm_vit_dte_tpu.")]
    assert leaked == []


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        Predictor.fresh("tiny-cls")


def test_training_model_defaults_to_the_card():
    """The train step runs where the model's parameters are; the model
    factory puts them on the card unless the caller passes device="cpu"."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        create_vit("tiny-cls")
    _, model = create_vit("tiny-cls", device="cpu")
    assert next(model.parameters()).device.type == "cpu"
