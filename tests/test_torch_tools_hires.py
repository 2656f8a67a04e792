"""The hires tools against the JAX package's scripts/bench_hires_train.py
(loaded by path; it imports JAX only inside main): the byte accounting is
the script's; and both hires tools' `--device cpu` runs at tiny-cls (the
hires config itself is for the card, chip_smoke.py phase 14): the steps,
the accounting of the run's parameters and the serving modes, each writing
only its JSON."""

import importlib.util
import math
import pathlib

import pytest
import torch

from calm_vit_dte_tpu_torch.tools import bench_hires_serve, bench_hires_train

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
NO_CARD = {"name": None, "nvidia_smi": None}


def _jax_accounting():
    spec = importlib.util.spec_from_file_location(
        "jax_bench_hires_train", ROOT / "scripts" / "bench_hires_train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.accounting


@pytest.mark.parametrize("moment_bytes", [2, 4])
@pytest.mark.parametrize("n_params,batch", [(935_566_976, 2),
                                            (935_566_976, 8),
                                            (42_577_130, 128)])
def test_accounting_is_the_jax_scripts(n_params, batch, moment_bytes):
    jax = _jax_accounting()(n_params, batch, moment_bytes)
    assert bench_hires_train.accounting(n_params, batch, moment_bytes) == jax


def test_hires_train_and_serve_tools_on_the_cpu(tmp_path,
                                                ):
    """The hires tools' paths at tiny-cls (the hires config is for the
    card): the accounting, the steps and the serving modes."""
    out = bench_hires_train.main([
        "--device", "cpu", "--config", "tiny-cls", "--batch", "2",
        "--steps", "2", "--moment-dtype", "fp32", "--out", str(tmp_path)])
    assert out["status"] == "trained" and len(out["losses"]) == 2
    assert all(math.isfinite(x) for x in out["losses"])
    assert out["accounting"] == bench_hires_train.accounting(
        out["accounting"]["n_params"], 2, 4)
    assert out["p50_step_s"] is None and "hbm_peak_gb" not in out
    serve = bench_hires_serve.main([
        "--device", "cpu", "--config", "tiny-cls", "--batch", "1",
        "--modes", "bf16,int8", "--out", str(tmp_path)])
    assert [(r["mode"], r["batch"], r["finite"]) for r in serve["rows"]] \
        == [("bf16", 1, True), ("int8", 1, True)]
    assert serve["status"] == "served" and serve["card"] == NO_CARD
    assert {p.name for p in tmp_path.iterdir()} == {
        "hires_train_fp32.json", "hires_serve.json"}
