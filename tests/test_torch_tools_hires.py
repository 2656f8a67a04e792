"""The hires tools against the JAX package's scripts/bench_hires_train.py
(loaded by path; it imports JAX only inside main): the byte accounting is
the script's; and both hires tools' `--device cpu` runs at tiny-cls (the
hires config itself is for the card, chip_smoke.py phase 14): the steps,
the accounting of the run's parameters and the serving modes, each writing
only its JSON. The kernel timer `time_hires` (card only): its kernel
families name every hires kernel of the sources, and its --dtype reaches
the inputs it makes."""

import importlib.util
import math
import pathlib
import re
import types

import pytest
import torch

from calm_vit_dte_tpu_torch.tools import (
    bench_hires_serve,
    bench_hires_train,
    time_hires,
)

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


CSRC = ROOT / "calm_vit_dte_tpu_torch" / "csrc"
# The part each hires kernel's time belongs to, by its name's prefix.
PART_BY_PREFIX = {"hires_attention": "attention forward",
                  "hires_dm_ssum": "dm/ssum", "hires_dq": "dq",
                  "hires_dkv": "dk/dv", "gemm": "strided product",
                  "sum_partials": "weight-grad partial sums",
                  "colsum": "bias-grad sums", "sum_splits": "bias-grad sums"}


def test_time_hires_parts_name_every_hires_kernel():
    """Every __global__ kernel of the hires sources falls in its family of
    `time_hires.PARTS` (as the profiler names it: demangled, in the
    anonymous namespace), none in "other"."""
    names = set()
    for path in [*CSRC.glob("hires_*.cu"), *CSRC.glob("hires_*.cuh")]:
        names |= set(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
            r"(\w+)\s*\(", path.read_text()))
    assert {"hires_attention_kernel", "hires_dm_ssum_kernel",
            "hires_dq_kernel", "hires_dkv_kernel", "gemm_kernel",
            "gemm_tc_kernel"} <= names
    for name in sorted(names):
        part = next(p for prefix, p in PART_BY_PREFIX.items()
                    if name.startswith(prefix))
        key = f"void (anonymous namespace)::{name}<float, 8, true>(int)"
        assert time_hires.part_of(key) == part, name


@pytest.mark.parametrize("argv,dtype", [([], torch.bfloat16),
                                        (["--dtype", "float32"],
                                         torch.float32)])
def test_time_hires_dtype_reaches_its_inputs(monkeypatch, argv, dtype):
    """`time_hires --dtype` makes its inputs in that dtype (bf16 by
    default); the card, nvidia-smi and the inputs are stood in for."""
    seen = []

    class Made(Exception):
        pass

    def inputs(*args, dtype=torch.bfloat16, **kw):
        seen.append(dtype)
        raise Made

    monkeypatch.setattr(time_hires.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(time_hires.subprocess, "run",
                        lambda *a, **k: types.SimpleNamespace(
                            stdout="NVIDIA H100 80GB HBM3, 700.00 W\n"))
    monkeypatch.setattr(time_hires, "inputs", inputs)
    with pytest.raises(Made):
        time_hires.main(["--heads", "6", "--no-yardsticks", *argv])
    assert seen == [dtype]

