"""The ported benchmark tools on the CPU at tiny-cls size (the hires tools:
test_torch_tools_hires.py; the soak: test_torch_tools_soak.py): each tool's
`--device cpu` run ends, writes only its JSON under the given directory,
fills the JAX script's fields (the dataplane JSON's keys are those of the
JAX evidence, read only, beside the port's own) and puts no device figure
where no card ran. The training, evaluation and serving numerics they call
are held against the JAX package by the other test_torch_* files; these
tests do not repeat that."""

import hashlib
import json
import math
import pathlib

import pytest
import torch

from calm_vit_dte_tpu_torch.models.factory import create_vit
from calm_vit_dte_tpu_torch.tools import (
    bench_dataplane,
    bench_eval_50k,
    bench_quantize,
    profile_opt,
)

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
EVIDENCE = ROOT / "docs" / "evidence"
NO_CARD = {"name": None, "nvidia_smi": None}
# The port's own keys beside the JAX JSON's.
PORT_DATAPLANE_KEYS = {"card", "device", "torch", "native_libjpeg",
                       "corpus"}
PORT_INTEGRATED_KEYS = {"chains", "synthetic_ms_per_step",
                        "real_loader_ms_per_step",
                        "real_loader_wait_ms_per_step", "config", "remat",
                        "dtype", "losses_finite", "peak_mem_gib", "decoder",
                        "decoder_reason", "pillow_images", "disk_steps",
                        "kernel_launches", "kernel_launches_per_step"}


def _evidence_digest():
    return {str(p.relative_to(EVIDENCE)): hashlib.sha256(
        p.read_bytes()).hexdigest() for p in sorted(EVIDENCE.rglob("*"))
        if p.is_file()}


@pytest.fixture
def evidence_untouched():
    before = _evidence_digest()
    yield
    assert _evidence_digest() == before


def test_dataplane_on_the_cpu(tmp_path, evidence_untouched):
    out = bench_dataplane.main([
        "--device", "cpu", "--config", "tiny-cls", "--images", "32",
        "--n-train", "32", "--steps", "2", "--chains", "1", "--batch", "8",
        "--repeat", "1", "--root", str(tmp_path / "corpus"),
        "--out", str(tmp_path / "out")])
    jax = json.loads((EVIDENCE / "dataplane.json").read_text())
    assert set(out) - PORT_DATAPLANE_KEYS == set(jax)
    assert set(out["standalone"]) == set(jax["standalone"])
    assert set(out["integrated"]) - PORT_INTEGRATED_KEYS == \
        set(jax["integrated"])
    assert set(out["stall_analysis"]) == set(jax["stall_analysis"])
    integ = out["integrated"]
    assert integ["decoder"] == "native" and integ["pillow_images"] == 0
    assert integ["losses_finite"] and integ["disk_steps"] == 2
    assert integ["kernel_launches"] == {}   # plain versions on the CPU
    assert out["card"] == NO_CARD and integ["peak_mem_gib"] is None
    assert out["standalone"]["n_images"] == 32
    assert all(math.isfinite(v) and v > 0 for k, v in
               out["standalone"].items() if k.endswith("_per_s"))
    written = json.loads((tmp_path / "out" / "dataplane.json").read_text())
    assert written == json.loads(json.dumps(out))
    assert {p.name for p in (tmp_path / "out").iterdir()} == {
        "dataplane.json"}


def test_eval_on_16_staged_images(tmp_path, evidence_untouched):
    out = bench_eval_50k.main([
        "--device", "cpu", "--config", "tiny-cls", "--classes", "2",
        "--per-class", "8", "--batch", "8",
        "--corpus", str(tmp_path / "corpus"), "--out",
        str(tmp_path / "out")])
    jax = json.loads((EVIDENCE / "eval_50k.json").read_text())
    assert set(jax) <= set(out)
    assert out["images"] == out["corpus_images"] == 16
    assert 0.0 <= out["top1"] <= 1.0
    assert bench_eval_50k.accounting_fault(out["exact_s"]) is None
    assert out["decoder"] == "native" and out["card"] == NO_CARD
    assert out["kernel_launches"] == {}
    assert (tmp_path / "corpus" / "val" / "class_0001" /
            "img_00007.jpg").is_file()
    assert not (tmp_path / "corpus" / "train").exists()


@pytest.mark.parametrize("exact,fault", [
    # Nested exactly (0.0151 + 0.0471 = 0.0622): rounded, 0.02 + 0.05 passes
    # 0.06 + 0.01 in float arithmetic, so the rounded check failed.
    ({"loader_wait": 0.0151, "device": 0.0471, "wall": 0.0622}, False),
    # Within the slack.
    ({"loader_wait": 1.0, "device": 2.0, "wall": 2.995}, False),
    # Past the wall by more than the slack.
    ({"loader_wait": 1.0, "device": 2.0, "wall": 2.985}, True),
])
def test_eval_accounting_checks_unrounded_seconds(exact, fault):
    """bench_eval_50k holds loader wait + device <= wall + SLACK_S on the
    unrounded seconds; the rounded keys' sum can pass the rounded wall
    with no fault."""
    rounded = {k: round(v, 2) for k, v in exact.items()}
    assert bench_eval_50k.SLACK_S == 0.01
    if not fault:
        assert exact["loader_wait"] + exact["device"] <= exact["wall"] + 0.01
    assert (bench_eval_50k.accounting_fault(exact) is not None) == fault
    if exact["wall"] == 0.0622:
        assert rounded["loader_wait"] + rounded["device"] > \
            rounded["wall"] + 0.01


def test_profile_opt_on_the_cpu(tmp_path, evidence_untouched):
    out = profile_opt.main([
        "--device", "cpu", "--config", "tiny-cls", "--reps", "2",
        "--warmup", "1", "--step-batch", "4", "--step-reps", "1",
        "--out", str(tmp_path)])
    assert out["timing"] == "host_ms" and out["card"] == NO_CARD
    assert set(out["variants"]) == {"fused_adamw_fp32", "fused_adamw_bf16",
                                    "global_norm", "apply_fp32",
                                    "apply_bf16"}   # yardsticks: card only
    assert all(v["host_ms"] > 0 for v in out["variants"].values())
    assert out["step"]["ms"] > 0 and out["optimizer_share_of_step"] > 0
    _, model = create_vit("tiny-cls", device="cpu")
    assert out["n_params"] == sum(p.numel() for p in model.parameters())


def test_fused_adamw_update_is_global_norm_then_apply():
    """profile_opt times `global_norm` and `apply` apart: together they are
    `update`, bit for bit."""
    from calm_vit_dte_tpu_torch.train.optim import make_optimizer

    gen = torch.Generator().manual_seed(0)
    params = [torch.randn(5, 3, generator=gen), torch.randn(7, generator=gen)]
    grads = [torch.randn_like(p) * 3 for p in params]
    tx = make_optimizer(moment_dtype=torch.bfloat16)
    a, b = [p.clone() for p in params], [p.clone() for p in params]
    sa, sb = tx.init(a), tx.init(b)
    for _ in range(2):
        tx.update(a, grads, sa)
        gn = tx.global_norm(grads)
        tx.apply(b, grads, sb, float(gn))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(torch.equal(x, y) for x, y in zip(sa.mu + sa.nu,
                                                 sb.mu + sb.nu))
    assert float(sa.gnorm) == float(gn) and sa.count == sb.count == 2


def test_quantize_at_batch_4(tmp_path, evidence_untouched):
    out = bench_quantize.main([
        "--device", "cpu", "--config", "tiny-cls", "--batches", "4",
        "--iters", "2", "--warmup", "1", "--out", str(tmp_path)])
    assert [(r["batch"], r["mode"]) for r in out["rows"]] == [
        (4, "int8"), (4, "int8-wo")]
    fields = {"batch", "bf16_img_s", "bf16_p50_ms", "int8_img_s",
              "int8_p50_ms", "speedup", "logit_rel_err", "top1_agree"}
    for r in out["rows"]:
        assert fields <= set(r)
        assert r["logit_rel_err"] < 0.15 and r["top1_agree"] >= 0.75
        assert r["bf16_img_s"] is None and r["speedup"] is None
    assert out["failed"] == [] and out["limits"] == {
        "logit_rel_err_below": 0.15, "top1_agree_at_least": 0.75}


def test_tools_run_on_the_card_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        profile_opt.main(["--config", "tiny-cls", "--out", str(tmp_path)])
    with pytest.raises(RuntimeError, match="cuda"):
        bench_quantize.main(["--config", "tiny-cls", "--out",
                             str(tmp_path)])
