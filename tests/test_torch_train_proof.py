"""tools/train_proof.py at the tiny configs on the CPU: three steps of each
mode on a 16-image corpus at 64 px; finite losses, the JAX script's JSON
keys and the port's own, files only under the given output directory."""

import hashlib
import json
import math
import pathlib

import pytest
import torch

from calm_vit_dte_tpu_torch.tools import train_proof

torch.set_num_threads(1)

EVIDENCE = pathlib.Path(__file__).resolve().parents[1] / "docs" / "evidence"
PORT_KEYS = {"card", "decoder", "decoder_reason", "pillow_images",
             "native_libjpeg",
             "ms_per_step", "first_step_ms", "peak_mem_gib",
             "rope_launches_per_step", "step_losses", "step_kls",
             "init_seed"}


def _evidence_digest():
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(EVIDENCE.glob("*")) if p.is_file()}


@pytest.mark.parametrize("mode,config", [("overfit", "tiny-cls"),
                                         ("generalize", "tiny-cls"),
                                         ("reg", "tiny-reg")])
def test_train_proof_tiny(tmp_path, mode, config):
    before = _evidence_digest()
    out_dir = tmp_path / "out"
    out = train_proof.run([
        mode, "--config", config, "--device", "cpu", "--steps", "3",
        "--batch", "8", "--n-train", "16", "--eval-every", "2",
        "--corpus-size", "64", "--root", str(tmp_path / "corpus"),
        "--out", str(out_dir)])
    assert _evidence_digest() == before   # the JAX package's evidence
    written = json.loads((out_dir / f"train_proof_{mode}.json").read_text())
    assert written == json.loads(json.dumps(out))
    # Every key of the JAX script's JSON, and the port's own.
    jax_keys = set(json.loads(
        (EVIDENCE / f"train_proof_{mode}.json").read_text()))
    jax_keys = {k for k in jax_keys if not k.startswith("probe_mse_step")}
    assert jax_keys | PORT_KEYS <= set(out)
    assert out["backend"] == "cpu" and out["decoder"] == "native"
    assert out["card"] == {"name": None, "nvidia_smi": None}
    assert out["ms_per_step"] is None and out["peak_mem_gib"] is None
    assert len(out["step_losses"]) == len(out["step_kls"]) == 3
    assert out["init_seed"] == 0
    assert all(math.isfinite(v) for v in out["step_losses"])
    assert [h["step"] for h in out["history"]] == [2, 3]
    assert all(math.isfinite(h["loss"]) for h in out["history"])
    # The plain versions run on the CPU: no kernel launches.
    assert out["rope_launches_per_step"] == {"attention_fwd": [0],
                                             "attention_bwd": [0]}
    if mode == "reg":
        assert math.isfinite(out["probe_mse_step3"])
        assert out["probe_step0_finite"]
        assert {p.name for p in out_dir.iterdir()} == {
            "train_proof_reg.json", "reg_inputs.png",
            "reg_samples_step0.png", "reg_samples_step3.png"}
    else:
        split = "train" if mode == "overfit" else "val"
        assert out["eval_split"] == split
        assert all(0.0 <= h[f"{split}_top1"] <= 1.0 for h in out["history"])
        assert out["n_eval"] == (16 if mode == "overfit" else 4)
        assert out["eval_launches_per_forward"] == {"attention": 0.0,
                                                    "conv": 0.0}
        assert {p.name for p in out_dir.iterdir()} == {
            f"train_proof_{mode}.json"}


def test_train_proof_defaults():
    """The script's defaults: config and corpus size by mode, batch 128,
    output beside (never into) the JAX package's evidence."""
    args = train_proof.parse_args(["reg"])
    assert (args.config, args.n_train, args.batch, args.steps,
            args.eval_every, args.lr) == ("imagenet-reg-224", 2048, 128, 800,
                                          100, 1e-3)
    assert train_proof.parse_args(["overfit"]).n_train == 512
    assert train_proof.parse_args(["overfit"]).config == "imagenet-cls-224"
    assert pathlib.Path(args.out) == EVIDENCE / "torch_h100"
    assert args.device == "cuda" and args.corpus_size == 384

