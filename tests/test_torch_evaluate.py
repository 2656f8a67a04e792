"""The port's top-1 evaluation (train/evaluate.py) on the CPU: known answers
on a planted val split (the recipe of tests/test_evaluate.py: 20 images at
batch 16, so the padded last batch holds 12 entries that must not count),
labels from the JAX package's own eval forward on carried weights, and one
quantized evaluation.

Weights have their spectral-norm power iteration converged first (the 30
warm-up iterations of Predictor.fresh) and reach evaluate through a port
checkpoint, so the model's predictions are not the degenerate ones of a raw
init.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from calm_vit_dte_tpu.compat.torch_export import _rename_back
from calm_vit_dte_tpu.models.factory import create_vit as jax_create_vit
from calm_vit_dte_tpu.nn.spectral_norm import normalize_tree as jax_normalize
from calm_vit_dte_tpu.serve import Predictor as JaxPredictor
from calm_vit_dte_tpu_torch.compat.from_jax import state_dict_from_jax
from calm_vit_dte_tpu_torch.models.factory import create_vit
from calm_vit_dte_tpu_torch.nn.spectral_norm import normalize_tree
from calm_vit_dte_tpu_torch.serve import WARMUP_POWER_ITERATIONS, Predictor
from calm_vit_dte_tpu_torch.train import evaluate as ev
from calm_vit_dte_tpu_torch.train.checkpoint import save_checkpoint
from calm_vit_dte_tpu_torch.train.optim import make_optimizer
from calm_vit_dte_tpu_torch.train.state import create_train_state
from calm_vit_dte_tpu_torch.utils.configs import get_config

torch.set_num_threads(1)

N_IMAGES = 20


def _plant(root, images, labels, offset=0):
    """An ImageFolder val split: image i in class directory
    (labels[i] + offset) % 10."""
    split = root / "val"
    if split.exists():
        shutil.rmtree(split)
    for c in range(10):
        (split / f"class_{c:03d}").mkdir(parents=True)
    for i, (img, label) in enumerate(zip(images, labels)):
        Image.fromarray(img).save(
            split / f"class_{(int(label) + offset) % 10:03d}" / f"{i:03d}.png")


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """A JAX tiny-cls init carried into the port, its power iteration
    converged there and written as a port checkpoint (step 0); 20 images;
    the port's own bf16 predictions on them; the JAX package's eval forward
    predictions on the same weights."""
    _, params, sn_state = jax_create_vit("tiny-cls", seed=0)
    params = jax.tree.map(np.asarray, params)
    sn_state = jax.tree.map(np.asarray, sn_state)
    _, model = create_vit("tiny-cls", device="cpu")
    model.load_state_dict(state_dict_from_jax(params, sn_state))
    with torch.no_grad():
        for _ in range(WARMUP_POWER_ITERATIONS):
            normalize_tree(model, training=True)
    ckpt = tmp_path_factory.mktemp("ckpt")
    save_checkpoint(str(ckpt), create_train_state(model, make_optimizer(),
                                                  seed=1))

    def carry_uv(node, path=()):
        if "u" in node and "v" in node:
            m = model.get_submodule(".".join(_rename_back(list(path))))
            node["u"], node["v"] = m.weight_u.numpy(), m.weight_v.numpy()
            return
        for key, sub in node.items():
            carry_uv(sub, path + (key,))

    carry_uv(sn_state)
    cfg = get_config("tiny-cls")
    images = np.random.default_rng(7).integers(
        0, 256, (N_IMAGES, cfg.image_size, cfg.image_size, 3),
        dtype=np.uint8)
    logits, _ = Predictor(model, crop=cfg.crop).predict(images)
    frozen = jax.jit(lambda p, s: jax_normalize(p, s, training=False)[0])(
        params, sn_state)
    jp = JaxPredictor(cfg.model, frozen, sn_state, crop=cfg.crop,
                      _prefrozen=True)
    jax_logits, _ = jp._predict(jp.params, jp.sn_state, jnp.asarray(images))
    port_preds = logits.float().argmax(-1).numpy()
    jax_preds = np.asarray(jnp.argmax(jax_logits, axis=-1))
    assert len(set(port_preds.tolist())) > 1   # not one class for all
    return ckpt, images, port_preds, jax_preds


def _cfg(root, ckpt):
    return get_config("tiny-cls", dataset_root=str(root),
                      checkpoint_dir=str(ckpt), num_workers=2)


@pytest.mark.parametrize("offset,want", [(0, 1.0), (1, 0.0)])
def test_evaluate_known_answers(tmp_path, carried, capsys, offset, want):
    """Labels equal to the model's own top-1 score exactly 1.0; shifted by
    one class, exactly 0.0. The second batch is padded by 12 entries."""
    ckpt, images, preds, _ = carried
    _plant(tmp_path, images, preds, offset)
    stats = {}
    assert ev.evaluate(_cfg(tmp_path, ckpt), stats_out=stats,
                       device="cpu") == want
    out = capsys.readouterr().out
    assert "evaluating checkpoint at step 0" in out
    assert f"over {N_IMAGES} images" in out
    assert stats["images"] == N_IMAGES
    assert set(stats) == {"wall_s", "images", "img_per_s", "loader_wait_s",
                          "device_s", "exact_s"}
    assert set(stats["exact_s"]) == {"wall", "loader_wait", "device"}
    for key in ("wall", "loader_wait", "device"):
        assert round(stats["exact_s"][key], 2) == stats[f"{key}_s"]


def test_evaluate_against_jax_labels(tmp_path, carried):
    """Labels from the JAX package's eval forward on the same weights: the
    port's bf16 forward agrees on at least 19 of 20."""
    ckpt, images, _, jax_preds = carried
    _plant(tmp_path, images, jax_preds)
    assert ev.evaluate(_cfg(tmp_path, ckpt), device="cpu") >= 19 / 20


def test_evaluate_quantized_and_cli(tmp_path, carried, capsys):
    """evaluate(quantize='int8-wo') through the CLI: on the planted
    all-correct split its top-1 agrees with bf16 on >= 90% of the images
    (tests/test_evaluate.py's limit); a fresh init is said to be one."""
    ckpt, images, preds, _ = carried
    _plant(tmp_path, images, preds)
    acc = ev.main(["--config", "tiny-cls", "--quantize", "int8-wo",
                   "--device", "cpu", f"dataset_root={tmp_path}",
                   f"checkpoint_dir={ckpt}", "num_workers=2"])
    assert acc >= 0.9
    ev.main(["--config", "tiny-cls", "--max-batches", "1", "--device",
             "cpu", f"dataset_root={tmp_path}",
             f"checkpoint_dir={tmp_path / 'none'}"])
    assert "no checkpoint found; evaluating fresh init" in \
        capsys.readouterr().out
