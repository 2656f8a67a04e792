"""The port's whole serving forward: ViT goldens, the port's Predictor
against the JAX package's Predictor on the same carried weights (fp32,
CPU), serving artifacts (save/load) and Predictor.from_checkpoint."""

import functools
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calm_vit_dte_tpu.compat.torch_export import export_torch_state_dict
from calm_vit_dte_tpu.models.factory import create_vit as jax_create_vit
from calm_vit_dte_tpu.nn.spectral_norm import normalize_tree
from calm_vit_dte_tpu.serve import Predictor as JaxPredictor
from calm_vit_dte_tpu_torch.models.factory import create_vit
from calm_vit_dte_tpu_torch.models.vit import ViT
from calm_vit_dte_tpu_torch.serve import Predictor, main
from calm_vit_dte_tpu_torch.train.checkpoint import save_checkpoint
from calm_vit_dte_tpu_torch.train.optim import make_optimizer
from calm_vit_dte_tpu_torch.train.state import create_train_state
from calm_vit_dte_tpu_torch.utils.configs import get_config

torch.set_num_threads(1)

GOLDEN = pathlib.Path(__file__).parent / "golden"


@pytest.mark.parametrize("name,config", [("vit_cls_tiny", "tiny-cls"),
                                         ("vit_reg_tiny", "tiny-reg")])
def test_vit_golden(name, config):
    d = np.load(GOLDEN / f"{name}.npz")
    model = ViT(get_config(config).model,
                torch.Generator().manual_seed(0)).eval()
    model.load_state_dict({k[3:]: torch.from_numpy(d[k]) for k in d.files
                           if k.startswith("sd/")})
    x = torch.from_numpy(d["in/x"]).permute(0, 2, 3, 1)  # NCHW -> NHWC
    with torch.no_grad():
        y, kl = model(x)
    np.testing.assert_allclose(y.numpy(), d["out/y"], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(float(kl), d["out/kl"], rtol=1e-4)


@jax.jit
def _converge_and_freeze(params, state):
    """The JAX Predictor.fresh warm-up (30 power iterations), then the eval
    weights its constructor would freeze, as one compiled program."""
    state = jax.lax.fori_loop(
        0, 30, lambda _, s: normalize_tree(params, s, training=True)[1],
        state)
    return normalize_tree(params, state, training=False)[0], state


@functools.lru_cache(maxsize=None)
def _jax_side(config):
    """A JAX model from the JAX factory with its power iteration converged
    (params and u/v as numpy) and the JAX Predictor serving it, in fp32.
    Cached, so its predict compiles once for the file."""
    cfg, params, state = jax_create_vit(config, seed=0)
    frozen, state = _converge_and_freeze(params, state)
    jp = JaxPredictor(cfg, frozen, state, crop=get_config(config).crop,
                      dtype=jnp.float32, _prefrozen=True)
    return (jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state),
            jp)


def _jax_and_port(config):
    """The JAX Predictor, and the port's Predictor on the same carried
    weights."""
    params, state, jp = _jax_side(config)
    tp = Predictor.from_jax(config, params, state, device="cpu",
                            dtype=torch.float32)
    images = np.random.default_rng(0).integers(0, 256, (3, 56, 56, 3),
                                               dtype=np.uint8)
    return jp, tp, images


def test_predictor_classify_matches_jax():
    jp, tp, images = _jax_and_port("tiny-cls")
    ref_logits, ref_kl = jp._predict(jp.params, jp.sn_state,
                                     jnp.asarray(images))
    logits, kl = tp.predict(images)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(float(kl), float(ref_kl), rtol=1e-4)
    labels, probs = tp.classify(images, top_k=3)
    ref_labels, ref_probs = jp.classify(images, top_k=3)
    np.testing.assert_array_equal(labels, ref_labels)
    np.testing.assert_allclose(probs, ref_probs, rtol=1e-3, atol=1e-5)
    assert (np.diff(probs, axis=-1) <= 0).all()


def test_predictor_reconstruct_matches_jax():
    jp, tp, images = _jax_and_port("tiny-reg")
    out = tp.reconstruct(images)
    assert out.shape == (3, 48, 48, 3)
    np.testing.assert_allclose(out, jp.reconstruct(images), rtol=1e-3,
                               atol=1e-4)


@pytest.mark.parametrize("quantize", [None, "int8", "int8-wo"])
def test_serving_artifact_round_trip(tmp_path, quantize):
    """save() then load(): the same logits bit for bit, and the artifact's
    serving.json."""
    p = Predictor.fresh("tiny-cls", device="cpu", quantize=quantize)
    images = np.random.default_rng(1).integers(0, 256, (2, 56, 56, 3),
                                               dtype=np.uint8)
    want, _ = p.predict(images)
    p.save(str(tmp_path))
    meta = json.loads((tmp_path / "serving.json").read_text())
    assert meta["quantize"] == quantize and meta["crop"] == 48
    assert meta["config"] == "tiny-cls" and meta["dtype"] == "bfloat16"
    q = Predictor.load(str(tmp_path), config="tiny-cls", device="cpu")
    assert (q.quantize, q.crop, q.dtype) == (quantize, 48, torch.bfloat16)
    got, _ = q.predict(images)
    assert torch.equal(got, want)


def _edit_meta(path, **changes):
    meta = json.loads((path / "serving.json").read_text())
    meta.update(changes)
    (path / "serving.json").write_text(json.dumps(meta))


@pytest.mark.parametrize("fault,message", [
    ("config", "was saved from config 'tiny-cls'"),
    ("quantize", "invalid quantize mode 'int4'"),
    ("crop", "invalid crop -1"),
    ("fingerprint", "does not match its serving.json fingerprint")])
def test_serving_artifact_load_errors(tmp_path, fault, message):
    """Each error path of the JAX package's load(), with its message."""
    Predictor.fresh("tiny-cls", device="cpu").save(str(tmp_path))
    config = None
    if fault == "config":
        config = "tiny-reg"
    elif fault == "quantize":
        _edit_meta(tmp_path, quantize="int4")
    elif fault == "crop":
        _edit_meta(tmp_path, crop=-1)
    else:
        _edit_meta(tmp_path, n_params=1)
    with pytest.raises(ValueError, match=message):
        Predictor.load(str(tmp_path), config=config, device="cpu")


def test_from_checkpoint_of_the_trainer(tmp_path, capsys):
    """A trainer checkpoint directory serves the model it holds (here
    quantized, through the CLI too); an empty directory and a directory of
    another kind raise."""
    _, model = create_vit("tiny-cls", device="cpu")
    ckpt = tmp_path / "ckpt"
    save_checkpoint(str(ckpt), create_train_state(model, make_optimizer(),
                                                  seed=1))
    images = np.random.default_rng(2).integers(0, 256, (2, 56, 56, 3),
                                               dtype=np.uint8)
    want, _ = Predictor(model, crop=48, quantize="int8").predict(images)
    p = Predictor.from_checkpoint(str(ckpt), "tiny-cls", quantize="int8",
                                  device="cpu")
    got, _ = p.predict(images)
    assert torch.equal(got, want)
    main(["--config", "tiny-cls", "--device", "cpu", "--batch", "2",
          "--checkpoint", str(ckpt), "--quantize", "int8-wo"])
    assert "top-5 labels for 2 images" in capsys.readouterr().out
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        Predictor.from_checkpoint(str(tmp_path / "empty"), "tiny-cls",
                                  device="cpu")
    (tmp_path / "orbax" / "1").mkdir(parents=True)
    with pytest.raises(ValueError, match="Orbax"):
        Predictor.from_checkpoint(str(tmp_path / "orbax"), "tiny-cls",
                                  device="cpu")


def test_from_checkpoint_of_a_reference_pth(tmp_path):
    """A .pth written from the JAX package's weights by its own
    compat/torch_export.py serves what the JAX Predictor serves (fp32,
    rtol 1e-3 / atol 1e-4 as above)."""
    params, state, jp = _jax_side("tiny-cls")
    sd = export_torch_state_dict(params, state)
    path = tmp_path / "weights.pth"
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
               path)
    p = Predictor.from_checkpoint(str(path), "tiny-cls", device="cpu",
                                  dtype=torch.float32)
    images = np.random.default_rng(0).integers(0, 256, (3, 56, 56, 3),
                                               dtype=np.uint8)
    logits, _ = p.predict(images)
    ref, _ = jp._predict(jp.params, jp.sn_state, jnp.asarray(images))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), rtol=1e-3,
                               atol=1e-4)
    torch.save({"not_a_weight": torch.zeros(1)}, tmp_path / "bad.pth")
    with pytest.raises(KeyError, match="not_a_weight"):
        Predictor.from_checkpoint(str(tmp_path / "bad.pth"), "tiny-cls",
                                  device="cpu")
