"""The training proof's reg step against the JAX package's on the proof's
own data (tools/train_proof.py's corpus and batch order), at tiny-reg on
the CPU."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import torch

from calm_vit_dte_tpu.models.vit import ViTConfig as JViTConfig
from calm_vit_dte_tpu.models.vit import vit_init
from calm_vit_dte_tpu.ops.variational import noise_override as jax_noise
from calm_vit_dte_tpu.train.optim import make_optimizer as jax_make_optimizer
from calm_vit_dte_tpu.train.state import (
    create_train_state as jax_create_train_state,
)
from calm_vit_dte_tpu.train.step import make_train_step as jax_make_train_step
from calm_vit_dte_tpu_torch.compat.from_jax import (
    adamw_state_from_jax,
    params_to_jax,
    state_dict_from_jax,
)
from calm_vit_dte_tpu_torch.data.corpus import make_corpus
from calm_vit_dte_tpu_torch.data.loader import ImageFolderDataset
from calm_vit_dte_tpu_torch.data.pipeline import make_eval_preprocess
from calm_vit_dte_tpu_torch.models.vit import ViT
from calm_vit_dte_tpu_torch.ops.variational import noise_override
from calm_vit_dte_tpu_torch.train.optim import make_optimizer
from calm_vit_dte_tpu_torch.train.state import TrainState
from calm_vit_dte_tpu_torch.train.step import make_train_step
from calm_vit_dte_tpu_torch.utils.configs import TINY_VIT

torch.set_num_threads(1)


class NoiseSeq:
    """Call n returns standard normal noise from seed 1000 + n."""

    def __init__(self):
        self.i = 0

    def __call__(self, shape):
        arr = np.random.default_rng(1000 + self.i).standard_normal(shape)
        self.i += 1
        return arr.astype(np.float32)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def test_reg_proof_steps_follow_jax_on_the_corpus(tmp_path):
    """The reg proof's step on its own data: tiny-reg, the learnable
    corpus's images in the proof's batch order (`default_rng(0).choice`),
    eval-preprocessed once and fed to both sides (augmentation draws from
    each framework's own generator, so it is left out), fp32, the same
    injected noise. As in tests/test_torch_train_step_jax.py, the JAX step
    takes the first batch alone, so that Adam's first update (g / (|g| +
    eps), which turns fp32 noise in near-zero gradients into whole steps)
    is not compared; then weights, u/v and optimizer state are carried to
    the port and both take the next 4 batches, compared after each at
    tests/test_parity_grad.py's limits (losses rtol 2e-4, grad norms 2e-3,
    kl 2e-4, parameters rtol 1e-3 / atol 5e-4 of the leaf's largest
    value)."""
    root = make_corpus(tmp_path / "corpus", n_train=16, n_val=4,
                       num_classes=10, size=64, mode="learnable", seed=12)
    ds = ImageFolderDataset(str(root), split="train", size=56)
    imgs, _ = ds.load_batch(np.arange(len(ds)))
    pre = make_eval_preprocess(48)
    rng = np.random.default_rng(0)
    batches = [{"image": pre({"image": torch.from_numpy(
        imgs[rng.choice(len(imgs), 8, replace=False)])})["image"].numpy()}
        for _ in range(5)]

    cfg = replace(TINY_VIT, out_features=144, generate=True)
    jcfg = JViTConfig(**{f: getattr(cfg, f) for f in (
        "heads", "seq_length", "in_features", "dim_step", "mean_var_hidden",
        "seq_len_step", "seq_len_reduce", "out_features", "generate")})
    params, sn = vit_init(jcfg, jax.random.PRNGKey(0))
    opt = dict(base_lr=1e-3, weight_decay=0.02, b1=0.9, b2=0.98, epochs=1,
               steps_per_epoch=5)
    jtx = jax_make_optimizer(**opt)
    jstate = jax_create_train_state(params, sn, jtx, jax.random.PRNGKey(1))
    jstep = jax.jit(jax_make_train_step(jcfg, jtx, "reg", dtype=jnp.float32,
                                        remat=False))
    with jax_noise(NoiseSeq()):
        jstep = jstep.lower(jstate, jax.tree.map(jnp.asarray,
                                                 batches[0])).compile()
    jstate, _ = jstep(jstate, jax.tree.map(jnp.asarray, batches[0]))
    model = ViT(cfg, torch.Generator().manual_seed(0))
    model.load_state_dict(state_dict_from_jax(np_tree(jstate.params),
                                              np_tree(jstate.sn_state)))
    tx = make_optimizer(**opt)
    o = jstate.opt_state
    state = TrainState(model=model, step=int(jstate.step), seed=1,
                       opt_state=adamw_state_from_jax(
                           np_tree(jstate.params), o.count, o.mu, o.nu,
                           model))
    step = make_train_step(cfg, tx, "reg", dtype=torch.float32, remat=False)
    for i, batch in enumerate(batches[1:]):
        what = f"reg proof step {i + 2}"
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        with noise_override(NoiseSeq()):
            state, m = step(state, batch)
        for name, rtol in (("loss", 2e-4), ("grad_norm", 2e-3), ("kl", 2e-4)):
            np.testing.assert_allclose(float(m[name]), float(jm[name]),
                                       rtol=rtol, err_msg=f"{what}: {name}")
        back = params_to_jax(model, np_tree(jstate.params))
        for (path, got), (_, want) in zip(
                jax.tree_util.tree_leaves_with_path(back),
                jax.tree_util.tree_leaves_with_path(np_tree(jstate.params))):
            np.testing.assert_allclose(
                got, want, rtol=1e-3,
                atol=5e-4 * max(np.abs(want).max(), 1e-12),
                err_msg=f"{what}: {jax.tree_util.keystr(path)}")


def test_reg_target_jitted_augmentation_against_eager(tmp_path):
    """The reg target at the proof's sizes (corpus 384 px, decoded to 256,
    cropped to 224): the port's `apply_augment` on JAX's draws is the eager
    JAX result; JAX's jitted `augment_batch` (the script's) departs from it
    where XLA re-evaluates the hue's max tests, by a Huber loss (0.5 x MSE)
    under a tenth of the JAX proof's last-window loss
    (docs/evidence/train_proof_reg.json)."""
    import json
    import pathlib

    from _reg_trajectory_jax import jax_augment_draws
    from calm_vit_dte_tpu.data.augment import augment_batch
    from calm_vit_dte_tpu_torch.data.augment import apply_augment

    evidence = json.loads((pathlib.Path(__file__).resolve().parents[1]
                           / "docs" / "evidence"
                           / "train_proof_reg.json").read_text())
    last = evidence["history"][-1]["loss"]
    root = make_corpus(tmp_path / "corpus", n_train=16, n_val=0,
                       num_classes=10, size=384, mode="learnable", seed=12)
    imgs, _ = ImageFolderDataset(str(root), split="train",
                                 size=256).load_batch(np.arange(16))
    jitted = jax.jit(lambda k, x: augment_batch(k, x, crop=224))
    for seed in (100, 101):
        key = jax.random.PRNGKey(seed)
        want_jit = np.asarray(jitted(key, jnp.asarray(imgs)))
        with jax.disable_jit():
            want_eager = np.asarray(augment_batch(key, jnp.asarray(imgs),
                                                  crop=224))
        got = apply_augment(torch.from_numpy(imgs),
                            jax_augment_draws(key, 16, 256, 224),
                            crop=224).numpy()
        np.testing.assert_allclose(got, want_eager, rtol=1e-5, atol=1e-5)
        mse = float(np.mean((want_jit - want_eager) ** 2))
        print(f"key {seed}: jitted against eager: MSE {mse:.3g}, values "
              f"apart by > 1e-3 "
              f"{np.mean(np.abs(want_jit - want_eager) > 1e-3):.3g}")
        assert 0.5 * mse < 0.1 * last
