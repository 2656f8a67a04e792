"""The reg proof's trajectory in both packages at tiny-reg on the CPU, fp32:
the proof's corpus (learnable, seed 12) and batch order
(`default_rng(0).choice`), its optimizer over one epoch of the run, lr 1e-3,
and its preprocessing, the augmentation inside the step.

The JAX side is the script's path: `make_train_step(..., preprocess=
make_reg_preprocess(crop))`, jitted. The port starts from the JAX state
after the first step (weights, u/v and AdamW moments carried; see
tests/test_torch_train_step_jax.py) and takes the same batches under the
same injected noise. Its augmentation is either
  "jax":  the JAX package's jitted `augment_batch` output for the step's
          key, so that only the step differs; or
  "port": the port's `apply_augment` on the draws JAX makes from that key,
          which computes the eager JAX result (the jitted one differs where
          XLA re-evaluates the hue's max tests; ROADMAP's recorded
          divergences).

    python tests/_reg_trajectory_jax.py --steps 400

prints the window means of both sides' losses for both augmentations.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from calm_vit_dte_tpu.data.augment import augment_batch  # noqa: E402
from calm_vit_dte_tpu.data.pipeline import make_reg_preprocess  # noqa: E402
from calm_vit_dte_tpu.models.vit import ViTConfig as JViTConfig  # noqa: E402
from calm_vit_dte_tpu.models.vit import vit_init  # noqa: E402
from calm_vit_dte_tpu.ops.variational import (  # noqa: E402
    noise_override as jax_noise,
)
from calm_vit_dte_tpu.train.optim import (  # noqa: E402
    make_optimizer as jax_make_optimizer,
)
from calm_vit_dte_tpu.train.state import (  # noqa: E402
    create_train_state as jax_create_train_state,
)
from calm_vit_dte_tpu.train.step import (  # noqa: E402
    make_train_step as jax_make_train_step,
)
from calm_vit_dte_tpu_torch.compat.from_jax import (  # noqa: E402
    adamw_state_from_jax,
    params_to_jax,
    state_dict_from_jax,
)
from calm_vit_dte_tpu_torch.data.augment import apply_augment  # noqa: E402
from calm_vit_dte_tpu_torch.data.corpus import make_corpus  # noqa: E402
from calm_vit_dte_tpu_torch.data.loader import (  # noqa: E402
    ImageFolderDataset,
)
from calm_vit_dte_tpu_torch.models.vit import ViT  # noqa: E402
from calm_vit_dte_tpu_torch.ops.variational import (  # noqa: E402
    noise_override,
)
from calm_vit_dte_tpu_torch.train.optim import make_optimizer  # noqa: E402
from calm_vit_dte_tpu_torch.train.state import TrainState  # noqa: E402
from calm_vit_dte_tpu_torch.train.step import make_train_step  # noqa: E402
from calm_vit_dte_tpu_torch.utils.configs import TINY_VIT  # noqa: E402

SIZE, CROP, BATCH = 56, 48, 8          # tiny-reg's image size and crop


class NoiseSeq:
    """Call n returns standard normal noise from seed 1000 + n."""

    def __init__(self):
        self.i = 0

    def __call__(self, shape):
        arr = np.random.default_rng(1000 + self.i).standard_normal(shape)
        self.i += 1
        return arr.astype(np.float32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def jax_augment_draws(key, b: int, size: int, crop: int) -> dict:
    """The draws JAX's `augment_batch` makes from `key` (its own splits),
    as the port's `apply_augment` takes them."""
    keys = jax.random.split(key, 10)
    ky, kx = jax.random.split(keys[0])

    def u(k, lo, hi):
        return jax.random.uniform(k, (b,), minval=lo, maxval=hi)

    def coin(k, p):
        return jax.random.bernoulli(k, p, (b, 1, 1, 1)).reshape(-1)

    draws = {"tops": jax.random.randint(ky, (b,), 0, size - crop + 1),
             "lefts": jax.random.randint(kx, (b,), 0, size - crop + 1),
             "fb": u(keys[1], 0.5, 1.0), "fc": u(keys[2], 0.5, 1.0),
             "fs": u(keys[3], 0.5, 1.0), "fh": u(keys[4], -0.125, 0.125),
             "solarize": coin(keys[5], 0.5), "flip": coin(keys[6], 0.5),
             "gray": coin(keys[7], 0.1), "sigma": u(keys[8], 0.1, 2.0)}
    return {k: torch.from_numpy(np.asarray(v).copy())
            for k, v in draws.items()}


def trajectory(root, steps: int, augment: str, n_train: int = 64):
    """Losses of `steps` steps after the carried first one: (JAX's, the
    port's), and both sides' final parameters as JAX trees."""
    root = make_corpus(root, n_train=n_train, n_val=n_train // 4,
                       num_classes=10, size=64, mode="learnable", seed=12)
    imgs, _ = ImageFolderDataset(str(root), split="train",
                                 size=SIZE).load_batch(np.arange(n_train))
    rng = np.random.default_rng(0)
    batches = [imgs[rng.choice(n_train, BATCH, replace=False)]
               for _ in range(steps + 1)]

    cfg = replace(TINY_VIT, out_features=144, generate=True)
    jcfg = JViTConfig(**{f: getattr(cfg, f) for f in (
        "heads", "seq_length", "in_features", "dim_step", "mean_var_hidden",
        "seq_len_step", "seq_len_reduce", "out_features", "generate")})
    params, sn = vit_init(jcfg, jax.random.PRNGKey(0))
    opt = dict(base_lr=1e-3, weight_decay=0.02, b1=0.9, b2=0.98, epochs=1,
               steps_per_epoch=steps + 1)
    jtx = jax_make_optimizer(**opt)
    jstate = jax_create_train_state(params, sn, jtx, jax.random.PRNGKey(1))
    jstep = jax.jit(jax_make_train_step(
        jcfg, jtx, "reg", dtype=jnp.float32, remat=False,
        preprocess=make_reg_preprocess(CROP)))
    first = {"image": jnp.asarray(batches[0])}
    with jax_noise(NoiseSeq()):
        jstep = jstep.lower(jstate, first).compile()
    jstate, _ = jstep(jstate, first)

    model = ViT(cfg, torch.Generator().manual_seed(0))
    model.load_state_dict(state_dict_from_jax(_np(jstate.params),
                                              _np(jstate.sn_state)))
    o = jstate.opt_state
    state = TrainState(model=model, step=int(jstate.step), seed=1,
                       opt_state=adamw_state_from_jax(
                           _np(jstate.params), o.count, o.mu, o.nu, model))
    jax_augment = jax.jit(lambda k, x: augment_batch(k, x, crop=CROP))
    key = {}

    def preprocess(generator, batch):
        if augment == "jax":
            return {"image": torch.from_numpy(np.array(jax_augment(
                key["step"], jnp.asarray(batch["image"].numpy()))))}
        return {"image": apply_augment(
            batch["image"], jax_augment_draws(key["step"], BATCH, SIZE,
                                              CROP), crop=CROP)}

    step = make_train_step(cfg, make_optimizer(**opt), "reg",
                           dtype=torch.float32, remat=False,
                           preprocess=preprocess)
    jax_losses, port_losses = [], []
    for batch in batches[1:]:
        # The JAX step's data key: fold_in(fold_in(rng, step), 1).
        key["step"] = jax.random.fold_in(
            jax.random.fold_in(jstate.rng, jstate.step), 1)
        jstate, jm = jstep(jstate, {"image": jnp.asarray(batch)})
        with noise_override(NoiseSeq()):
            state, m = step(state, {"image": batch})
        jax_losses.append(float(jm["loss"]))
        port_losses.append(float(m["loss"]))
    return (np.array(jax_losses), np.array(port_losses),
            _np(jstate.params), params_to_jax(model, _np(jstate.params)))


def main() -> None:
    import tempfile

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(2)
    with tempfile.TemporaryDirectory() as tmp:
        for augment in ("jax", "port"):
            jl, pl, _, _ = trajectory(pathlib.Path(tmp) / "corpus",
                                      args.steps, augment)
            rel = np.abs(pl - jl) / np.abs(jl)
            w = max(args.steps // 8, 1)
            print(f"augmentation {augment!r}: {args.steps} steps after the "
                  f"carried first; largest per-step relative difference "
                  f"{rel.max():.3g}")
            for s in range(0, args.steps, w):
                print(f"  steps {s + 2}-{s + w + 1}: JAX "
                      f"{jl[s:s + w].mean():.5f} port {pl[s:s + w].mean():.5f}"
                      f" (largest per-step rel diff {rel[s:s + w].max():.3g})")
            print(f"  last / first window: JAX "
                  f"{jl[-w:].mean() / jl[:w].mean():.4f} port "
                  f"{pl[-w:].mean() / pl[:w].mean():.4f}", flush=True)


if __name__ == "__main__":
    main()
