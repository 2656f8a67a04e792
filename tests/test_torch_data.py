"""The port's data plane against the JAX package's, on the CPU.

The sampler and the loader are copies: same indices, masks and bytes. The
augmentation and CutMix/MixUp split their random draws from their
arithmetic; the port's arithmetic is fed the JAX package's own draws (taken
from the same keys inside the same jitted function as the JAX op) and must
give the JAX op's output in fp32 to 1e-5 (the same fp32 operations in the
same order; what differs is XLA's and torch's rounding of exp, erf-free
divisions and sums). The per-op goldens of tests/test_augment.py hold the
port's ops at that file's tolerances.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calm_vit_dte_tpu.data import augment as jax_augment
from calm_vit_dte_tpu.data import loader as jax_loader
from calm_vit_dte_tpu.data import pipeline as jax_pipeline
from calm_vit_dte_tpu.data import sampler as jax_sampler
from calm_vit_dte_tpu.data.mixup import cutmix_or_mixup as jax_mix
from calm_vit_dte_tpu_torch.data import augment, loader, mixup, pipeline
from calm_vit_dte_tpu_torch.data.sampler import ShardedSampler

torch.set_num_threads(1)

GOLDEN = np.load(pathlib.Path(__file__).parent / "golden"
                 / "augment_ops.npz")


@pytest.mark.parametrize("size,shards,shard,epoch,drop_last", [
    (37, 1, 0, 0, False), (37, 4, 3, 2, False), (100, 8, 5, 7, True),
    (1024, 3, 1, 11, False)])
def test_sampler_matches_jax(size, shards, shard, epoch, drop_last):
    ours = ShardedSampler(size, shards, shard, drop_last=drop_last)
    ref = jax_sampler.ShardedSampler(size, shards, shard,
                                     drop_last=drop_last)
    ours.set_epoch(epoch)
    ref.set_epoch(epoch)
    assert len(ours) == len(ref)
    np.testing.assert_array_equal(ours.indices(), ref.indices())
    np.testing.assert_array_equal(ours.valid_mask(), ref.valid_mask())
    assert list(ours) == list(ref)


@pytest.mark.parametrize("pad_last", [False, True])
def test_loader_batches_match_jax(pad_last):
    def batches(mod):
        ds = mod.SyntheticDataset(n=37, num_classes=5, size=8)
        sampler = (ShardedSampler if mod is loader
                   else jax_sampler.ShardedSampler)(37, 2, 1)
        sampler.set_epoch(3)
        return list(mod.BatchLoader(ds, sampler, 8, num_workers=3,
                                    prefetch=1, pad_last=pad_last))

    ours, ref = batches(loader), batches(jax_loader)
    assert len(ours) == len(ref) == (3 if pad_last else 2)
    for a, b in zip(ours, ref):
        assert sorted(a) == sorted(b)
        for key in a:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key])
    assert ("valid" in ours[-1]) == pad_last


def test_loader_raises_on_a_failing_worker():
    class Broken(loader.SyntheticDataset):
        def load(self, idx):
            if idx == 5:
                raise OSError("corrupt file")
            return super().load(idx)

    sampler = ShardedSampler(16, 1, 0, shuffle=False)
    it = loader.BatchLoader(Broken(n=16, size=4), sampler, 4, num_workers=2)
    with pytest.raises(RuntimeError, match="batch 1") as info:
        list(it)
    assert isinstance(info.value.__cause__, OSError)


@pytest.fixture(scope="module")
def imgs():
    return torch.from_numpy(GOLDEN["imgs_u8"].astype(np.float32) / 255.0)


def test_grayscale_brightness_contrast_saturation_goldens(imgs):
    f = torch.from_numpy(GOLDEN["factors"])[:, None, None, None]
    np.testing.assert_allclose(augment._grayscale(imgs).numpy(),
                               GOLDEN["grayscale"], atol=1e-6)
    np.testing.assert_allclose(torch.clamp(imgs * f, 0, 1).numpy(),
                               GOLDEN["brightness"], atol=1e-6)
    mean_gray = augment._grayscale(imgs).mean(dim=(1, 2, 3), keepdim=True)
    np.testing.assert_allclose(
        torch.clamp(augment._blend(imgs, mean_gray, f), 0, 1).numpy(),
        GOLDEN["contrast"], atol=1e-6)
    np.testing.assert_allclose(
        torch.clamp(augment._blend(imgs, augment._grayscale(imgs), f), 0,
                    1).numpy(), GOLDEN["saturation"], atol=1e-6)


def test_hue_blur_normalize_solarize_goldens(imgs):
    deltas = torch.from_numpy(GOLDEN["hue_deltas"])[:, None, None]
    err = np.abs(augment._adjust_hue(imgs, deltas).numpy()
                 - GOLDEN["hue"]).max()
    assert err < 3e-5, f"hue max deviation {err}"
    np.testing.assert_allclose(
        augment._gaussian_blur3(imgs, torch.from_numpy(
            GOLDEN["sigmas"])).numpy(), GOLDEN["blur"], atol=1e-5)
    np.testing.assert_allclose(augment._normalize(imgs).numpy(),
                               GOLDEN["normalize"], atol=1e-5)
    x = torch.from_numpy(GOLDEN["imgs_u8"].astype(np.float32) / 255.0)
    ours = torch.where(x >= 224.0 / 255.0, 1.0 - x, x)
    np.testing.assert_allclose(ours.numpy() * 255.0,
                               GOLDEN["solarize_u8"].astype(np.float32),
                               atol=1e-4)


B, SIZE, CROP, CLASSES = 6, 20, 16, 10


@jax.jit
def _jax_augment_draws(key, b):
    """The draws JAX's augment_batch makes from `key` (its own splits)."""
    keys = jax.random.split(key, 10)
    ky, kx = jax.random.split(keys[0])

    def u(k, lo, hi):
        return jax.random.uniform(k, (b.shape[0],), minval=lo, maxval=hi)

    def coin(k, p):
        return jax.random.bernoulli(k, p, (b.shape[0], 1, 1, 1)).reshape(-1)

    return {
        "tops": jax.random.randint(ky, b.shape, 0, SIZE - CROP + 1),
        "lefts": jax.random.randint(kx, b.shape, 0, SIZE - CROP + 1),
        "fb": jax.random.uniform(keys[1], (b.shape[0], 1, 1, 1), minval=0.5,
                                 maxval=1.0).reshape(-1),
        "fc": jax.random.uniform(keys[2], (b.shape[0], 1, 1, 1), minval=0.5,
                                 maxval=1.0).reshape(-1),
        "fs": jax.random.uniform(keys[3], (b.shape[0], 1, 1, 1), minval=0.5,
                                 maxval=1.0).reshape(-1),
        "fh": jax.random.uniform(keys[4], (b.shape[0], 1, 1, 1),
                                 minval=-0.125, maxval=0.125).reshape(-1),
        "solarize": coin(keys[5], 0.5),
        "flip": coin(keys[6], 0.5),
        "gray": coin(keys[7], 0.1),
        "sigma": u(keys[8], 0.1, 2.0),
    }


def _uint8_batch(seed):
    return np.random.default_rng(seed).integers(
        0, 256, (B, SIZE, SIZE, 3), dtype=np.uint8)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_augment_on_jax_draws_matches_augment_batch(seed):
    """Against eager augment_batch: under jit, XLA fuses the saturation
    blend into the hue's max and equality tests and recomputes it there, so
    `r == maxc` can fail where it holds and the hue takes another branch
    (measured up to 0.35 apart from eager on these inputs); eager JAX runs
    each op once, as torch does."""
    images = _uint8_batch(seed)
    key = jax.random.PRNGKey(seed)
    draws = _jax_augment_draws(key, jnp.zeros(B, jnp.int32))
    want = jax_augment.augment_batch(key, jnp.asarray(images), crop=CROP)
    params = {k: torch.from_numpy(np.asarray(v).copy())
              for k, v in draws.items()}
    got = augment.apply_augment(torch.from_numpy(images), params, crop=CROP)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_draw_augment_params_shapes_and_ranges():
    gen = torch.Generator().manual_seed(0)
    p = augment.draw_augment_params(gen, 64, SIZE, SIZE, CROP)
    assert all(v.shape == (64,) for v in p.values())
    assert 0 <= int(p["tops"].min()) and int(p["tops"].max()) <= SIZE - CROP
    assert 0.5 <= float(p["fb"].min()) and float(p["fb"].max()) < 1.0
    assert -0.125 <= float(p["fh"].min()) and float(p["fh"].max()) < 0.125
    assert 0.1 <= float(p["sigma"].min()) and float(p["sigma"].max()) < 2.0
    assert p["flip"].dtype == torch.bool
    out = augment.augment_batch(torch.Generator().manual_seed(0),
                                torch.from_numpy(_uint8_batch(5)), CROP)
    assert out.shape == (B, CROP, CROP, 3) and torch.isfinite(out).all()


@jax.jit
def _jax_mix(key, images, labels):
    """JAX's cutmix_or_mixup and its draws, from the same key."""
    k_choice, k_op = jax.random.split(key)
    k_lam, k_x, k_y = jax.random.split(k_op, 3)
    draws = {"cutmix": jax.random.bernoulli(k_choice, 0.5),
             "lam_cutmix": jax.random.beta(k_lam, 1.0, 1.0),
             "r_x": jax.random.randint(k_x, (), 0, CROP),
             "r_y": jax.random.randint(k_y, (), 0, CROP),
             "lam_mixup": jax.random.beta(k_op, 0.8, 0.8)}
    return draws, jax_mix(key, images, labels, CLASSES)


def test_mix_on_jax_draws_matches_cutmix_or_mixup():
    """Both branches, each on JAX's own lam (and box for CutMix)."""
    rng = np.random.default_rng(0)
    images = rng.standard_normal((B, CROP, CROP, 3)).astype(np.float32)
    labels = rng.integers(0, CLASSES, B).astype(np.int32)
    seen = set()
    for seed in range(12):
        d, (want_x, want_y) = _jax_mix(jax.random.PRNGKey(seed), images,
                                       labels)
        cut = bool(d["cutmix"])
        params = {"cutmix": cut,
                  "lam": float(d["lam_cutmix" if cut else "lam_mixup"]),
                  "r_x": int(d["r_x"]), "r_y": int(d["r_y"])}
        got_x, got_y = mixup.apply_mix(torch.from_numpy(images),
                                       torch.from_numpy(labels), CLASSES,
                                       params)
        np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                                   rtol=1e-5, atol=1e-5)
        seen.add(cut)
    assert seen == {True, False}


def test_cls_preprocess_draws_from_its_generator():
    """The same generator seed gives the same batch; soft labels sum to 1."""
    batch = {"image": torch.from_numpy(_uint8_batch(3)),
             "label": torch.arange(B, dtype=torch.int32)}
    pre = pipeline.make_cls_preprocess(CLASSES, crop=CROP)
    one = pre(torch.Generator().manual_seed(7), batch)
    two = pre(torch.Generator().manual_seed(7), batch)
    assert torch.equal(one["image"], two["image"])
    assert torch.equal(one["label"], two["label"])
    assert one["label"].shape == (B, CLASSES)
    torch.testing.assert_close(one["label"].sum(-1), torch.ones(B))
    reg = pipeline.make_reg_preprocess(crop=CROP)(
        torch.Generator().manual_seed(7), batch)
    assert sorted(reg) == ["image"] and reg["image"].shape == (B, CROP,
                                                               CROP, 3)


def test_eval_preprocess_keeps_label_and_valid():
    """make_eval_preprocess carries `label` and `valid` through, as the JAX
    package's does: the two dicts match key for key."""
    rng = np.random.default_rng(1)
    batch = {"image": rng.integers(0, 256, (4, SIZE, SIZE, 3),
                                   dtype=np.uint8),
             "label": rng.integers(0, CLASSES, 4).astype(np.int32),
             "valid": np.array([True, True, True, False])}
    want = jax_pipeline.make_eval_preprocess(CROP)(
        {k: jnp.asarray(v) for k, v in batch.items()})
    got = pipeline.make_eval_preprocess(CROP)(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert sorted(got) == sorted(want) == ["image", "label", "valid"]
    np.testing.assert_allclose(got["image"].numpy(),
                               np.asarray(want["image"]), rtol=1e-6,
                               atol=1e-6)
    for key in ("label", "valid"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]))
