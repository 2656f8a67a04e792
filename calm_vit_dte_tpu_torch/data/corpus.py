"""Procedural on-disk JPEG corpus generator (ImageFolder layout).

JAX counterpart: calm_vit_dte_tpu/data/corpus.py, copied (the port imports
nothing of the JAX package): the same seeds, draws, stamp and JPEG quality,
so the same arguments write the same bytes. With no network, the training
proof (tools/train_proof.py) runs on a generated corpus of JPEG files on
disk. Two modes:

  * ``memorize``  per-image unique textured noise with fixed random labels:
    the overfit target (reaching ~100% train top-1 proves the optimize /
    measure loop learns by memorization, whatever the labels mean);
  * ``learnable`` class-conditional structure (oriented gratings whose
    orientation and spatial frequency encode the class, under per-image
    phase, contrast and background nuisance): a held-out split is
    predictable above chance only if the model generalizes, through the full
    augmentation + CutMix/MixUp pipeline.

The files are real JPEGs decoded by the production data plane
(data/native.py, or Pillow), the same bytes-on-disk -> batch path as staged
ImageNet.
"""

from __future__ import annotations

import pathlib

import numpy as np


def _texture(rng: np.random.Generator, size: int) -> np.ndarray:
    """Multi-octave value noise in [0,1], (size, size, 3) float32 — busier
    than uniform noise, survives JPEG compression recognizably."""
    img = np.zeros((size, size, 3), np.float32)
    for octave in (4, 8, 16, 32):
        coarse = rng.random((octave, octave, 3), np.float32)
        reps = -(-size // octave)
        up = np.kron(coarse, np.ones((reps, reps, 1), np.float32))
        img += up[:size, :size] / 4.0
    return img


def _grating(rng: np.random.Generator, size: int, label: int,
             num_classes: int) -> np.ndarray:
    """Class-conditional oriented grating: orientation and spatial
    frequency both derive from the label; phase, contrast, color tint and
    the additive texture are per-image nuisance."""
    theta = np.pi * (label % num_classes) / num_classes
    freq = 4.0 + 3.0 * (label % 4)  # cycles per image, 4 bands
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    phase = rng.uniform(0, 2 * np.pi)
    wave = np.sin(2 * np.pi * freq * (xx * np.cos(theta)
                                      + yy * np.sin(theta)) + phase)
    contrast = rng.uniform(0.45, 0.75)
    tint = rng.uniform(0.6, 1.0, (3,)).astype(np.float32)
    img = 0.5 + 0.5 * contrast * wave[..., None] * tint
    img = 0.75 * img + 0.25 * _texture(rng, size)
    return np.clip(img, 0.0, 1.0)


def make_corpus(root: str | pathlib.Path, n_train: int, n_val: int = 0,
                num_classes: int = 10, size: int = 384,
                mode: str = "learnable", seed: int = 0,
                quality: int = 90) -> pathlib.Path:
    """Write an ImageFolder-layout JPEG corpus under ``root`` (train/ and,
    if n_val > 0, val/ splits). Idempotent: skipped when the expected file
    count already exists. Returns ``root``."""
    from PIL import Image

    root = pathlib.Path(root)
    marker = root / ".corpus.txt"
    stamp = f"{mode}:{n_train}:{n_val}:{num_classes}:{size}:{seed}:{quality}"
    if marker.exists() and marker.read_text() == stamp:
        return root
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        if n == 0:
            continue
        labels = rng.integers(0, num_classes, (n,))
        for c in range(num_classes):
            (root / split / f"class_{c:03d}").mkdir(parents=True,
                                                    exist_ok=True)
        for i in range(n):
            lab = int(labels[i])
            if mode == "memorize":
                img = _texture(rng, size)
            elif mode == "learnable":
                img = _grating(rng, size, lab, num_classes)
            else:
                raise ValueError(f"unknown corpus mode: {mode!r}")
            u8 = np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)
            Image.fromarray(u8).save(
                root / split / f"class_{lab:03d}" / f"{split}_{i:05d}.jpg",
                quality=quality)
    marker.write_text(stamp)
    return root
