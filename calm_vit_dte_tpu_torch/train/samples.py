"""Generated-sample dumper: sigmoid, then one RGB PNG per image.

JAX counterpart: calm_vit_dte_tpu/train/samples.py (reference
CALM_ViT_V2.py:113-118 save_samples, written by the chief each epoch from
the regression trainer). The card's machine has no Pillow, so the PNG is
written with the standard library's zlib and struct.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np
import torch


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, rgb: np.ndarray) -> None:
    """rgb: (H, W, 3) uint8 -> an 8-bit truecolour PNG, no filtering."""
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(rgb).reshape(h, w * 3)],
                          axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def save_samples(tokens_or_images: torch.Tensor, out_dir: str,
                 prefix: str = "sample", max_images: int = 16) -> list[str]:
    """tokens_or_images: (B, S, 3S) row tokens or (B, H, W, 3) images."""
    x = tokens_or_images.detach().float().cpu().numpy()
    if x.ndim == 3:  # row tokens -> NHWC
        b, s, _ = x.shape
        x = x.reshape(b, s, s, 3)
    x = 1.0 / (1.0 + np.exp(-x))  # sigmoid
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, img in enumerate(x[:max_images]):
        p = os.path.join(out_dir, f"{prefix}_{i}.png")
        write_png(p, (img * 255).astype(np.uint8))
        paths.append(p)
    return paths
