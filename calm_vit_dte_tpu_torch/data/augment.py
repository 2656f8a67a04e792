"""ImageNet augmentation on the device, batched, and the eval crop.

JAX counterpart: calm_vit_dte_tpu/data/augment.py. It reproduces the
reference's torchvision chain (CALM_ViT_V2.py:159-170):

    Resize(256)                      [host side, with the decode]
    RandomCrop(224)
    ColorJitter(brightness=(0.5,1), contrast=(0.5,1), saturation=(0.5,1),
                hue=(-0.125, 0.125))
    RandomSolarize(224)              [uint8-scale threshold, p=0.5]
    RandomHorizontalFlip()           [p=0.5]
    RandomGrayscale()                [p=0.1]
    GaussianBlur(kernel=3, sigma=(0.1, 2.0))
    ToDtype(float32, scale=True)
    Normalize(ImageNet mean/std)

with the JAX package's documented deviation: the four ColorJitter ops run
in a fixed order (brightness, contrast, saturation, hue) with identically
distributed factors, not in torchvision's random per-image permutation.

The random draws are split from the arithmetic: `draw_augment_params` takes
every per-image draw from a torch.Generator, `apply_augment` is plain fp32
tensor arithmetic on whatever device the images are on. The tests feed the
JAX package's own draws to `apply_augment`. Generators give other numbers
than JAX's keys, so the two packages agree on the arithmetic, not on the
draws.
"""

from __future__ import annotations

import torch

from calm_vit_dte_tpu_torch.parallel.mesh import local_rows

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _normalize(img: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(IMAGENET_MEAN, device=img.device)
    std = torch.tensor(IMAGENET_STD, device=img.device)
    return (img - mean) / std


def eval_preprocess(images_u8: torch.Tensor, crop: int = 224) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, crop, crop, 3) fp32: center crop,
    normalized."""
    _, h, w, _ = images_u8.shape
    top = (h - crop) // 2
    left = (w - crop) // 2
    img = images_u8[:, top:top + crop, left:left + crop, :].float() / 255.0
    return _normalize(img)


def _grayscale(img: torch.Tensor) -> torch.Tensor:
    """ITU-R 601 luma, as torchvision's rgb_to_grayscale: (..., 1)."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    return (0.2989 * r + 0.587 * g + 0.114 * b)[..., None]


def _blend(a: torch.Tensor, b: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    return a * f + b * (1.0 - f)


def _adjust_hue(img: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """img in [0, 1]; delta in turns (torchvision's hue factor), broadcast
    against (B, H, W). The JAX package's branchless HSV round trip."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    c = maxc - minc
    safe_c = torch.where(c == 0, 1.0, c)
    s = torch.where(maxc == 0, 0.0, c / torch.where(maxc == 0, 1.0, maxc))
    rc = (maxc - r) / safe_c
    gc = (maxc - g) / safe_c
    bc = (maxc - b) / safe_c
    h = torch.where(r == maxc, bc - gc,
                    torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = (h / 6.0) % 1.0
    h = torch.where(c == 0, 0.0, h)
    h = (h + delta) % 1.0
    cc = s * v

    def comp(n):
        kk = (n + h * 6.0) % 6.0
        return v - cc * torch.clamp(torch.minimum(kk, 4.0 - kk), 0.0, 1.0)

    return torch.stack([comp(5.0), comp(3.0), comp(1.0)], dim=-1)


def _reflect1(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Pad one pixel on both sides of `dim`, mirrored without repeating the
    edge (numpy's and torchvision's 'reflect')."""
    n = x.shape[dim]
    return torch.cat([x.narrow(dim, 1, 1), x, x.narrow(dim, n - 2, 1)],
                     dim=dim)


def _gaussian_blur3(img: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """3x3 separable Gaussian with a sigma per image, reflect padding
    (torchvision GaussianBlur(kernel_size=3)); img (B, H, W, C)."""
    x = torch.exp(-0.5 * (1.0 / sigma) ** 2)
    k = torch.stack([x, torch.ones_like(x), x], dim=-1)
    k = k / k.sum(dim=-1, keepdim=True)                  # (B, 3)
    kb = k[:, None, None, :]
    pad = _reflect1(img, 2)
    h = (pad[:, :, 0:-2, :] * kb[..., 0, None]
         + pad[:, :, 1:-1, :] * kb[..., 1, None]
         + pad[:, :, 2:, :] * kb[..., 2, None])
    hp = _reflect1(h, 1)
    return (hp[:, 0:-2, :, :] * kb[..., 0, None]
            + hp[:, 1:-1, :, :] * kb[..., 1, None]
            + hp[:, 2:, :, :] * kb[..., 2, None])


def _uniform(generator, b, lo, hi, device) -> torch.Tensor:
    return lo + (hi - lo) * local_rows(
        lambda n: torch.rand(n, generator=generator, device=device), b)


def draw_augment_params(generator: torch.Generator, batch: int, height: int,
                        width: int, crop: int = 224) -> dict:
    """Every random draw of one batch's augmentation, per image, on the
    generator's device: crop corners (tops, lefts), jitter factors (fb, fc,
    fs, fh), the solarize, flip and grayscale coins and the blur sigma.
    Under data parallelism (parallel.mesh.batch_shard) each is drawn for
    the global batch and this rank keeps its rows."""
    dev = generator.device

    def rand(n):
        return torch.rand(n, generator=generator, device=dev)

    def coin(p):
        return local_rows(rand, batch) < p

    def corner(limit):
        return local_rows(lambda n: torch.randint(
            0, limit, (n,), generator=generator, device=dev), batch)

    return {
        "tops": corner(height - crop + 1),
        "lefts": corner(width - crop + 1),
        "fb": _uniform(generator, batch, 0.5, 1.0, dev),
        "fc": _uniform(generator, batch, 0.5, 1.0, dev),
        "fs": _uniform(generator, batch, 0.5, 1.0, dev),
        "fh": _uniform(generator, batch, -0.125, 0.125, dev),
        "solarize": coin(0.5),
        "flip": coin(0.5),
        "gray": coin(0.1),
        "sigma": _uniform(generator, batch, 0.1, 2.0, dev),
    }


def _random_crop(images: torch.Tensor, tops: torch.Tensor,
                 lefts: torch.Tensor, out: int) -> torch.Tensor:
    """Per-image crop as two axis-wise gathers, whole rows then whole
    columns (the JAX package's take_along_axis form)."""
    b, _, w, c = images.shape
    ar = torch.arange(out, device=images.device)
    rows = (tops[:, None] + ar)[:, :, None, None].expand(b, out, w, c)
    x = torch.gather(images, 1, rows)
    cols = (lefts[:, None] + ar)[:, None, :, None].expand(b, out, out, c)
    return torch.gather(x, 2, cols)


def apply_augment(images_u8: torch.Tensor, params: dict,
                  crop: int = 224) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, crop, crop, 3) fp32 normalized, with the
    draws of `draw_augment_params` (fp32 factors, bool coins, integer
    corners; any device: they move to the images')."""
    p = {k: v.to(images_u8.device) for k, v in params.items()}

    def per_image(key):
        return p[key][:, None, None, None]

    img = _random_crop(images_u8, p["tops"], p["lefts"], crop).float()
    img = img / 255.0
    img = torch.clamp(img * per_image("fb"), 0.0, 1.0)
    mean_gray = _grayscale(img).mean(dim=(1, 2, 3), keepdim=True)
    img = torch.clamp(_blend(img, mean_gray, per_image("fc")), 0.0, 1.0)
    img = torch.clamp(_blend(img, _grayscale(img), per_image("fs")), 0.0,
                      1.0)
    img = _adjust_hue(img, p["fh"][:, None, None])
    img = torch.where(per_image("solarize") & (img >= 224.0 / 255.0),
                      1.0 - img, img)
    img = torch.where(per_image("flip"), img.flip(2), img)
    img = torch.where(per_image("gray"), _grayscale(img).expand_as(img), img)
    img = _gaussian_blur3(img, p["sigma"])
    return _normalize(img)


def augment_batch(generator: torch.Generator, images_u8: torch.Tensor,
                  crop: int = 224) -> torch.Tensor:
    """The training augmentation of a uint8 batch with fresh draws from
    `generator` (on the images' device)."""
    b, h, w, _ = images_u8.shape
    return apply_augment(images_u8, draw_augment_params(generator, b, h, w,
                                                        crop), crop)
