"""The CALM block's conv residual (1x1 3->32, GELU, depthwise 3x3 with zero
padding, GELU, 1x1 32->3): the CUDA kernels' wrappers, their plain versions
and the autograd Function that trains through them.

JAX counterpart: calm_vit_dte_tpu/kernels/conv_residual.py,
`fused_conv_residual` (the Pallas kernels built by `_make_fused`): the
forward (fwd_call, :355), the forward that saves the middle activations h
and acc (fwd_resid_call, :369) and the recomputing backward (bwd_call,
:387). The kernel sources and their design notes are in csrc/conv_residual.cu
and csrc/conv_residual_bwd.cu. The fp32 kernels' GELUs are exact (erf), and
the backward differentiates exactly that. The bf16 kernels take erf from one
exp and one reciprocal (Abramowitz-Stegun 7.1.26 in
csrc/conv_residual_common.cuh: within ERF_BF16_MAX_ERR of erff, shared by a
GELU and its derivative), far below bf16's rounding of h, acc and y; the
plain versions stay exact in both dtypes. The TPU kernel's bf16 minimax
GELU and its derivative are not carried over. There is no S gate: every S
goes to the kernels on the card.

`fused_conv_residual_train` is the differentiable entry point. Its backward
is chosen by CALM_CONV_BWD, read at each call as the JAX package reads it:
  * unset or 'pallas': the forward kernel, then the backward kernel, which
    recomputes h and acc (the JAX `fwd_pallas`/`bwd_pallas`);
  * 'xla': the forward kernel that saves h and acc, then the JAX package's
    `bwd_xla` (:447-499) as plain torch ops over them: XLA ops outside any
    Pallas kernel there, torch ops here;
  * anything else raises ValueError.
Under activation checkpointing (utils/remat.py) the Function records its
forward's outputs, y or (y, h, acc), so the Block replay launches no conv
kernel again (the JAX step's saved "conv_out").

The bf16 kernels' launch geometry is mirrored here (`FWD_BF16_TILE`,
`BWD_BF16_TILE`, the grids, `fwd_bf16_smem`, `bwd_bf16_smem`,
`ctas_per_sm`); the CPU tests hold it to the sources' notes, and
chip_smoke.py and the GPU tests to the C launches (`card_geometry`).
`conv_residual_bwd_partials_plain` is the backward's staged plain version:
its per-CTA partial weight-grad rows, in the bf16 kernel's tiling, which
the GPU tests hold the kernel's rows (`launch_bwd`) to.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import os

import torch
import torch.nn.functional as F

from calm_vit_dte_tpu_torch.kernels._build import library
from calm_vit_dte_tpu_torch.nn.conv import conv2d_nhwc
from calm_vit_dte_tpu_torch.utils.remat import replayed

SOURCE = "calm_vit_dte_tpu_torch/csrc/conv_residual.cu"
BWD_SOURCE = "calm_vit_dte_tpu_torch/csrc/conv_residual_bwd.cu"
REPLACES = "calm_vit_dte_tpu/kernels/conv_residual.py:355"
REPLACES_FWD_RESID = "calm_vit_dte_tpu/kernels/conv_residual.py:369"
REPLACES_BWD = "calm_vit_dte_tpu/kernels/conv_residual.py:387"
HIDDEN = 32
WG_COLS = 24     # the packed weight-grad row: dwd 0:9, dbd 9, dw1 10:13,
#                  db1 13, dw2^T 14:17, zero 17:24
_WG_SUMS = 17    # the sums per channel each CTA writes (columns 0:17)
_DTYPES = (torch.float32, torch.bfloat16)
_INV_SQRT_2PI = 0.3989422804014327
_SQRT_HALF = 0.7071067811865476
# kErfBf16MaxErr of csrc/conv_residual_common.cuh: the bf16 route's erf
# against erff over [-10, 10].
ERF_BF16_MAX_ERR = 6e-7

# The bf16 kernels' launch geometry, as csrc/conv_residual{,_bwd}.cu set it.
THREADS_BF16 = 256
FWD_BF16_TILE = (64, 16)     # output rows, columns of a forward CTA
BWD_BF16_TILE = (16, 32)     # ... of a backward CTA
_FWD_WEIGHTS_SMEM = 4 * (3 * 32 + 32 + 9 * 32 + 32 + 3 * 32 + 4)  # static
_SM_SMEM = 233472            # shared memory of one SM; each CTA also
#                              reserves 1 KB
_SM_REGS = 65536
# The CTAs an SM each bf16 kernel's __launch_bounds__ asks for (kMinCtas,
# kMinCtasSave of the sources).
MIN_CTAS_BF16 = {"forward": 3, "forward with residuals": 2, "backward": 2}


def fwd_bf16_smem() -> int:
    """Shared memory of a bf16 forward CTA: h on the tile's one-pixel halo
    for a pass of 16 channels, bf16 (dynamic), and the weights (static)."""
    rows, cols = FWD_BF16_TILE
    return (rows + 2) * (cols + 2) * 16 * 2 + _FWD_WEIGHTS_SMEM


def bwd_bf16_smem() -> int:
    """Dynamic shared memory of a bf16 backward CTA: x on the tile's
    two-pixel halo and g on its one-pixel halo as float4, and each of the 8
    warps' planes (h on the tile + 2, dacc on the tile + 1, gelu'(a1) on the
    tile), fp32."""
    rows, cols = BWD_BF16_TILE
    hn, an = (rows + 4) * (cols + 4), (rows + 2) * (cols + 2)
    return 16 * (hn + an) + 4 * 8 * (hn + an + rows * cols)


def ctas_per_sm(smem: int, min_ctas: int) -> int:
    """CTAs of THREADS_BF16 threads that fit on one SM by shared memory and
    by registers, for a kernel whose __launch_bounds__ asks for `min_ctas`
    (which caps its registers a thread, allocated in eights)."""
    regs = _SM_REGS // (min_ctas * THREADS_BF16) // 8 * 8
    return min(_SM_SMEM // (smem + 1024), _SM_REGS // (regs * THREADS_BF16))


def _grid(tile: tuple[int, int], b: int, s: int) -> tuple[int, int, int]:
    rows, cols = tile
    return (-(-s // cols), -(-s // rows), b)


def fwd_bf16_grid(b: int, s: int) -> tuple[int, int, int]:
    """(x, y, z) CTAs of a bf16 forward launch: column tiles, row tiles,
    images."""
    return _grid(FWD_BF16_TILE, b, s)


def bwd_bf16_grid(b: int, s: int) -> tuple[int, int, int]:
    """... of a bf16 backward launch, which writes one partial weight-grad
    row a CTA."""
    return _grid(BWD_BF16_TILE, b, s)


def fused_conv_residual_plain(x, w1, b1, wd, bd, w2, b2, *,
                              dtype) -> torch.Tensor:
    """x: (B,S,S,3) NHWC. w1 (32,3), wd (3,3,32) [= OIHW (32,1,3,3)
    transposed], w2 (3,32), biases (32,), (32,), (3,). Returns (B,S,S,3) in
    `dtype`."""
    w1_oihw = w1.reshape(HIDDEN, 3, 1, 1)
    wd_oihw = wd.permute(2, 0, 1).reshape(HIDDEN, 1, 3, 3)
    w2_oihw = w2.reshape(3, HIDDEN, 1, 1)
    h = F.gelu(conv2d_nhwc(x, w1_oihw, b1, dtype=dtype))
    h = F.gelu(conv2d_nhwc(h, wd_oihw, bd, groups=HIDDEN, dtype=dtype))
    return conv2d_nhwc(h, w2_oihw, b2, dtype=dtype)


def _dgelu(x: torch.Tensor) -> torch.Tensor:
    """d/dx of the exact GELU: Phi(x) + x * phi(x)."""
    cdf = 0.5 * (1.0 + torch.erf(x * _SQRT_HALF))
    return cdf + x * torch.exp(-0.5 * x * x) * _INV_SQRT_2PI


def _a1(x32, w1, b1) -> torch.Tensor:
    return x32 @ w1.t() + b1


def _taps(src: torch.Tensor, wd: torch.Tensor, init, flip: bool = False):
    """init + sum over the 3x3 taps of the zero-padded (B,S,S,32) `src`:
    src[p + (a-1, b-1)] * wd[a, b] (the depthwise conv), or with `flip`
    src[p - (a-1, b-1)] * wd[a, b] (its transpose)."""
    s = src.shape[1]
    p = F.pad(src, (0, 0, 1, 1, 1, 1))
    out = init
    for a in range(3):
        for b in range(3):
            r, c = (2 - a, 2 - b) if flip else (a, b)
            out = out + p[:, r:r + s, c:c + s, :] * wd[a, b]
    return out


def conv_residual_fwd_resid_plain(x, w1, b1, wd, bd, w2, b2, *,
                                  dtype) -> tuple:
    """The forward that also returns its middle activations, step by step
    with the kernel's rounding: h = gelu(W1 x + b1) rounded to `dtype`, acc
    = dw3x3(h) + bd and the rest in fp32, y in `dtype`. Returns (y
    (B,S,S,3), h (B,S,S,32), acc (B,S,S,32)), all in `dtype`."""
    h = F.gelu(_a1(x.float(), w1, b1)).to(dtype).float()
    acc = _taps(h, wd, bd)
    y = F.gelu(acc) @ w2.t() + b2
    return y.to(dtype), h.to(dtype), acc.to(dtype)


def _bwd_parts(x, g, w1, b1, wd, bd, w2, dtype) -> tuple:
    """The recomputing backward's per-pixel values, as the kernels compute
    them (h rounded to `dtype`, the rest fp32): x, g, h, g2, dacc, da1."""
    x32, gy = x.float(), g.float()
    a1 = _a1(x32, w1, b1)
    h = F.gelu(a1).to(dtype).float()
    acc = _taps(h, wd, bd)
    dacc = (gy @ w2) * _dgelu(acc)
    da1 = _taps(dacc, wd, 0.0, flip=True) * _dgelu(a1)
    return x32, gy, h, F.gelu(acc), dacc, da1


def conv_residual_bwd_plain(x, g, w1, b1, wd, bd, w2, *, dtype) -> tuple:
    """The recomputing backward, step by step as the kernel computes it
    (h rounded to `dtype`, the rest fp32): x, g (B,S,S,3) -> (dx (B,S,S,3)
    in `dtype`, the packed (32, 24) fp32 weight grads)."""
    x32, gy, h, g2, dacc, da1 = _bwd_parts(x, g, w1, b1, wd, bd, w2, dtype)
    hp = F.pad(h, (0, 0, 1, 1, 1, 1))
    s = x.shape[1]
    dims = (0, 1, 2)
    wg = torch.zeros((HIDDEN, WG_COLS), dtype=torch.float32, device=x.device)
    for a in range(3):
        for b in range(3):
            wg[:, a * 3 + b] = (dacc * hp[:, a:a + s, b:b + s, :]).sum(dims)
    wg[:, 9] = dacc.sum(dims)
    wg[:, 10:13] = torch.einsum("bhwc,bhwi->ci", da1, x32)
    wg[:, 13] = da1.sum(dims)
    wg[:, 14:17] = torch.einsum("bhwc,bhwo->co", g2, gy)
    return (da1 @ w1).to(dtype), wg


def conv_residual_bwd_partials_plain(x, g, w1, b1, wd, bd, w2, *,
                                     dtype) -> tuple:
    """The backward's first stage as the bf16 kernel stages it: dx, and one
    partial row a CTA (in the grid's order: image, row tile, column tile of
    BWD_BF16_TILE) of the 32 x 17 weight-grad sums over the tile's own
    pixels, (n, 544) fp32. `conv_weight_grad_sum_plain` of the rows gives
    `conv_residual_bwd_plain`'s packed weight grads. For small inputs: it
    holds all 17 products of every pixel and channel."""
    x32, gy, h, g2, dacc, da1 = _bwd_parts(x, g, w1, b1, wd, bd, w2, dtype)
    hp = F.pad(h, (0, 0, 1, 1, 1, 1))
    n, s = x.shape[0], x.shape[1]
    terms = [dacc * hp[:, a:a + s, b:b + s, :]
             for a in range(3) for b in range(3)]
    terms += [dacc, *(da1 * x32[..., i:i + 1] for i in range(3)), da1,
              *(g2 * gy[..., o:o + 1] for o in range(3))]
    rows, cols = BWD_BF16_TILE
    gx, gyt, _ = bwd_bf16_grid(n, s)
    t = F.pad(torch.stack(terms, dim=-1),
              (0, 0, 0, 0, 0, gx * cols - s, 0, gyt * rows - s))
    t = t.view(n, gyt, rows, gx, cols, HIDDEN, _WG_SUMS).sum((2, 4))
    return (da1 @ w1).to(dtype), t.reshape(-1, HIDDEN * _WG_SUMS)


def erf_bf16_probe(x: torch.Tensor) -> tuple:
    """erf(x / sqrt 2), GELU(x) and GELU'(x) of fp32 `x` as the bf16 kernels
    compute them (csrc/conv_residual_common.cuh), on the card; on a CPU
    tensor the exact functions."""
    if _on(x) == "cpu":
        return (torch.erf(x * _SQRT_HALF), F.gelu(x), _dgelu(x))
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("the probe takes contiguous fp32")
    outs = [torch.empty_like(x) for _ in range(3)]
    fn = library("conv_residual").conv_residual_erf_bf16_probe
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
        fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), x.numel(), *_ptrs(*outs), _stream(x))
    _raise_on(err, "conv_residual_erf_bf16_probe", 0, 0, torch.float32)
    return tuple(outs)


def conv_residual_bwd_from_residuals(x, g, h, acc, w1, b1, wd, w2) -> tuple:
    """The CALM_CONV_BWD=xla backward (the JAX package's `bwd_xla`) as torch
    ops over the saved h and acc: elementwise passes and sums in fp32, the
    depthwise conv's input and weight grads in the residuals' dtype with
    the cotangent cast to match (as `bwd_xla` runs its conv vjp). Returns
    (dx in x's dtype, dw1 (32,3), db1, dwd (3,3,32), dbd, dw2 (3,32)),
    the weight grads fp32."""
    gp, accf, x32 = g.float(), acc.float(), x.float()
    dims = (0, 1, 2)
    dw2 = torch.einsum("bhwo,bhwc->oc", gp, F.gelu(accf))
    dacc = (gp @ w2) * _dgelu(accf)
    dbd = dacc.sum(dims)
    hn = h.permute(0, 3, 1, 2)
    wd_oihw = wd.permute(2, 0, 1).unsqueeze(1).to(h.dtype)
    gn = dacc.to(h.dtype).permute(0, 3, 1, 2)
    dh = torch.nn.grad.conv2d_input(hn.shape, wd_oihw, gn, padding=1,
                                    groups=HIDDEN)
    dwd = torch.nn.grad.conv2d_weight(hn, wd_oihw.shape, gn, padding=1,
                                      groups=HIDDEN)
    da1 = dh.permute(0, 2, 3, 1).float() * _dgelu(_a1(x32, w1, b1))
    return ((da1 @ w1).to(x.dtype), torch.einsum("bhwc,bhwi->ci", da1, x32),
            da1.sum(dims), dwd[:, 0].permute(1, 2, 0).float(), dbd, dw2)


def _fn(lib: str, name: str, n_ptr: int):
    """A C entry of the form (int, n_ptr pointers, int B, int S, stream)."""
    fn = getattr(library(lib), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * n_ptr
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(x, dtype, weights, *, g=None) -> tuple[int, int]:
    """Raises on what the kernels do not take; returns (B, S)."""
    if dtype not in _DTYPES:
        raise ValueError(f"compute dtype {dtype} not supported; "
                         f"expected one of {_DTYPES}")
    if x.dim() != 4 or x.shape[1] != x.shape[2] or x.shape[3] != 3:
        raise ValueError(f"x must be (B,S,S,3), got {tuple(x.shape)}")
    b, s = x.shape[0], x.shape[1]
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the grid's z limit 65535")
    for name, t in (("x", x), ("g", g)):
        if t is not None and (t.dtype != dtype or not t.is_contiguous()
                              or t.shape != x.shape
                              or t.device != x.device):
            raise ValueError(f"{name} must be contiguous {dtype} of shape "
                             f"{tuple(x.shape)} on {x.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    shapes = {"w1": (HIDDEN, 3), "b1": (HIDDEN,), "wd": (3, 3, HIDDEN),
              "bd": (HIDDEN,), "w2": (3, HIDDEN), "b2": (3,)}
    for name, t in weights.items():
        shape = shapes[name]
        if (t.device != x.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name}: expected contiguous {shape} float32 "
                             f"on {x.device}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    return b, s


def _raise_on(err: int, what: str, b: int, s: int, dtype) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err} (B={b}, "
                           f"S={s}, {dtype})")


def _stream(x) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _ptrs(*ts) -> list[int]:
    return [t.data_ptr() for t in ts]


def _on(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {x.device}")
    return x.device.type


def fused_conv_residual(x, w1, b1, wd, bd, w2, b2, *,
                        dtype) -> torch.Tensor:
    """The conv residual term of x (B,S,S,3) NHWC, in `dtype`. Weights are
    spectral-normalized fp32 in the layouts of `fused_conv_residual_plain`.
    A CPU tensor runs the plain version; on the card x must already be
    contiguous and in `dtype`. Not differentiable on the card: training
    goes through `fused_conv_residual_train`."""
    if _on(x) == "cpu":
        return fused_conv_residual_plain(x, w1, b1, wd, bd, w2, b2,
                                         dtype=dtype)
    b, s = _check(x, dtype, dict(w1=w1, b1=b1, wd=wd, bd=bd, w2=w2, b2=b2))
    y = torch.empty_like(x)
    err = _fn("conv_residual", "conv_residual_fwd", 8)(
        int(dtype == torch.bfloat16), *_ptrs(x, w1, b1, wd, bd, w2, b2, y),
        b, s, _stream(x))
    _raise_on(err, "conv_residual_fwd", b, s, dtype)
    fused_conv_residual.launches += 1
    return y


fused_conv_residual.launches = 0


def conv_residual_fwd_resid(x, w1, b1, wd, bd, w2, b2, *, dtype) -> tuple:
    """(y, h, acc) as `conv_residual_fwd_resid_plain` returns them: the
    plain version on a CPU tensor, the kernel on a CUDA tensor."""
    if _on(x) == "cpu":
        return conv_residual_fwd_resid_plain(x, w1, b1, wd, bd, w2, b2,
                                             dtype=dtype)
    b, s = _check(x, dtype, dict(w1=w1, b1=b1, wd=wd, bd=bd, w2=w2, b2=b2))
    y = torch.empty_like(x)
    h = torch.empty((b, s, s, HIDDEN), dtype=dtype, device=x.device)
    acc = torch.empty_like(h)
    err = _fn("conv_residual", "conv_residual_fwd_resid", 10)(
        int(dtype == torch.bfloat16),
        *_ptrs(x, w1, b1, wd, bd, w2, b2, y, h, acc), b, s, _stream(x))
    _raise_on(err, "conv_residual_fwd_resid", b, s, dtype)
    conv_residual_fwd_resid.launches += 1
    return y, h, acc


conv_residual_fwd_resid.launches = 0


def _bwd_rows(dtype, b: int, s: int) -> int:
    """The partial weight-grad rows (one per CTA) the backward kernel of
    `dtype` writes for (B, S); the library computes it from its own
    tiling."""
    fn = library("conv_residual_bwd").conv_residual_bwd_rows
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 3
        fn.restype = ctypes.c_int
    return fn(int(dtype == torch.bfloat16), b, s)


# The C entries that report the bf16 kernels' geometry and what the card
# makes of every conv kernel, by library.
_GEOMETRY = {"forward": ("conv_residual", "conv_residual_fwd_bf16_geometry"),
             "backward": ("conv_residual_bwd",
                          "conv_residual_bwd_bf16_geometry")}
_OCCUPANCY = {
    ("conv_residual", "conv_residual_fwd_occupancy"): (
        "conv_residual_fwd_kernel<fp32>",
        "conv_residual_fwd_kernel<fp32, save>", "conv_fwd_bf16_kernel<0>",
        "conv_fwd_bf16_kernel<1> (save)"),
    ("conv_residual_bwd", "conv_residual_bwd_occupancy"): (
        "conv_residual_bwd_kernel<fp32>", "conv_bwd_bf16_kernel<31>",
        "conv_wgrad_sum_kernel"),
}


def card_geometry(b: int, s: int) -> dict:
    """The bf16 kernels' launch geometry for (B, S) as the C entries set
    it: {"forward": ..., "backward": ...}, each (grid x, y, z, threads a
    CTA, dynamic shared memory a CTA); and the backward's partial rows."""
    out = {}
    for what, (lib, entry) in _GEOMETRY.items():
        fn = getattr(library(lib), entry)
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            fn.restype = None
        buf = (ctypes.c_int * 5)()
        fn(b, s, buf)
        out[what] = tuple(buf)
    out["bwd_rows"] = _bwd_rows(torch.bfloat16, b, s)
    return out


def card_occupancy() -> dict:
    """What the card makes of each conv kernel: {name: {"registers",
    "spill_bytes", "smem_bytes" (static + dynamic, a CTA), "ctas_per_sm"}},
    from cudaFuncGetAttributes and cudaOccupancyMaxActiveBlocksPer
    Multiprocessor in the C entries."""
    out = {}
    for (lib, entry), kernels in _OCCUPANCY.items():
        fn = getattr(library(lib), entry)
        if fn.argtypes is None:
            fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
        buf = (ctypes.c_int * (4 * len(kernels)))()
        err = fn(buf)
        if err != 0:
            raise RuntimeError(f"{entry}: CUDA error {err}")
        for k, name in enumerate(kernels):
            out[name] = dict(zip(("registers", "spill_bytes", "smem_bytes",
                                  "ctas_per_sm"), buf[4 * k:4 * k + 4]))
    return out


def launch_bwd(x, g, w1, b1, wd, bd, w2, *, dtype,
               parts: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of the backward kernel on CUDA tensors: the production
    build (`conv_residual_bwd`), or the bf16 build with the part mask
    `parts` (`conv_residual_bwd_ablate`). Returns (dx, the per-CTA partial
    weight-grad rows)."""
    b, s = _check(x, dtype, dict(w1=w1, b1=b1, wd=wd, bd=bd, w2=w2), g=g)
    if parts is None:
        entry, lead = "conv_residual_bwd", int(dtype == torch.bfloat16)
    elif dtype == torch.bfloat16:
        entry, lead = "conv_residual_bwd_ablate", parts
    else:
        raise ValueError("the ablation variants are built for bf16 only")
    dx = torch.empty_like(x)
    part = torch.empty((_bwd_rows(dtype, b, s), HIDDEN * _WG_SUMS),
                       dtype=torch.float32, device=x.device)
    err = _fn("conv_residual_bwd", entry, 9)(
        lead, *_ptrs(x, g, w1, b1, wd, bd, w2, dx, part), b, s, _stream(x))
    _raise_on(err, entry, b, s, dtype)
    return dx, part


def conv_weight_grad_sum_plain(part: torch.Tensor) -> torch.Tensor:
    """The packed (32, 24) weight grads from (n, 32*17) partial rows."""
    out = torch.zeros((HIDDEN, WG_COLS), dtype=torch.float32,
                      device=part.device)
    out[:, :_WG_SUMS] = part.sum(0).view(HIDDEN, _WG_SUMS)
    return out


def conv_weight_grad_sum(part: torch.Tensor) -> torch.Tensor:
    """The backward's second launch on the card: the partial rows added in
    a fixed order (no atomics, the same bits from run to run). Same return
    as `conv_weight_grad_sum_plain`."""
    if _on(part) == "cpu":
        return conv_weight_grad_sum_plain(part)
    if (part.dtype != torch.float32 or part.dim() != 2
            or part.shape[1] != HIDDEN * _WG_SUMS
            or not part.is_contiguous()):
        raise ValueError(f"partials must be contiguous fp32 (n, "
                         f"{HIDDEN * _WG_SUMS}), got {part.dtype} "
                         f"{tuple(part.shape)}")
    out = torch.empty((HIDDEN, WG_COLS), dtype=torch.float32,
                      device=part.device)
    fn = library("conv_residual_bwd").conv_residual_wgrad_sum
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    err = fn(part.data_ptr(), part.shape[0], out.data_ptr(), _stream(part))
    _raise_on(err, "conv_residual_wgrad_sum", part.shape[0], 0,
              torch.float32)
    conv_weight_grad_sum.launches += 1
    return out


conv_weight_grad_sum.launches = 0


def conv_residual_bwd(x, g, w1, b1, wd, bd, w2, *, dtype) -> tuple:
    """(dx, packed (32, 24) weight grads) as `conv_residual_bwd_plain`
    returns them: the plain version on CPU tensors; on the card the backward
    kernel, then `conv_weight_grad_sum` (its own launch count)."""
    if _on(x) == "cpu":
        return conv_residual_bwd_plain(x, g, w1, b1, wd, bd, w2, dtype=dtype)
    dx, part = launch_bwd(x, g, w1, b1, wd, bd, w2, dtype=dtype)
    conv_residual_bwd.launches += 1
    return dx, conv_weight_grad_sum(part)


conv_residual_bwd.launches = 0


def unpack_weight_grads(wg: torch.Tensor) -> tuple:
    """(dw1 (32,3), db1, dwd (3,3,32), dbd, dw2 (3,32)) from the packed
    (32, 24) rows."""
    return (wg[:, 10:13], wg[:, 13], wg[:, 0:9].t().reshape(3, 3, HIDDEN),
            wg[:, 9], wg[:, 14:17].t())


def _bwd_route() -> str:
    """CALM_CONV_BWD: 'pallas' (the default) or 'xla'; anything else
    raises, as the JAX package's `fused_conv_residual` does."""
    route = os.environ.get("CALM_CONV_BWD", "pallas")
    if route not in ("xla", "pallas"):
        raise ValueError(f"CALM_CONV_BWD={route!r}: expected 'xla' or "
                         "'pallas'")
    return route


class _FusedConvResidual(torch.autograd.Function):
    @staticmethod
    def forward(ctx, route, dtype, x, w1, b1, wd, bd, w2, b2):
        ctx.route, ctx.dtype = route, dtype
        if route == "pallas":
            y = replayed(lambda: fused_conv_residual(
                x, w1, b1, wd, bd, w2, b2, dtype=dtype))
            ctx.save_for_backward(x, w1, b1, wd, bd, w2)
        else:
            y, h, acc = replayed(lambda: conv_residual_fwd_resid(
                x, w1, b1, wd, bd, w2, b2, dtype=dtype))
            ctx.save_for_backward(x, h, acc, w1, b1, wd, w2)
        return y

    @staticmethod
    def backward(ctx, gy):
        g = gy.to(ctx.dtype).contiguous()
        if ctx.route == "pallas":
            x, w1, b1, wd, bd, w2 = ctx.saved_tensors
            dx, wg = conv_residual_bwd(x, g, w1, b1, wd, bd, w2,
                                       dtype=ctx.dtype)
            dw1, db1, dwd, dbd, dw2 = unpack_weight_grads(wg)
        else:
            x, h, acc, w1, b1, wd, w2 = ctx.saved_tensors
            dx, dw1, db1, dwd, dbd, dw2 = conv_residual_bwd_from_residuals(
                x, g, h, acc, w1, b1, wd, w2)
        db2 = g.float().sum(dim=(0, 1, 2))
        return None, None, dx.to(x.dtype), dw1, db1, dwd, dbd, dw2, db2


def fused_conv_residual_train(x, w1, b1, wd, bd, w2, b2, *,
                              dtype) -> torch.Tensor:
    """`fused_conv_residual`, differentiable in x and every weight, with the
    backward route of CALM_CONV_BWD (see the module docstring). On the card
    x must already be contiguous and in `dtype`."""
    return _FusedConvResidual.apply(_bwd_route(), dtype, x, w1, b1, wd,
                                    bd, w2, b2)
