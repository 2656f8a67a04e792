"""Long-sequence fused attention with the learned additive mask (the
`hires-cls-1024` shapes, S up to 1024 and head dims up to 256): the CUDA
kernels' wrappers, the autograd Function that joins them, and their plain
PyTorch versions.

JAX counterpart: calm_vit_dte_tpu/kernels/axial_attention.py,
`fused_hires_attention` (the Pallas kernels built by `_make_hires_fused`:
the forward `_fwd_res_kernel` that saves the softmax and mask residuals, the
query-tiled `_hires_dq_kernel` and the key-tiled `_hires_dkv_kernel`) and
`fused_attention_forward` (`_make_fwd_only`, body `_fwd_kernel`). The kernel
sources and their design notes are in csrc/hires_attention.cu (forward, with
and without residuals) and csrc/hires_attention_bwd.cu (the dq pass, the
mask-MLP weight grads, the dk/dv pass). On rotated q, k (B,H,S,D) and v
(B,H,S,Dv):

    ssum = sum_h q_h k_h^T                      (B, S, S), over heads
    m    = gelu(ssum W1^T + b1) W2^T + b2       mask MLP over the key axis
    lse  = logsumexp(scale * q_h k_h^T + m)     (B, H, S), fp32
    o    = exp(scale * q_h k_h^T + m - lse) v_h

The residuals keep the port's own layouts: m and dssum are (B, S_query,
S_key) fp32 and lse and delta = rowsum(g * o) are (B, H, S) fp32; the dk/dv
pass reads m and dssum transposed (bf16: from [64 query][64 key] tiles
staged in shared memory; fp32: by its indexing), so the TPU's (B, S, H) lse
layout and the XLA transposes before its dk/dv pass have no counterpart.
Rounding in bf16 follows the Pallas bodies (`_mask_fwd`,
`_fwd_res_kernel`, `_hires_dq_kernel`, `_hires_dkv_kernel`), not
`_bwd_core`: ssum, the mask weights, a = gelu(h1), p, dm, dh1 and the score
gradient are rounded to the compute dtype before their products, every
product accumulates in fp32, o, dq, dk and dv are written in the compute
dtype, m, lse, dssum and the weight grads in fp32.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernels or raises. The bf16 route runs every product on the
tensor cores and takes S, D and Dv that are multiples of 8; the fp32 route
(the card-vs-CPU checks) runs them on the CUDA cores and takes any shape
with D, Dv <= 256. Each wrapper counts its calls in `.launches`; the C
entries report the kernels each call launched and the largest dynamic
shared memory a CTA of them asked for, and the wrappers add the launches
past the counted one to `.stage_launches` and keep the shared memory of
their last call in `.smem_bytes`.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from calm_vit_dte_tpu_torch.kernels._build import library
from calm_vit_dte_tpu_torch.kernels.axial_attention import (
    _dgelu,
    _rounded,
    attention_core,
)
from calm_vit_dte_tpu_torch.utils.remat import replayed

SOURCE = "calm_vit_dte_tpu_torch/csrc/hires_attention.cu"
BWD_SOURCE = "calm_vit_dte_tpu_torch/csrc/hires_attention_bwd.cu"
REPLACES_FWD_RES = "calm_vit_dte_tpu/kernels/axial_attention.py:1069"
REPLACES_DQ = "calm_vit_dte_tpu/kernels/axial_attention.py:1087"
REPLACES_DKV = "calm_vit_dte_tpu/kernels/axial_attention.py:1125"
REPLACES_FWD_ONLY = "calm_vit_dte_tpu/kernels/axial_attention.py:1221"
MAX_D = 256     # head dims the kernels' register tiles hold (D and Dv)
BF16_MULTIPLE = 8  # S, D and Dv of the bf16 route: rows of 16 bytes
_DTYPES = (torch.float32, torch.bfloat16)


# ---------------------------------------------------------------- plain


def _scores(q, k, dtype):
    return _rounded(q, dtype) @ _rounded(k, dtype).transpose(-1, -2)


def _probs(scores, m, lse, scale):
    """exp(scale * scores + m - lse), (B,H,Sq,Sk) fp32."""
    return torch.exp(scores * scale + m[:, None] - lse[..., None])


def hires_fwd_res_plain(q, k, v, w1, b1, w2, b2, *, scale: float,
                        dtype) -> tuple:
    """The forward kernel's function: (o in `dtype`, m (B,S,S) fp32, lse
    (B,H,S) fp32)."""
    scores = _scores(q, k, dtype)
    h1 = _rounded(scores.sum(dim=1), dtype) @ _rounded(w1, dtype).T \
        + b1.float()
    m = _rounded(F.gelu(h1), dtype) @ _rounded(w2, dtype).T + b2.float()
    logits = scores * scale + m[:, None]
    lse = torch.logsumexp(logits, dim=-1)
    p = torch.exp(logits - lse[..., None])
    o = (_rounded(p, dtype) @ _rounded(v, dtype)).to(dtype)
    return o, m, lse


def hires_dq_plain(q, k, v, g, m, lse, delta, w1, b1, w2, *, scale: float,
                   dtype) -> tuple:
    """The query-tiled pass: (dq in `dtype`, dssum (B,S,S), dw1 (2S,S), db1
    (2S,), dw2 (S,2S), db2 (S,), all fp32). g: dL/do in `dtype`; delta =
    rowsum(g * o) (B,H,S) fp32."""
    scores = _scores(q, k, dtype)
    p = _probs(scores, m, lse, scale)
    dl = p * (_scores(g, v, dtype) - delta[..., None])
    dm = _rounded(dl.sum(dim=1), dtype)
    ssum = _rounded(scores.sum(dim=1), dtype)
    w1c = _rounded(w1, dtype)
    h1 = ssum @ w1c.T + b1.float()
    a = _rounded(F.gelu(h1), dtype)
    da = dm @ _rounded(w2, dtype)
    dw2 = torch.einsum("bqk,bqj->kj", dm, a)
    db2 = dm.sum(dim=(0, 1))
    dh1 = _rounded(da * _dgelu(h1), dtype)
    dw1 = torch.einsum("bqj,bqk->jk", dh1, ssum)
    db1 = dh1.sum(dim=(0, 1))
    dssum = dh1 @ w1c
    ds = _rounded(dl * scale + dssum[:, None], dtype)
    dq = (ds @ _rounded(k, dtype)).to(dtype)
    return dq, dssum, dw1, db1, dw2, db2


def hires_dkv_plain(q, k, v, g, m, lse, delta, dssum, *, scale: float,
                    dtype) -> tuple:
    """The key-tiled pass: (dk, dv), both in `dtype`."""
    p = _probs(_scores(q, k, dtype), m, lse, scale)
    gc = _rounded(g, dtype)
    dv = (_rounded(p, dtype).transpose(-1, -2) @ gc).to(dtype)
    dl = p * (_scores(g, v, dtype) - delta[..., None])
    ds = _rounded(dl * scale + dssum[:, None], dtype)
    dk = (ds.transpose(-1, -2) @ _rounded(q, dtype)).to(dtype)
    return dk, dv


# --------------------------------------------------------------- launch


def _check(t, name, shape, dtype, device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(
            f"{name}: expected {shape} {dtype} on {device}, got "
            f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _dims(q, k, v, dtype) -> tuple:
    """(B, H, S, D, Dv) after checking q, k, v for a launch."""
    if dtype not in _DTYPES:
        raise ValueError(f"compute dtype {dtype} not supported; expected "
                         f"one of {_DTYPES}")
    b, h, s, d = q.shape
    dv = v.shape[-1]
    if d > MAX_D or dv > MAX_D:
        raise ValueError(f"head dims D={d}, Dv={dv}: the kernels take at "
                         f"most {MAX_D}")
    if dtype == torch.bfloat16 and (s % BF16_MULTIPLE or d % BF16_MULTIPLE
                                    or dv % BF16_MULTIPLE):
        raise ValueError(f"S={s}, D={d}, Dv={dv}: the bf16 kernels take "
                         f"multiples of {BF16_MULTIPLE}")
    _check(q, "q", (b, h, s, d), dtype, v.device)
    _check(k, "k", (b, h, s, d), dtype, v.device)
    _check(v, "v", (b, h, s, dv), dtype, v.device)
    return b, h, s, d, dv


def _fn(lib: str, name: str, n_ptrs: int, n_flags: int = 0,
        dims: int = 5, scale: bool = True):
    """The C entry point, typed: is_bf16 and `n_flags` more ints, the
    pointers, `dims` ints, the scale (if any), the stream and the launch
    report's int and long long pointers."""
    fn = getattr(library(lib), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * (1 + n_flags)
                       + [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * dims
                       + [ctypes.c_float] * scale + [ctypes.c_void_p]
                       + [ctypes.POINTER(ctypes.c_int),
                          ctypes.POINTER(ctypes.c_longlong)])
        fn.restype = ctypes.c_int
    return fn


def _call(fn, counter, *args) -> int:
    """Call a reporting C entry; add the kernels it launched past the one
    counted in `counter.launches` to `counter.stage_launches` and keep its
    shared memory per CTA in `counter.smem_bytes`. Returns its error."""
    launched, smem = ctypes.c_int(0), ctypes.c_longlong(0)
    err = fn(*args, ctypes.byref(launched), ctypes.byref(smem))
    counter.stage_launches += max(launched.value - 1, 0)
    counter.smem_bytes = smem.value
    return err


def _ptr(t):
    return None if t is None else t.data_ptr()


def _raise_on(err: int, what: str, dims: tuple, dtype) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err} "
                           f"(shape {dims}, {dtype})")


def _launch_fwd(q, k, v, w1, b1, w2, b2, *, scale, dtype, use_mask: bool,
                residuals: bool, counter) -> tuple:
    """The forward on the card: (o, m, lse), m and lse None without
    `residuals` (kernel 4, whose m is scratch). `counter` is the wrapper
    whose stage launches the call adds to."""
    b, h, s, d, dv = dims = _dims(q, k, v, dtype)
    dev = v.device

    def new(shape, dt=torch.float32):
        return torch.empty(shape, dtype=dt, device=dev)

    w1t = w2t = ssum = a = m = None
    if use_mask:
        for name, t, shape in (("w1", w1, (2 * s, s)), ("b1", b1, (2 * s,)),
                               ("w2", w2, (s, 2 * s)), ("b2", b2, (s,))):
            _check(t, name, shape, torch.float32, dev)
        # W1^T and W2^T in the compute dtype: the rounding the Pallas body
        # applies on load.
        w1t = w1.t().to(dtype).contiguous()
        w2t = w2.t().to(dtype).contiguous()
        ssum, a, m = new((b, s, s), dtype), new((b, s, 2 * s), dtype), \
            new((b, s, s))
    else:
        b1 = b2 = None
    o = new((b, h, s, dv), dtype)
    lse = new((b, h, s)) if residuals else None
    err = _call(
        _fn("hires_attention", "hires_attention_fwd", 12, n_flags=2),
        counter, int(dtype == torch.bfloat16), int(residuals), int(use_mask),
        _ptr(q), _ptr(k), _ptr(v), _ptr(w1t), _ptr(b1), _ptr(w2t), _ptr(b2),
        _ptr(ssum), _ptr(a), _ptr(m), _ptr(o), _ptr(lse), b, h, s, d, dv,
        float(scale), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "hires_attention_fwd", dims, dtype)
    return o, (m if residuals else None), lse


def _launch_dq(q, k, v, g, m, lse, delta, w1, b1, w2, *, scale,
               dtype) -> tuple:
    b, h, s, d, dv = dims = _dims(q, k, v, dtype)
    dev = v.device
    _check(g, "g", (b, h, s, dv), dtype, dev)
    for name, t, shape in (("m", m, (b, s, s)), ("lse", lse, (b, h, s)),
                           ("delta", delta, (b, h, s)),
                           ("w1", w1, (2 * s, s)), ("b1", b1, (2 * s,)),
                           ("w2", w2, (s, 2 * s))):
        _check(t, name, shape, torch.float32, dev)
    # The weights in the compute dtype, W1 also transposed (S, 2S).
    w1t = w1.t().to(dtype).contiguous()
    w1c, w2c = w1.to(dtype).contiguous(), w2.to(dtype).contiguous()

    def new(shape, dt=torch.float32):
        return torch.empty(shape, dtype=dt, device=dev)

    dq, dssum = new((b, h, s, d), dtype), new((b, s, s))
    # The per-row factors of the weight grads, and gelu'(h1).
    ssum, dm = new((b, s, s), dtype), new((b, s, s), dtype)
    a, dh1, gp = (new((b, s, 2 * s), dtype), new((b, s, 2 * s), dtype),
                  new((b, s, 2 * s)))
    err = _call(
        _fn("hires_attention_bwd", "hires_attention_dq", 18), hires_dq,
        int(dtype == torch.bfloat16), _ptr(q), _ptr(k), _ptr(v), _ptr(g),
        _ptr(m), _ptr(lse), _ptr(delta), _ptr(w1t), _ptr(b1), _ptr(w1c),
        _ptr(w2c), _ptr(dq), _ptr(dssum), _ptr(ssum), _ptr(dm), _ptr(a),
        _ptr(gp), _ptr(dh1), b, h, s, d, dv, float(scale),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "hires_attention_dq", dims, dtype)
    hires_dq.launches += 1
    return (dq, dssum) + hires_weight_grads(ssum, dm, a, dh1)


def hires_weight_grads_plain(ssum, dm, a, dh1) -> tuple:
    """The mask-MLP weight grads from the dq pass's per-row factors (all
    (B,S,S) or (B,S,2S) in the compute dtype): (dw1 (2S,S), db1 (2S,), dw2
    (S,2S), db2 (S,)), fp32 sums over the B*S rows."""
    dm, a, dh1, ssum = dm.float(), a.float(), dh1.float(), ssum.float()
    return (torch.einsum("bqj,bqk->jk", dh1, ssum), dh1.sum(dim=(0, 1)),
            torch.einsum("bqk,bqj->kj", dm, a), dm.sum(dim=(0, 1)))


def hires_weight_grads(ssum, dm, a, dh1) -> tuple:
    """The weight-grad reduction that `hires_dq` runs on the card after its
    pass: X^T Y products and column sums over the B*S rows, every sum in a
    fixed order (bf16: the products split over fixed row ranges whose
    partials are added in order; no atomics, the same bits from run to
    run). Same returns as `hires_weight_grads_plain`."""
    if _on(dm) == "cpu":
        return hires_weight_grads_plain(ssum, dm, a, dh1)
    b, s, _ = dm.shape
    dev, dtype = dm.device, dm.dtype
    for name, t, shape in (("ssum", ssum, (b, s, s)), ("dm", dm, (b, s, s)),
                           ("a", a, (b, s, 2 * s)),
                           ("dh1", dh1, (b, s, 2 * s))):
        _check(t, name, shape, dtype, dev)
    outs = [torch.empty(shape, dtype=torch.float32, device=dev)
            for shape in ((2 * s, s), (2 * s,), (s, 2 * s), (s,))]
    bf16 = int(dtype == torch.bfloat16)
    if bf16 and s % BF16_MULTIPLE:
        raise ValueError(f"S={s}: the bf16 kernels take multiples of "
                         f"{BF16_MULTIPLE}")
    scratch = library("hires_attention_bwd").hires_weight_grads_scratch
    if scratch.argtypes is None:
        scratch.argtypes = [ctypes.c_int] * 2
        scratch.restype = ctypes.c_longlong
    part = torch.empty(scratch(bf16, s), dtype=torch.float32, device=dev)
    err = _call(
        _fn("hires_attention_bwd", "hires_weight_grads", 9, dims=2,
            scale=False), hires_weight_grads,
        bf16, _ptr(ssum), _ptr(dm), _ptr(a), _ptr(dh1), *map(_ptr, outs),
        _ptr(part), b * s, s, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "hires_weight_grads", (b, s), dtype)
    hires_weight_grads.launches += 1
    return tuple(outs)


def _launch_dkv(q, k, v, g, m, lse, delta, dssum, *, scale,
                dtype) -> tuple:
    b, h, s, d, dv = dims = _dims(q, k, v, dtype)
    dev = v.device
    _check(g, "g", (b, h, s, dv), dtype, dev)
    for name, t, shape in (("m", m, (b, s, s)), ("lse", lse, (b, h, s)),
                           ("delta", delta, (b, h, s)),
                           ("dssum", dssum, (b, s, s))):
        _check(t, name, shape, torch.float32, dev)
    dk = torch.empty((b, h, s, d), dtype=dtype, device=dev)
    dvv = torch.empty((b, h, s, dv), dtype=dtype, device=dev)
    err = _call(
        _fn("hires_attention_bwd", "hires_attention_dkv", 10), hires_dkv,
        int(dtype == torch.bfloat16), _ptr(q), _ptr(k), _ptr(v), _ptr(g),
        _ptr(m), _ptr(lse), _ptr(delta), _ptr(dssum), _ptr(dk), _ptr(dvv),
        b, h, s, d, dv, float(scale),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "hires_attention_dkv", dims, dtype)
    hires_dkv.launches += 1
    return dk, dvv


def _on(t: torch.Tensor) -> str:
    """'cpu' (run the plain version) or 'cuda' (launch); raises on any
    other device."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {t.device}")
    return t.device.type


# -------------------------------------------------------------- wrappers


def hires_fwd_res(q, k, v, w1, b1, w2, b2, *, scale: float, dtype) -> tuple:
    """(o, m, lse) of the forward kernel that saves residuals (the
    Function's forward); same returns as `hires_fwd_res_plain`."""
    if _on(v) == "cpu":
        return hires_fwd_res_plain(q, k, v, w1, b1, w2, b2, scale=scale,
                                   dtype=dtype)
    out = _launch_fwd(q, k, v, w1, b1, w2, b2, scale=scale, dtype=dtype,
                      use_mask=True, residuals=True,
                      counter=fused_hires_attention)
    fused_hires_attention.launches += 1
    return out


def hires_dq(q, k, v, g, m, lse, delta, w1, b1, w2, *, scale: float,
             dtype) -> tuple:
    """The query-tiled backward pass; same returns as `hires_dq_plain`. On
    the card its mask-MLP weight grads are a second launch,
    `hires_weight_grads`."""
    args = (q, k, v, g, m, lse, delta, w1, b1, w2)
    if _on(v) == "cpu":
        return hires_dq_plain(*args, scale=scale, dtype=dtype)
    return _launch_dq(*args, scale=scale, dtype=dtype)


def hires_dkv(q, k, v, g, m, lse, delta, dssum, *, scale: float,
              dtype) -> tuple:
    """The key-tiled backward pass; same returns as `hires_dkv_plain`."""
    args = (q, k, v, g, m, lse, delta, dssum)
    if _on(v) == "cpu":
        return hires_dkv_plain(*args, scale=scale, dtype=dtype)
    return _launch_dkv(*args, scale=scale, dtype=dtype)


class _FusedHiresAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, scale, dtype, q, k, v, w1, b1, w2, b2):
        # Under activation checkpointing the replay takes the first run's
        # output and residuals instead of launching again.
        o, m, lse = replayed(lambda: hires_fwd_res(
            q, k, v, w1, b1, w2, b2, scale=scale, dtype=dtype))
        ctx.scale, ctx.dtype = scale, dtype
        ctx.save_for_backward(q, k, v, w1, b1, w2, b2, o, m, lse)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, w1, b1, w2, b2, o, m, lse = ctx.saved_tensors
        kw = dict(scale=ctx.scale, dtype=ctx.dtype)
        # delta = rowsum(g * o): the flash-backward identity for the softmax
        # jacobian (an XLA epilogue in the JAX package, torch here).
        delta = (g.float() * o.float()).sum(dim=-1)
        g = g.to(ctx.dtype).contiguous()
        dq, dssum, dw1, db1, dw2, db2 = hires_dq(q, k, v, g, m, lse, delta,
                                                 w1, b1, w2, **kw)
        dk, dv = hires_dkv(q, k, v, g, m, lse, delta, dssum, **kw)
        return (None, None, dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
                db2.to(b2.dtype))


def fused_hires_attention(q, k, v, w1, b1, w2, b2, *, scale: float,
                          dtype) -> torch.Tensor:
    """Fused masked attention with the two-pass backward, for shapes past
    the rope kernel's limits (the JAX function of the same name; the mask
    is always on, callers pass zero weights for none).

    q, k: (B,H,S,D) rotated; v: (B,H,S,Dv); w1 (2S,S), b1 (2S,), w2 (S,2S),
    b2 (S,) fp32 spectral-normalized mask weights. Returns (B,H,S,Dv) in
    `dtype`, differentiable in all seven inputs. q, k, v are cast to
    `dtype`; on the card they must then be contiguous."""
    return _FusedHiresAttention.apply(scale, dtype, q.to(dtype), k.to(dtype),
                                      v.to(dtype), w1, b1, w2, b2)


def fused_attention_forward(q, k, v, w1, b1, w2, b2, *, scale: float, dtype,
                            use_mask: bool = True) -> torch.Tensor:
    """Forward-only fused attention (no residuals, not differentiable): the
    serving and eval forward of the long-sequence shapes. Same inputs as
    `fused_hires_attention`; the weights are unused when use_mask is False.
    The plain version is `axial_attention.attention_core`."""
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    if _on(v) == "cpu":
        return attention_core(q, k, v, w1, b1, w2, b2, scale=scale,
                              dtype=dtype, use_mask=use_mask)
    o, _, _ = _launch_fwd(q, k, v, w1, b1, w2, b2, scale=scale, dtype=dtype,
                          use_mask=use_mask, residuals=False,
                          counter=fused_attention_forward)
    fused_attention_forward.launches += 1
    return o


fused_hires_attention.launches = 0
hires_dq.launches = 0
hires_weight_grads.launches = 0
hires_dkv.launches = 0
fused_attention_forward.launches = 0
# The launches each card call makes past its counted one, and the largest
# dynamic shared memory per CTA of the last card call, as the C entries
# report them.
for _counter in (fused_hires_attention, hires_dq, hires_weight_grads,
                 hires_dkv, fused_attention_forward):
    _counter.stage_launches = 0
    _counter.smem_bytes = 0
del _counter
