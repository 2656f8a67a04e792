"""Fused axial attention with in-kernel RoPE and the learned additive mask:
the CUDA kernels' wrappers (forward and backward, joined in one
`torch.autograd.Function`) and their plain PyTorch versions.

JAX counterpart: calm_vit_dte_tpu/kernels/axial_attention.py,
`fused_rope_attention` (the Pallas kernels built by `_make_rope_fused`:
forward body `_fwd_body`, backward `bwd_kernel` on `_bwd_core`; with no rope
half it is `_make_fused`). The kernel sources and their design notes are in
csrc/axial_attention.cu and csrc/axial_attention_bwd.cu; the forward
computes, per batch element and head,

    q = [qc | rope(qr)],  k = [kc | rope(kr)]
    ssum = sum_h q_h k_h^T                      (B, S, S), over heads
    m    = gelu(ssum W1^T + b1) W2^T + b2       mask MLP over the key axis
    out  = softmax(scale * q_h k_h^T + m) v_h   softmax in fp32

On a CPU tensor the wrappers run the plain versions; on a CUDA tensor they
launch a kernel or raise. The forward source holds two kernels of the same
function: a CUDA-core one (fp32, and bf16 at any S) and a WMMA tensor-core
one (bf16, S % 16 == 0), chosen by `uses_tensor_cores`. All round like
`_fwd_body` in bf16: ssum, the mask weights, the GELU output and p are
rounded to the compute dtype before their products, and every product
accumulates in fp32. The backward recomputes the forward and rounds like
`_bwd_core` (p, dm, a, dh1 and the score gradient); it returns the gradients
of all 13 tensor inputs, the four RoPE tables and the mask MLP included.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from calm_vit_dte_tpu_torch.kernels._build import library
from calm_vit_dte_tpu_torch.ops.rope import rope_rotate, rotate_half
from calm_vit_dte_tpu_torch.utils.remat import replayed

SOURCE = "calm_vit_dte_tpu_torch/csrc/axial_attention.cu"
REPLACES = "calm_vit_dte_tpu/kernels/axial_attention.py:682"
BWD_SOURCE = "calm_vit_dte_tpu_torch/csrc/axial_attention_bwd.cu"
BWD_REPLACES = "calm_vit_dte_tpu/kernels/axial_attention.py:717"
BWD_REPLACES_NO_ROPE = "calm_vit_dte_tpu/kernels/axial_attention.py:547"
MAX_S = 256     # keys a CTA holds: 8 per lane
MAX_DV = 64     # two output columns per lane
_SMEM_LIMIT = 232448
_DTYPES = (torch.float32, torch.bfloat16)


def _rounded(x: torch.Tensor, dtype) -> torch.Tensor:
    """x rounded to the compute dtype, held in fp32 so that products
    accumulate in fp32 (the Pallas kernel's preferred_element_type)."""
    return x.to(dtype).float()


def attention_core(q, k, v, w1, b1, w2, b2, *, scale: float, dtype,
                   use_mask: bool) -> torch.Tensor:
    """Plain attention math on rotated q, k: (B,H,S,D); v: (B,H,S,Dv); mask
    weights spectral-normalized (w1 (2S,S), b1, w2 (S,2S), b2). Returns
    (B,H,S,Dv) in `dtype`."""
    scores = _rounded(q, dtype) @ _rounded(k, dtype).transpose(-1, -2)
    logits = scores * scale
    if use_mask:
        ssum = scores.sum(dim=1)   # == the flattened-head q k^T
        h1 = _rounded(ssum, dtype) @ _rounded(w1, dtype).T + b1.float()
        a = F.gelu(h1)
        m = _rounded(a, dtype) @ _rounded(w2, dtype).T + b2.float()
        logits = logits + m[:, None]
    p = torch.softmax(logits, dim=-1)
    return (_rounded(p, dtype) @ _rounded(v, dtype)).to(dtype)


def _assemble(c, r, cos, sin, dtype) -> torch.Tensor:
    """[c | rope(r)] in `dtype`; either half may be None."""
    parts = [] if c is None else [c.to(dtype)]
    if r is not None:
        parts.append(rope_rotate(r.to(dtype), cos, sin))
    return torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]


def fused_rope_attention_plain(qc, qr, kc, kr, v, cos_q, sin_q, cos_k,
                               sin_k, w1, b1, w2, b2, *, scale: float, dtype,
                               use_mask: bool = True) -> torch.Tensor:
    """The kernel's function in torch ops: rotate and concat, then
    `attention_core`."""
    q = _assemble(qc, qr, cos_q, sin_q, dtype)
    k = _assemble(kc, kr, cos_k, sin_k, dtype)
    return attention_core(q, k, v, w1, b1, w2, b2, scale=scale, dtype=dtype,
                          use_mask=use_mask)


def _kernel_fn(tensor_cores: bool):
    lib = library("axial_attention")
    if tensor_cores:
        fn = lib.rope_attention_fwd_tc
        lead = []
    else:
        fn = lib.rope_attention_fwd
        lead = [ctypes.c_int]
    if fn.argtypes is None:
        fn.argtypes = (lead + [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


# Smallest S at which bf16 goes to the WMMA kernel. Below it the CUDA-core
# kernel was as fast or faster on the H100 (chip_smoke.py times both paths
# at every flagship shape; PERF.md).
TENSOR_CORE_MIN_S = 176


def uses_tensor_cores(dtype, s: int, d: int) -> bool:
    """bf16 at S % 16 == 0 and S >= TENSOR_CORE_MIN_S runs the WMMA kernel;
    fp32 and other S run the CUDA-core kernel."""
    return (dtype == torch.bfloat16 and s % 16 == 0
            and s >= TENSOR_CORE_MIN_S and d <= 64)


def smem_bytes(s: int, d: int, dv: int, tensor_cores: bool) -> int:
    """Dynamic shared memory of one CTA (mirrors the source's layouts)."""
    if tensor_cores:
        dp, dvp = -(-d // 16) * 16, -(-dv // 16) * 16
        ldq, ldkv = max(dp, 32) + 8, max(dp, dvp) + 8
        return 2 * 64 * ldq + 2 * s * ldkv + 4 * 64 * (max(s, 64) + 4) \
            + 2 * 64 * (s + 8)
    sp = 32 * ((s + 31) // 32)
    ld = d | 1
    return 4 * (32 * ld + sp * max(ld, dv) + 32 * sp + 32 * 2 * sp)


def _check(t: torch.Tensor | None, name: str, shape: tuple, dtype,
           device) -> None:
    if t is None:
        raise ValueError(f"{name} is required")
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(
            f"{name}: expected {shape} {dtype} on {device}, got "
            f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(qc, qr, kc, kr, v, cos_q, sin_q, cos_k, sin_k, w1, b1, w2, b2,
            *, scale, dtype, use_mask,
            tensor_cores: bool | None = None) -> torch.Tensor:
    """Launch on the card. `tensor_cores` None picks the kernel by
    `uses_tensor_cores`; chip_smoke.py forces each to time both."""
    if dtype not in _DTYPES:
        raise ValueError(f"compute dtype {dtype} not supported; "
                         f"expected one of {_DTYPES}")
    dev = v.device
    b, h, s, dv = v.shape
    dc = 0 if qc is None else qc.shape[-1]
    dr = 0 if qr is None else qr.shape[-1]
    if s > MAX_S or dv > MAX_DV or dr % 2 or dc + dr == 0:
        raise ValueError(f"unsupported shape: S={s} (<= {MAX_S}), "
                         f"Dv={dv} (<= {MAX_DV}), Dc={dc}, Dr={dr} (even)")
    if tensor_cores is None:
        tensor_cores = uses_tensor_cores(dtype, s, dc + dr)
    elif tensor_cores and (dtype != torch.bfloat16 or s % 16
                           or dc + dr > 64):
        raise ValueError("the tensor-core kernel takes bf16, S % 16 == 0 "
                         "and D <= 64")
    if smem_bytes(s, dc + dr, dv, tensor_cores) > _SMEM_LIMIT:
        raise ValueError(f"S={s}, D={dc + dr}, Dv={dv} needs more shared "
                         "memory than a CTA has")
    _check(v, "v", (b, h, s, dv), dtype, dev)
    for name, t, dim in (("qc", qc, dc), ("kc", kc, dc), ("qr", qr, dr),
                         ("kr", kr, dr)):
        if dim:
            _check(t, name, (b, h, s, dim), dtype, dev)
    if dr:
        for name, t in (("cos_q", cos_q), ("sin_q", sin_q),
                        ("cos_k", cos_k), ("sin_k", sin_k)):
            _check(t, name, (s, dr), torch.float32, dev)
    w1t = w2t = None
    if use_mask:
        for name, t, shape in (("w1", w1, (2 * s, s)), ("b1", b1, (2 * s,)),
                               ("w2", w2, (s, 2 * s)), ("b2", b2, (s,))):
            _check(t, name, shape, torch.float32, dev)
        # The tensor-core kernel reads the weights as bf16 (the rounding
        # the CUDA-core kernel applies on load).
        wdtype = torch.bfloat16 if tensor_cores else torch.float32
        w1t = w1.t().to(wdtype).contiguous()
        w2t = w2.t().to(wdtype).contiguous()
    out = torch.empty((b, h, s, dv), dtype=dtype, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lead = () if tensor_cores else (int(dtype == torch.bfloat16),)
    err = _kernel_fn(tensor_cores)(
        *lead, ptr(qc), ptr(kc), ptr(qr), ptr(kr),
        ptr(v), ptr(cos_q if dr else None), ptr(sin_q if dr else None),
        ptr(cos_k if dr else None), ptr(sin_k if dr else None), ptr(w1t),
        ptr(b1 if use_mask else None), ptr(w2t),
        ptr(b2 if use_mask else None), ptr(out), b, h, s, dc, dr, dv,
        float(scale), int(use_mask),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rope_attention_fwd launch failed: CUDA error "
                           f"{err} (B={b}, H={h}, S={s}, Dc={dc}, Dr={dr}, "
                           f"Dv={dv}, {dtype})")
    fused_rope_attention.launches += 1
    return out


def _dgelu(x: torch.Tensor) -> torch.Tensor:
    """d/dx of the exact GELU: Phi(x) + x * phi(x)."""
    cdf = 0.5 * (1.0 + torch.erf(x * (1.0 / math.sqrt(2.0))))
    pdf = torch.exp(-0.5 * x * x) * (1.0 / math.sqrt(2.0 * math.pi))
    return cdf + x * pdf


def _unrotate(gr32: torch.Tensor, x, cos, sin, dtype, out_dtype):
    """The rope half's pull-back. gr32: fp32 gradient of the rotated half;
    x: the un-rotated input. Returns (d x, d cos, d sin): R^T = -R for the
    rotate-half map, in `dtype` arithmetic as the kernel does it; the table
    terms are fp32 sums over batch and heads."""
    gc = gr32.to(dtype)
    dx = (gc * cos.to(dtype) - rotate_half(gc * sin.to(dtype))).to(out_dtype)
    x32 = x.to(dtype).float()
    return (dx, (x32 * gr32).sum(dim=(0, 1)),
            (rotate_half(x32) * gr32).sum(dim=(0, 1)))


def fused_rope_attention_bwd_plain(g, qc, qr, kc, kr, v, cos_q, sin_q, cos_k,
                                   sin_k, w1, b1, w2, b2, *, scale: float,
                                   dtype, use_mask: bool = True) -> tuple:
    """The backward kernel's function in torch ops: explicit formulas with
    the kernel's rounding points, not autograd of the forward.

    g: dL/dout (B,H,S,Dv). Returns the 13 gradients in the order of the
    inputs (qc, qr, kc, kr, v, cos_q, sin_q, cos_k, sin_k, w1, b1, w2, b2),
    None where the input is absent; dqc/dqr in `dtype`, all others fp32.
    """
    q = _assemble(qc, qr, cos_q, sin_q, dtype).float()
    k = _assemble(kc, kr, cos_k, sin_k, dtype).float()
    vc, gc = _rounded(v, dtype), _rounded(g, dtype)
    scores = q @ k.transpose(-1, -2)
    logits = scores * scale
    if use_mask:
        w1c, w2c = _rounded(w1, dtype), _rounded(w2, dtype)
        ssum = _rounded(scores.sum(dim=1), dtype)
        h1 = ssum @ w1c.T + b1.float()
        a = _rounded(F.gelu(h1), dtype)
        logits = logits + (a @ w2c.T + b2.float())[:, None]
    p = torch.softmax(logits, dim=-1)
    dv = _rounded(p, dtype).transpose(-1, -2) @ gc
    dp = gc @ vc.transpose(-1, -2)
    dl = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dscores = dl * scale
    dw1 = db1 = dw2 = db2 = None
    if use_mask:
        dm = _rounded(dl.sum(dim=1), dtype)                  # (B,S,S)
        dw2 = torch.einsum("bqk,bqj->kj", dm, a)             # (S,2S)
        db2 = dm.sum(dim=(0, 1))
        dh1 = _rounded((dm @ w2c) * _dgelu(h1), dtype)       # (B,S,2S)
        dw1 = torch.einsum("bqj,bqk->jk", dh1, ssum)         # (2S,S)
        db1 = dh1.sum(dim=(0, 1))
        dscores = dscores + (dh1 @ w1c)[:, None]
    ds = _rounded(dscores, dtype)
    dq = ds @ k                                              # fp32
    dk = ds.transpose(-1, -2) @ q
    dc = 0 if qc is None else qc.shape[-1]
    dqc = dkc = dqr = dkr = dcq = dsq = dck = dsk = None
    if dc:
        dqc, dkc = dq[..., :dc].to(dtype), dk[..., :dc]
    if qr is not None:
        dqr, dcq, dsq = _unrotate(dq[..., dc:], qr, cos_q, sin_q, dtype,
                                  dtype)
        dkr, dck, dsk = _unrotate(dk[..., dc:], kr, cos_k, sin_k, dtype,
                                  torch.float32)
    return (dqc, dqr, dkc, dkr, dv, dcq, dsq, dck, dsk, dw1, db1, dw2, db2)


WEIGHT_TILE = 64   # output tile of the weight-grad kernel (kWTile)


def weight_grad_splits(b: int, s: int) -> int:
    """Row splits of the weight-grad products: enough CTAs to fill the card
    twice, at least 16 rows each."""
    tiles = -(-s // WEIGHT_TILE) * -(-2 * s // WEIGHT_TILE)
    return max(1, min(-(-264 // tiles), b * s // 16, 64))


def bwd_smem_bytes(s: int, d: int, dv: int) -> int:
    """Dynamic shared memory of one backward CTA (mirrors the source)."""
    sp = 32 * ((s + 31) // 32)
    ld = d | 1
    ldq = max(ld, dv | 1)
    return 4 * (32 * ldq + sp * ldq + 32 * sp + 32 * 2 * sp + 32 * ld)


# Slots of the backward's pointer array, in the order of the source's enum.
_BWD_SLOTS = ("qc", "kc", "qr", "kr", "v", "g", "cos_q", "sin_q", "cos_k",
              "sin_k", "w1", "w1t", "b1", "w2", "w2t", "b2", "dqc", "dqr",
              "dkc", "dkr", "dv", "tab_out", "wgrad", "tab_part", "dk_full",
              "dlog", "gprime", "ssum", "a", "dm", "dh1", "wpart")


def _launch_bwd(g, qc, qr, kc, kr, v, cos_q, sin_q, cos_k, sin_k, w1, b1,
                w2, b2, *, scale, dtype, use_mask) -> tuple:
    """Launch the backward on the card; same returns as the plain version.
    Inputs were checked by the forward launch; g must match v."""
    dev = v.device
    b, h, s, dv = v.shape
    dc = 0 if qc is None else qc.shape[-1]
    dr = 0 if qr is None else qr.shape[-1]
    d = dc + dr
    if d > 64:
        raise ValueError(f"the backward kernel takes D <= 64, got {d}")
    if bwd_smem_bytes(s, d, dv) > _SMEM_LIMIT:
        raise ValueError(f"S={s}, D={d}, Dv={dv} needs more shared memory "
                         "than a CTA has")
    _check(g, "g", (b, h, s, dv), dtype, dev)

    def new(shape, dt=torch.float32):
        return torch.empty(shape, dtype=dt, device=dev)

    t = {"qc": qc, "kc": kc, "qr": qr, "kr": kr, "v": v, "g": g,
         "dv": new((b, h, s, dv)), "dk_full": new((b, h, s, d)),
         "dlog": new((b, h, s, s))}
    if dc:
        t["dqc"] = new((b, h, s, dc), dtype)
    if dr:
        t.update(cos_q=cos_q, sin_q=sin_q, cos_k=cos_k, sin_k=sin_k,
                 dqr=new((b, h, s, dr), dtype), dkr=new((b, h, s, dr)),
                 tab_out=new((4, s, dr)), tab_part=new((b, 4, s, dr)))
        if dc:
            t["dkc"] = new((b, h, s, dc))
    else:
        t["dkc"] = t["dk_full"]
    splits = 1
    if use_mask:
        splits = weight_grad_splits(b, s)
        n_w = 2 * s * s
        total = 2 * n_w + 3 * s
        t.update(w1=w1, w1t=w1.t().contiguous(), b1=b1, w2=w2,
                 w2t=w2.t().contiguous(), b2=b2, wgrad=new((total,)),
                 wpart=new((splits, total)), gprime=new((b, s, 2 * s)),
                 ssum=new((b, s, s), dtype), a=new((b, s, 2 * s), dtype),
                 dm=new((b, s, s), dtype), dh1=new((b, s, 2 * s), dtype))
    ptrs = (ctypes.c_void_p * len(_BWD_SLOTS))(
        *(None if t.get(name) is None else t[name].data_ptr()
          for name in _BWD_SLOTS))
    fn = library("axial_attention_bwd").rope_attention_bwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    err = fn(int(dtype == torch.bfloat16), ptrs, b, h, s, dc, dr, dv,
             float(scale), int(use_mask), splits,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rope_attention_bwd launch failed: CUDA error "
                           f"{err} (B={b}, H={h}, S={s}, Dc={dc}, Dr={dr}, "
                           f"Dv={dv}, {dtype})")
    fused_rope_attention_bwd.launches += 1
    tabs = t["tab_out"] if dr else (None,) * 4
    dw1 = db1 = dw2 = db2 = None
    if use_mask:
        wg = t["wgrad"]
        dw1, db1, dw2, db2 = torch.split(wg, [n_w, 2 * s, n_w, s])
        dw1, dw2 = dw1.view(2 * s, s), dw2.view(s, 2 * s)
    return (t.get("dqc"), t.get("dqr"), t.get("dkc"), t.get("dkr"), t["dv"],
            *tabs, dw1, db1, dw2, db2)


def fused_rope_attention_bwd(g, qc, qr, kc, kr, v, cos_q, sin_q, cos_k,
                             sin_k, w1, b1, w2, b2, *, scale: float, dtype,
                             use_mask: bool = True) -> tuple:
    """Gradients of `fused_rope_attention` for the output gradient g: the
    plain version on CPU tensors, the kernel on CUDA tensors (or it raises).
    Same returns as `fused_rope_attention_bwd_plain`."""
    args = (g, qc, qr, kc, kr, v, cos_q, sin_q, cos_k, sin_k, w1, b1, w2, b2)
    if v.device.type == "cpu":
        return fused_rope_attention_bwd_plain(*args, scale=scale,
                                              dtype=dtype, use_mask=use_mask)
    if v.device.type != "cuda":
        raise ValueError(f"no kernel for device {v.device}")
    return _launch_bwd(*args, scale=scale, dtype=dtype, use_mask=use_mask)


fused_rope_attention_bwd.launches = 0


def _forward(args, scale, dtype, use_mask) -> torch.Tensor:
    v = args[4]
    if v.device.type == "cpu":
        return fused_rope_attention_plain(*args, scale=scale, dtype=dtype,
                                          use_mask=use_mask)
    if v.device.type != "cuda":
        raise ValueError(f"no kernel for device {v.device}")
    return _launch(*args, scale=scale, dtype=dtype, use_mask=use_mask)


class _FusedRopeAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, scale, dtype, use_mask, *args):
        # Under activation checkpointing the replay takes the first run's
        # output instead of launching again (the JAX step's saved
        # "attn_out").
        out = replayed(lambda: _forward(args, scale, dtype, use_mask))
        ctx.scale, ctx.dtype, ctx.use_mask = scale, dtype, use_mask
        ctx.present = [a is not None for a in args]
        ctx.save_for_backward(*(a for a in args if a is not None))
        return out

    @staticmethod
    def backward(ctx, g):
        tensors = iter(ctx.saved_tensors)
        args = [next(tensors) if there else None for there in ctx.present]
        dtype = ctx.dtype
        grads = fused_rope_attention_bwd(
            g.to(dtype).contiguous(), *args, scale=ctx.scale, dtype=dtype,
            use_mask=ctx.use_mask)
        # Cast to the inputs' dtypes (the Pallas wrapper's `fused_bwd`).
        return (None, None, None) + tuple(
            None if a is None or gr is None else gr.to(a.dtype)
            for a, gr in zip(args, grads))


def fused_rope_attention(qc, qr, kc, kr, v, cos_q, sin_q, cos_k, sin_k,
                         w1, b1, w2, b2, *, scale: float, dtype,
                         use_mask: bool = True) -> torch.Tensor:
    """Fused attention with in-kernel RoPE and optional content halves.

    qr, kr: (B,H,S,Dr) un-rotated rope halves, or None (no rotation);
    qc, kc: (B,H,S,Dc) content halves or None; v: (B,H,S,Dv); cos/sin:
    (S,Dr) fp32 tables; w1 (2S,S), b1 (2S,), w2 (S,2S), b2 (S,) fp32
    spectral-normalized mask weights (unused when use_mask is False).
    Returns (B,H,S,Dv) in `dtype`. A CPU tensor runs the plain versions; on
    the card q/k/v must already be contiguous and in `dtype`. Differentiable
    in every tensor input: the backward is `fused_rope_attention_bwd`.
    """
    args = (qc, qr, kc, kr, v, cos_q, sin_q, cos_k, sin_k, w1, b1, w2, b2)
    if not use_mask:
        args = args[:9] + (None,) * 4
    return _FusedRopeAttention.apply(scale, dtype, use_mask, *args)


fused_rope_attention.launches = 0
