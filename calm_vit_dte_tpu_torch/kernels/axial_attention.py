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
launch a kernel or raise. bf16 runs on the tensor cores (mma.sync, bf16 in,
fp32 accumulate): the forward is one kernel; the backward is a rows kernel
(dq, the mask MLP backward, per-row softmax statistics), a keys kernel (dk,
dv) and the weight-grad products, launched by one call. fp32 runs on the
CUDA-core kernels of the same sources (the card-vs-CPU parity checks). Both
round like `_fwd_body` in bf16: ssum, the mask weights, the GELU output and
p are rounded to the compute dtype before their products, and every product
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
MAX_S = 256     # keys a CTA holds (the whole key axis)
MAX_DV = 64
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


def _fn(lib: str, name: str, argtypes: list):
    fn = getattr(library(lib), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_FWD_ARGS = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_FWD_ARGS_BF16 = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 6
                  + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
                     ctypes.POINTER(ctypes.c_int)])

ROWS_PER_CTA = 64    # query (or key) rows of one bf16 CTA: 4 warps x 16
_THREADS_BF16 = 128
_SM_SMEM = 233472    # shared memory of one SM; each CTA also reserves 1 KB
_SM_REGS = 65536


def _pad16(x: int) -> int:
    return -(-x // 16) * 16


def _ld(width: int) -> int:
    """Row stride (elements) of a padded bf16 tile (ld_bf16)."""
    return _pad16(width) + 8


def _w_stage_bytes(s: int) -> int:
    """One mask-MLP weight stage: W1 chunk [16][SP+8] + W2 chunk [SP][24]
    bf16 (w_stage_elems)."""
    sp = _pad16(s)
    return 2 * (16 * (sp + 8) + sp * 24)


def _fwd_layout(s: int, d: int, dv: int, use_mask: bool) -> tuple:
    """(bytes, K/V stages) of one bf16 forward CTA (FwdSmem): the fp32 mask
    [64][SP+8], then a K and a V tile [SP][ld] where two CTAs of that size
    still fit on an SM, else one tile for both (or, larger, the two MLP
    weight stages)."""
    sp = _pad16(s)
    tile = sp * max(_ld(d), _ld(dv)) * 2
    w = 2 * _w_stage_bytes(s) if use_mask else 0
    m = ROWS_PER_CTA * (sp + 8) * 4 if use_mask else 0
    two = m + max(2 * tile, w)
    if 2 * (two + 1024) <= _SM_SMEM:
        return two, 2
    return m + max(tile, w), 1


def smem_bytes(s: int, d: int, dv: int, use_mask: bool = True) -> int:
    """Dynamic shared memory of one bf16 forward CTA (FwdSmem)."""
    return _fwd_layout(s, d, dv, use_mask)[0]


def fwd_kv_stages(s: int, d: int, dv: int, use_mask: bool = True) -> int:
    """K/V stages of the bf16 forward: 2 where a V tile beside the K tile
    still lets two CTAs share an SM."""
    return _fwd_layout(s, d, dv, use_mask)[1]


def smem_bytes_f32(s: int, d: int, dv: int) -> int:
    """Dynamic shared memory of one fp32 (CUDA-core) forward CTA."""
    sp = 32 * ((s + 31) // 32)
    ld = d | 1
    return 4 * (32 * ld + sp * max(ld, dv) + 32 * sp + 32 * 2 * sp)


def grid(s: int, b: int) -> tuple[int, int]:
    """CTAs of each bf16 kernel (forward, backward rows and keys): one per
    64 query (keys: key) rows of one batch element."""
    return -(-s // ROWS_PER_CTA), b


def ctas_per_sm(smem: int, regs_per_thread: int = 0) -> int:
    """CTAs of 128 threads that fit on one SM by shared memory (and, given,
    by registers)."""
    n = _SM_SMEM // (smem + 1024)
    if regs_per_thread:
        n = min(n, _SM_REGS // (regs_per_thread * _THREADS_BF16))
    return n


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


def _mask_weights_bf16(w1, b1, w2, s: int):
    """The mask weights rounded to bf16 once per launch and zero-padded for
    the tensor-core kernels: W1 (pad16(2S), pad16(S)), b1 (pad16(2S),) fp32,
    W2 (pad16(S), pad16(2S))."""
    sp, h2p = _pad16(s), _pad16(2 * s)
    w1b = F.pad(w1.to(torch.bfloat16), (0, sp - s, 0, h2p - 2 * s))
    w2b = F.pad(w2.to(torch.bfloat16), (0, h2p - 2 * s, 0, sp - s))
    return w1b.contiguous(), F.pad(b1, (0, h2p - 2 * s)), w2b.contiguous()


def _launch(qc, qr, kc, kr, v, cos_q, sin_q, cos_k, sin_k, w1, b1, w2, b2,
            *, scale, dtype, use_mask) -> torch.Tensor:
    """Launch on the card: bf16 on the tensor-core kernel, fp32 on the
    CUDA-core one."""
    if dtype not in _DTYPES:
        raise ValueError(f"compute dtype {dtype} not supported; "
                         f"expected one of {_DTYPES}")
    bf16 = dtype == torch.bfloat16
    dev = v.device
    b, h, s, dv = v.shape
    dc = 0 if qc is None else qc.shape[-1]
    dr = 0 if qr is None else qr.shape[-1]
    if s > MAX_S or dv > MAX_DV or dr % 2 or dc + dr == 0:
        raise ValueError(f"unsupported shape: S={s} (<= {MAX_S}), "
                         f"Dv={dv} (<= {MAX_DV}), Dc={dc}, Dr={dr} (even)")
    if bf16 and (dc + dr > 64 or dc % 2 or dv % 2):
        raise ValueError(f"the bf16 kernel takes D <= 64 and even Dc, Dv; "
                         f"got Dc={dc}, Dr={dr}, Dv={dv}")
    smem = (smem_bytes(s, dc + dr, dv, use_mask) if bf16
            else smem_bytes_f32(s, dc + dr, dv))
    if smem > _SMEM_LIMIT:
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
    wa = wb = w1p = b1p = None
    if use_mask:
        for name, t, shape in (("w1", w1, (2 * s, s)), ("b1", b1, (2 * s,)),
                               ("w2", w2, (s, 2 * s)), ("b2", b2, (s,))):
            _check(t, name, shape, torch.float32, dev)
        if bf16:
            wa, b1p, wb = _mask_weights_bf16(w1, b1, w2, s)
        else:
            wa, b1p, wb = w1.t().contiguous(), b1, w2.t().contiguous()
    out = torch.empty((b, h, s, dv), dtype=dtype, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    prep = tail = ()
    launched = ctypes.c_int(0)
    if bf16:   # the prologue's padded q, k (rotated) and v rows
        prep = (ptr(torch.empty(b * h * s * (2 * _pad16(dc + dr)
                                             + _pad16(dv)),
                                dtype=dtype, device=dev)),)
        tail = (ctypes.byref(launched),)
    name = "rope_attention_fwd_bf16" if bf16 else "rope_attention_fwd_f32"
    err = _fn("axial_attention", name, _FWD_ARGS_BF16 if bf16 else _FWD_ARGS)(
        ptr(qc), ptr(kc), ptr(qr), ptr(kr),
        ptr(v), ptr(cos_q if dr else None), ptr(sin_q if dr else None),
        ptr(cos_k if dr else None), ptr(sin_k if dr else None), ptr(wa),
        ptr(b1p), ptr(wb), ptr(b2 if use_mask else None), ptr(out), *prep,
        b, h, s, dc, dr, dv, float(scale), int(use_mask),
        torch.cuda.current_stream(dev).cuda_stream, *tail)
    # The bf16 call launches the prologue before the kernel: the kernels it
    # launched past the one counted in `.launches`.
    fused_rope_attention.stage_launches += max(launched.value - 1, 0)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error "
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


def bwd_rows_plain(g, q, k, v, w1, b1, w2, b2, *, scale: float, dtype,
                   use_mask: bool) -> dict:
    """The bf16 route's rows stage in torch ops, on rotated q, k (B,H,S,D),
    v and g (B,H,S,Dv): per row and head the softmax statistics (max, sum)
    and delta = rowsum(dp * p); with the mask ssum, a, m, dm, dh1 and dssum;
    and dq before the un-rotation (fp32). p is rebuilt from the statistics,
    as the kernels do."""
    q, k = _rounded(q, dtype), _rounded(k, dtype)
    vc, gc = _rounded(v, dtype), _rounded(g, dtype)
    scores = q @ k.transpose(-1, -2)
    x = scores * scale
    out = {}
    if use_mask:
        w1c, w2c = _rounded(w1, dtype), _rounded(w2, dtype)
        ssum = _rounded(scores.sum(dim=1), dtype)
        h1 = ssum @ w1c.T + b1.float()
        a = _rounded(F.gelu(h1), dtype)
        m = a @ w2c.T + b2.float()
        x = x + m[:, None]
        out.update(ssum=ssum, a=a, m=m)
    mx = x.amax(dim=-1, keepdim=True)
    total = torch.exp(x - mx).sum(dim=-1, keepdim=True)
    p = torch.exp(x - mx) / total
    dp = gc @ vc.transpose(-1, -2)
    delta = (dp * p).sum(dim=-1, keepdim=True)
    dl = p * (dp - delta)
    ds = dl * scale
    if use_mask:
        dm = _rounded(dl.sum(dim=1), dtype)
        dh1 = _rounded((dm @ w2c) * _dgelu(h1), dtype)
        dssum = dh1 @ w1c
        ds = ds + dssum[:, None]
        out.update(dm=dm, dh1=dh1, dssum=dssum)
    out.update(stats=torch.cat([mx, total, delta], dim=-1),
               dq=_rounded(ds, dtype) @ k)
    return out


def bwd_keys_plain(g, q, k, v, rows: dict, *, scale: float, dtype,
                   use_mask: bool) -> tuple:
    """The keys stage in torch ops: p^T from q, k, m and the rows stage's
    statistics, dl from delta, ds with dssum; returns (dk before the
    un-rotation, dv), both fp32."""
    q, k = _rounded(q, dtype), _rounded(k, dtype)
    vc, gc = _rounded(v, dtype), _rounded(g, dtype)
    x = (q @ k.transpose(-1, -2)) * scale
    if use_mask:
        x = x + rows["m"][:, None]
    mx, total, delta = rows["stats"].unbind(dim=-1)
    p = torch.exp(x - mx[..., None]) / total[..., None]
    dl = p * (gc @ vc.transpose(-1, -2) - delta[..., None])
    ds = dl * scale
    if use_mask:
        ds = ds + rows["dssum"][:, None]
    return (_rounded(ds, dtype).transpose(-1, -2) @ q,
            _rounded(p, dtype).transpose(-1, -2) @ gc)


def bwd_weight_grads_plain(rows: dict) -> tuple:
    """The weight-grad stage: dW1 = dh1^T ssum, db1, dW2 = dm^T a, db2 over
    the B*S rows (fp32 sums of the stored compute-type rows)."""
    dh1, ssum, dm, a = rows["dh1"], rows["ssum"], rows["dm"], rows["a"]
    return (torch.einsum("bqj,bqk->jk", dh1, ssum), dh1.sum(dim=(0, 1)),
            torch.einsum("bqk,bqj->kj", dm, a), dm.sum(dim=(0, 1)))


def fused_rope_attention_bwd_stages_plain(g, qc, qr, kc, kr, v, cos_q, sin_q,
                                          cos_k, sin_k, w1, b1, w2, b2, *,
                                          scale: float, dtype,
                                          use_mask: bool = True) -> tuple:
    """`fused_rope_attention_bwd_plain` composed from the plain versions of
    the bf16 route's stages (rows, keys, weight grads, un-rotation); same
    returns."""
    q = _assemble(qc, qr, cos_q, sin_q, dtype).float()
    k = _assemble(kc, kr, cos_k, sin_k, dtype).float()
    kw = dict(scale=scale, dtype=dtype, use_mask=use_mask)
    rows = bwd_rows_plain(g, q, k, v, w1, b1, w2, b2, **kw)
    dk, dv = bwd_keys_plain(g, q, k, v, rows, **kw)
    dq = rows["dq"]
    dw1 = db1 = dw2 = db2 = None
    if use_mask:
        dw1, db1, dw2, db2 = bwd_weight_grads_plain(rows)
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


WEIGHT_TILE = 64   # output tile of the weight-grad kernels


def weight_grad_splits(b: int, s: int) -> int:
    """Row splits of the weight-grad products: enough CTAs to fill the card
    twice, at least 16 rows each."""
    tiles = -(-s // WEIGHT_TILE) * -(-2 * s // WEIGHT_TILE)
    return max(1, min(-(-264 // tiles), b * s // 16, 64))


def _slice_bytes(d: int) -> int:
    """A warp's fp32 staging tile [16][pad16(D)+4] of its dq or dk."""
    return 16 * (_pad16(d) + 4) * 4


def bwd_rows_smem_bytes(s: int, d: int, dv: int,
                        use_mask: bool = True) -> int:
    """Dynamic shared memory of one bf16 backward rows CTA (RowsSmem): the K
    and V tiles (or, larger, the ssum and dm tiles [64][SP+8] and two MLP
    weight stages), then four warps' staging tiles."""
    sp = _pad16(s)
    u = sp * (_ld(d) + _ld(dv)) * 2
    if use_mask:
        u = max(u, 2 * ROWS_PER_CTA * (sp + 8) * 2 + 2 * _w_stage_bytes(s))
    return u + 4 * _slice_bytes(d)


def bwd_keys_smem_bytes(s: int, d: int, dv: int,
                        use_mask: bool = True) -> int:
    """Dynamic shared memory of one bf16 backward keys CTA (KeysSmem): q and
    g blocks [64][ld], the m and dssum blocks fp32 [64][68] (with the
    mask), the row statistics [64][4] fp32 and four warps' staging
    tiles."""
    blocks = 2 * ROWS_PER_CTA * 68 * 4 if use_mask else 0
    return (ROWS_PER_CTA * (_ld(d) + _ld(dv)) * 2 + blocks
            + ROWS_PER_CTA * 16 + 4 * _slice_bytes(d))


def card_layout(s: int, d: int, dv: int, use_mask: bool = True) -> dict:
    """The bf16 kernels' shared memory as the C launches size it (FwdSmem,
    RowsSmem, KeysSmem): {"forward": (bytes, K/V stages), "rows": bytes,
    "keys": bytes}. Builds the kernels; the Python helpers above mirror
    these for the CPU."""
    nb, stages = ctypes.c_longlong(), ctypes.c_int()
    fwd = library("axial_attention").rope_attention_fwd_bf16_layout
    fwd.restype = None
    fwd(s, d, dv, int(use_mask), ctypes.byref(nb), ctypes.byref(stages))
    rows, keys = ctypes.c_longlong(), ctypes.c_longlong()
    bwd = library("axial_attention_bwd").rope_attention_bwd_bf16_layout
    bwd.restype = None
    bwd(s, d, dv, int(use_mask), ctypes.byref(rows), ctypes.byref(keys))
    return {"forward": (nb.value, stages.value), "rows": rows.value,
            "keys": keys.value}


def bwd_smem_bytes_f32(s: int, d: int, dv: int) -> int:
    """Dynamic shared memory of one fp32 (CUDA-core) backward CTA."""
    sp = 32 * ((s + 31) // 32)
    ld = d | 1
    ldq = max(ld, dv | 1)
    return 4 * (32 * ldq + sp * ldq + 32 * sp + 32 * 2 * sp + 32 * ld)


# Slots of the backward's pointer arrays, in the order of the source's
# enums (Slot for fp32, SlotBf16 for bf16).
_BWD_SLOTS = ("qc", "kc", "qr", "kr", "v", "g", "cos_q", "sin_q", "cos_k",
              "sin_k", "w1", "w1t", "b1", "w2", "w2t", "b2", "dqc", "dqr",
              "dkc", "dkr", "dv", "tab_out", "wgrad", "tab_part", "dk_full",
              "dlog", "gprime", "ssum", "a", "dm", "dh1", "wpart")
_BWD_SLOTS_BF16 = ("qc", "kc", "qr", "kr", "v", "g", "cos_q", "sin_q",
                   "cos_k", "sin_k", "w1", "b1", "w2", "b2", "dqc", "dqr",
                   "dkc", "dkr", "dv", "tab_out", "wgrad", "tab_part",
                   "ssum", "a", "dm", "dh1", "m", "dssum", "stats", "wpart",
                   "prep")
_BWD_ARGS = ([ctypes.c_void_p] + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
_BWD_ARGS_BF16 = _BWD_ARGS + [ctypes.POINTER(ctypes.c_int)]


def _launch_bwd(g, qc, qr, kc, kr, v, cos_q, sin_q, cos_k, sin_k, w1, b1,
                w2, b2, *, scale, dtype, use_mask) -> tuple:
    """Launch the backward on the card; same returns as the plain version.
    Inputs were checked by the forward launch; g must match v."""
    bf16 = dtype == torch.bfloat16
    dev = v.device
    b, h, s, dv = v.shape
    dc = 0 if qc is None else qc.shape[-1]
    dr = 0 if qr is None else qr.shape[-1]
    d = dc + dr
    if d > 64:
        raise ValueError(f"the backward kernel takes D <= 64, got {d}")
    smem = (max(bwd_rows_smem_bytes(s, d, dv, use_mask),
                bwd_keys_smem_bytes(s, d, dv, use_mask)) if bf16
            else bwd_smem_bytes_f32(s, d, dv))
    if smem > _SMEM_LIMIT:
        raise ValueError(f"S={s}, D={d}, Dv={dv} needs more shared memory "
                         "than a CTA has")
    _check(g, "g", (b, h, s, dv), dtype, dev)

    def new(shape, dt=torch.float32):
        return torch.empty(shape, dtype=dt, device=dev)

    t = {"qc": qc, "kc": kc, "qr": qr, "kr": kr, "v": v, "g": g,
         "dv": new((b, h, s, dv))}
    if dc:
        t["dqc"] = new((b, h, s, dc), dtype)
    if dr:
        t.update(cos_q=cos_q, sin_q=sin_q, cos_k=cos_k, sin_k=sin_k,
                 dqr=new((b, h, s, dr), dtype), dkr=new((b, h, s, dr)),
                 tab_out=new((4, s, dr)), tab_part=new((b, 4, s, dr)))
    if not bf16:
        t.update(dk_full=new((b, h, s, d)), dlog=new((b, h, s, s)))
        if dr and dc:
            t["dkc"] = new((b, h, s, dc))
        elif not dr:
            t["dkc"] = t["dk_full"]
    elif dc:
        t["dkc"] = new((b, h, s, dc))
    splits = 1
    n_w = 2 * s * s
    if use_mask:
        splits = weight_grad_splits(b, s)
        total = 2 * n_w + 3 * s
        t.update(b2=b2, wgrad=new((total,)), wpart=new((splits, total)))
        sp, h2p = _pad16(s), _pad16(2 * s)
        if bf16:
            w1b, b1p, w2b = _mask_weights_bf16(w1, b1, w2, s)
            t.update(w1=w1b, b1=b1p, w2=w2b,
                     ssum=new((b * s, sp), dtype), a=new((b * s, h2p), dtype),
                     dm=new((b * s, sp), dtype), dh1=new((b * s, h2p), dtype),
                     m=new((b * s, sp)), dssum=new((b * s, sp)))
        else:
            t.update(w1=w1, w1t=w1.t().contiguous(), b1=b1, w2=w2,
                     w2t=w2.t().contiguous(), gprime=new((b, s, 2 * s)),
                     ssum=new((b, s, s), dtype), a=new((b, s, 2 * s), dtype),
                     dm=new((b, s, s), dtype), dh1=new((b, s, 2 * s), dtype))
    if bf16:
        t["stats"] = new((b, h, s, 3))
        t["prep"] = new((b * h * s * 2 * (_pad16(d) + _pad16(dv)),), dtype)
    slots = _BWD_SLOTS_BF16 if bf16 else _BWD_SLOTS
    ptrs = (ctypes.c_void_p * len(slots))(
        *(None if t.get(name) is None else t[name].data_ptr()
          for name in slots))
    name = "rope_attention_bwd_bf16" if bf16 else "rope_attention_bwd_f32"
    launched = ctypes.c_int(0)
    err = _fn("axial_attention_bwd", name,
              _BWD_ARGS_BF16 if bf16 else _BWD_ARGS)(
        ptrs, b, h, s, dc, dr, dv, float(scale), int(use_mask), splits,
        torch.cuda.current_stream(dev).cuda_stream,
        *((ctypes.byref(launched),) if bf16 else ()))
    # The bf16 call's kernels past the one counted in `.launches`.
    fused_rope_attention_bwd.stage_launches += max(launched.value - 1, 0)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error "
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
# The bf16 route's further launches per call, as the C entry reports them:
# the prologue, the keys kernel, the table and weight-grad reductions.
fused_rope_attention_bwd.stage_launches = 0


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
# The bf16 route's further launches per call, as the C entry reports them
# (its prologue).
fused_rope_attention.stage_launches = 0
