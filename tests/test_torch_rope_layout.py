"""The rope attention kernels' launch geometry, their refusals and their
backward's stages, on the CPU.

* Every rope-route attention shape of every config in `utils/configs.py`
  fits the bf16 forward, rows and keys CTAs' shared memory (232,448
  bytes), and the fp32 route's CTAs (the hires CUDA-core kernels it runs,
  `f32_smem_bytes`); the bf16 forward takes a second K/V stage only where
  two CTAs still share an SM; and the sizes (and stages) the Python helpers
  compute are the ones the kernel sources' notes state. On the card,
  tests/test_torch_gpu.py and chip_smoke.py hold the helpers to the sizes
  the C launches use.
* `refusal` on a table of shapes at and past each limit, fp32 and bf16.
* The backward's stages composed from their plain versions give
  `fused_rope_attention_bwd_plain`'s 13 gradients: the bf16 route's (rows,
  keys, weight grads, un-rotation) in fp32 and bf16, and the fp32 route's
  (rotation, the hires forward with residuals, delta, the hires dq and
  dk/dv passes, un-rotation) in fp32; rtol 1e-5 / atol 1e-6 of each
  gradient's largest value in fp32 (the stages rebuild p from the row
  statistics or from lse: a few ulps), and in bf16 within one bf16 ulp
  (2**-8) of the largest value, since a rounding point may fall on the
  other side.
* tools/time_rope.py's bounds are chip_smoke.py's, at one fp32 and one bf16
  shape, and its parts' dk/dv bound is tools/time_hires.py's.
* The hires CUDA-core dk/dv kernel's shared memory (`dkv_smem` at the NV
  `dkv_split` gives) is the size its source's note states, at every rope
  and hires attention shape of every config, and fits a CTA.
"""

import dataclasses
import importlib.util
import math
import pathlib
import re

import numpy as np
import pytest
import torch

from calm_vit_dte_tpu_torch.kernels import axial_attention as ka
from calm_vit_dte_tpu_torch.ops.attention import pick_route
from calm_vit_dte_tpu_torch.ops.rope import rope_tables
from calm_vit_dte_tpu_torch.tools import time_hires, time_rope
from calm_vit_dte_tpu_torch.utils.configs import CONFIGS

torch.set_num_threads(1)

CSRC = pathlib.Path(ka.__file__).resolve().parent.parent / "csrc"
LIMIT = 232448


def _rope_shapes():
    """{(S, Dc, Dr, Dv)} of every config's attention calls on the rope
    route."""
    shapes = set()
    for cfg in CONFIGS.values():
        for _, bcfg in cfg.model.backbone_cfg().block_configs():
            for v in (bcfg.encoder_cfg(), bcfg.decoder_cfg(),
                      bcfg.cross_cfg()):
                dc = v.head_dim_content if v.reduce else 0
                dr = v.head_dim_rope if v.reduce else v.head_dim
                s = v.seq_len_new
                if pick_route(1, v.heads, s, s, dc + dr, v.head_dim,
                              torch.bfloat16, dr=dr)[0] == "rope":
                    shapes.add((v.seq_len_new, dc, dr, v.head_dim))
    return sorted(shapes)


def test_every_rope_shape_fits_a_cta():
    shapes = _rope_shapes()
    assert (224, 28, 28, 56) in shapes and (256, 32, 32, 64) in shapes
    for s, dc, dr, dv in shapes:
        d = dc + dr
        for mask in (True, False):
            sizes = (ka.smem_bytes(s, d, dv, mask),
                     ka.bwd_rows_smem_bytes(s, d, dv, mask),
                     ka.bwd_keys_smem_bytes(s, d, dv, mask))
            assert all(0 < n <= LIMIT for n in sizes), (s, d, dv, sizes)
            assert all(ka.ctas_per_sm(n) >= 1 for n in sizes)
        for mask in (True, False):
            stages = ka.fwd_kv_stages(s, d, dv, mask)
            assert stages in (1, 2)
            assert ka.ctas_per_sm(ka.smem_bytes(s, d, dv, mask)) >= 2
            if mask:   # the second stage goes only where it keeps 2 CTAs
                assert (stages == 2) == (s <= 208), (s, d, dv)
        assert ka.grid(s, 128) == (math.ceil(s / 64), 128)
        f32 = ka.f32_smem_bytes(s, d, dv)
        assert set(f32) == {"forward", "backward"}
        assert all(0 < n <= LIMIT and ka.ctas_per_sm(n) >= 1
                   for n in f32.values()), (s, d, dv, f32)


def _stated(source: str) -> dict:
    """The source note's table: (S, D, Dv) -> {what: (bytes, CTAs per SM,
    K/V stages or None)}."""
    text = (CSRC / source).read_text()
    out: dict = {}
    for m in re.finditer(r"//\s+(\w+) at \(S, D, Dv\) = \((\d+), (\d+), "
                         r"(\d+)\): (\d+) bytes, (\d+) CTAs? per SM"
                         r"(?:, (\d) K/V stages?)?", text):
        key = tuple(int(x) for x in m.group(2, 3, 4))
        stages = None if m.group(7) is None else int(m.group(7))
        out.setdefault(key, {})[m.group(1)] = (int(m.group(5)),
                                               int(m.group(6)), stages)
    return out


def _f32(what):
    """The fp32 route's helper for one call, in the bf16 helpers' form."""
    return lambda s, d, dv, mask: ka.f32_smem_bytes(s, d, dv)[what]


@pytest.mark.parametrize("source,helpers", [
    ("axial_attention.cu", {"forward": ka.smem_bytes,
                            "f32_forward": _f32("forward")}),
    ("axial_attention_bwd.cu", {"rows": ka.bwd_rows_smem_bytes,
                                "keys": ka.bwd_keys_smem_bytes,
                                "f32_backward": _f32("backward")}),
])
def test_helpers_agree_with_the_source_notes(source, helpers):
    stated = _stated(source)
    assert {(224, 56, 56), (256, 64, 64)} <= set(stated)
    for (s, d, dv), rows in stated.items():
        assert set(rows) == set(helpers)
        for what, (nbytes, ctas, stages) in rows.items():
            got = helpers[what](s, d, dv, True)
            assert got == nbytes, (source, what, s)
            assert ka.ctas_per_sm(got) == ctas, (source, what, s)
            if what == "forward":
                assert stages == ka.fwd_kv_stages(s, d, dv), s


def test_f32_stage_launches_agree_with_the_source_notes():
    """The fp32 route's launches a backward call (the forward's entry and
    the backward's) as csrc/axial_attention_bwd.cu states them, against
    `f32_stage_launches` (which counts those past the counted one)."""
    text = (CSRC / "axial_attention_bwd.cu").read_text()
    m = re.search(r"Launches a call: (\d+) with the mask,\s*//\s*(\d+) "
                  r"without", text)
    assert m, "the fp32 route's launch note"
    assert ka.f32_stage_launches(True)["backward"] + 1 == int(m.group(1))
    assert ka.f32_stage_launches(False)["backward"] + 1 == int(m.group(2))


def _inputs(rng, b, s, dc, dr, dtype):
    d = dc + dr

    def n(*shape, scale=0.3, dt=dtype):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)).to(dt)

    tables = [None] * 4
    if dr:
        inv = 1.0 / (10000.0 ** (torch.arange(0, dr, 2).float() / dr))
        tables = [*rope_tables(inv, s), *rope_tables(inv * 1.1, s)]
    f32 = torch.float32
    args = [n(b, 3, s, dc) if dc else None, n(b, 3, s, dr) if dr else None,
            n(b, 3, s, dc) if dc else None, n(b, 3, s, dr) if dr else None,
            n(b, 3, s, d), *tables, n(2 * s, s, scale=0.05, dt=f32),
            n(2 * s, scale=0.05, dt=f32), n(s, 2 * s, scale=0.05, dt=f32),
            n(s, scale=0.05, dt=f32)]
    return args, n(b, 3, s, d)


@pytest.mark.parametrize("s,dc,dr", [(24, 4, 4), (20, 0, 8), (16, 6, 0)])
@pytest.mark.parametrize("use_mask", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_stages_compose_to_the_plain_backward(s, dc, dr, use_mask,
                                                       dtype):
    rng = np.random.default_rng(s + dc + 10 * use_mask)
    args, g = _inputs(rng, 2, s, dc, dr, dtype)
    kw = dict(scale=1.0 / math.sqrt(dc + dr), dtype=dtype,
              use_mask=use_mask)
    got = ka.fused_rope_attention_bwd_stages_plain(g, *args, **kw)
    want = ka.fused_rope_attention_bwd_plain(g, *args, **kw)
    names = ("dqc", "dqr", "dkc", "dkr", "dv", "dcos_q", "dsin_q", "dcos_k",
             "dsin_k", "dw1", "db1", "dw2", "db2")
    frac = 1e-6 if dtype == torch.float32 else 2.0 ** -8
    for name, x, y in zip(names, got, want):
        assert (x is None) == (y is None), name
        if x is None:
            continue
        assert x.dtype == y.dtype and x.shape == y.shape, name
        top = float(y.float().abs().max())
        torch.testing.assert_close(x.float(), y.float(),
                                   rtol=1e-5 if frac < 1e-3 else 0.0,
                                   atol=frac * top, msg=name)


# (S, Dc, Dr, Dv, dtype) -> what `refusal` says: None (taken) or a
# fragment of its message; at and past each limit.
_F32, _BF16 = torch.float32, torch.bfloat16
REFUSALS = [
    ((256, 32, 32, 64, _F32), None), ((256, 32, 32, 64, _BF16), None),
    ((257, 32, 32, 64, _F32), "unsupported shape"),
    ((257, 32, 32, 64, _BF16), "unsupported shape"),
    ((224, 32, 32, 64, _F32), None), ((224, 34, 32, 64, _F32),
                                      "takes D <= 64"),
    ((224, 34, 32, 64, _BF16), "bf16 kernel takes D <= 64"),
    ((224, 28, 28, 72, _F32), "unsupported shape"),
    ((224, 28, 28, 72, _BF16), "unsupported shape"),
    ((80, 9, 10, 19, _F32), None), ((80, 9, 10, 19, _BF16), "even Dc"),
    ((80, 10, 10, 19, _BF16), "even Dc"), ((80, 10, 9, 20, _F32), "even"),
    ((80, 20, 0, 20, _F32), None), ((80, 20, 0, 20, _BF16), None),
    ((80, 0, 0, 20, _F32), "unsupported shape"),
    ((1, 0, 2, 1, _F32), None), ((1, 0, 2, 1, _BF16), "even Dc"),
    ((224, 28, 28, 56, torch.float16), "dtype"),
    # fp32 past D 64 and past the first design's shared memory: the same
    # refusal, now with the D limit's message (no shared-memory limit binds
    # the fp32 route's kernels inside D <= 64)
    ((256, 60, 60, 64, _F32), "takes D <= 64"),
]


@pytest.mark.parametrize("shape,want", REFUSALS)
@pytest.mark.parametrize("use_mask", [True, False])
def test_refusal_at_each_limit(shape, want, use_mask):
    s, dc, dr, dv, dtype = shape
    got = ka.refusal(s, dc, dr, dv, dtype, use_mask)
    if want is None:
        assert got is None, (shape, got)
    else:
        assert got is not None and want in got, (shape, got)


@pytest.mark.parametrize("s,dc,dr,dv", [(24, 4, 4, 8), (20, 0, 8, 8),
                                        (16, 6, 0, 6), (12, 3, 4, 5)])
@pytest.mark.parametrize("use_mask", [True, False])
def test_f32_backward_stages_compose_to_the_plain_backward(s, dc, dr, dv,
                                                           use_mask):
    rng = np.random.default_rng(s + dc + 10 * use_mask)
    args, _ = _inputs(rng, 2, s, dc, dr, torch.float32)
    args[4] = torch.from_numpy(
        (rng.standard_normal((2, 3, s, dv)) * 0.3).astype(np.float32))
    g = torch.from_numpy(
        (rng.standard_normal((2, 3, s, dv)) * 0.3).astype(np.float32))
    kw = dict(scale=1.0 / math.sqrt(dc + dr), use_mask=use_mask)
    got = ka.fused_rope_attention_bwd_f32_stages_plain(g, *args, **kw)
    want = ka.fused_rope_attention_bwd_plain(g, *args, dtype=torch.float32,
                                             **kw)
    names = ("dqc", "dqr", "dkc", "dkr", "dv", "dcos_q", "dsin_q", "dcos_k",
             "dsin_k", "dw1", "db1", "dw2", "db2")
    for name, x, y in zip(names, got, want):
        assert (x is None) == (y is None), name
        if x is None:
            continue
        assert x.dtype == y.dtype and x.shape == y.shape, name
        top = float(y.abs().max())
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6 * top,
                                   msg=name)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parent.parent
        / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("dtype,shape", [(torch.float32, (224, 28, 28, 56)),
                                         (torch.bfloat16, (176, 22, 22, 44))])
def test_time_rope_bounds_are_chip_smokes(dtype, shape):
    smoke = _chip_smoke()
    s, dc, dr, dv = shape
    b = 8
    item, peak = ((4, smoke.PEAK_FP32_FLOPS) if dtype == torch.float32
                  else (2, smoke.PEAK_BF16_FLOPS))
    fwd, bwd = time_rope.bounds_ms(b, smoke.H, s, dc, dr, dv, dtype)
    assert fwd == pytest.approx(max(smoke.attn_bound(b, s, dc, dr, dv, item,
                                                     peak)), rel=1e-12)
    assert bwd == pytest.approx(max(smoke.attn_bwd_bound(b, s, dc, dr, dv,
                                                         item, peak)),
                                rel=1e-12)


def test_time_rope_parts_name_every_f32_route_kernel():
    """Every kernel of the fp32 route's own source and every hires CUDA-core
    kernel it launches falls in a family of `time_rope.PARTS`."""
    own = re.findall(r"__global__ void __launch_bounds__\(\d+\) (\w+)\(",
                     (CSRC / "rope_f32.cuh").read_text())
    assert len(own) == 3
    names = own + ["gemm_kernel", "hires_attention_kernel",
                   "hires_dm_ssum_kernel", "hires_dq_kernel",
                   "hires_dkv_kernel", "colsum_kernel", "sum_splits_kernel",
                   "sum_partials_kernel"]
    for name in names:
        hits = [p for p, needles in time_rope.PARTS.items()
                if any(n in name for n in needles)]
        assert len(hits) == 1, (name, hits)


def test_time_rope_parts_dkv_bound_is_time_hires():
    """`time_rope.part_bounds_ms`' dk/dv bound is `time_hires.bound_ms`'s
    dk/dv pass at the same shape (D = Dc + Dr), fp32."""
    b, h, s, dc, dr, dv = 8, 12, 224, 28, 28, 56
    got = time_rope.part_bounds_ms(b, h, s, dc, dr, dv, torch.float32)
    want = time_hires.bound_ms(b, h, s, dc + dr, dv, torch.float32)["dkv"]
    assert got["dk/dv"] == pytest.approx(want, rel=1e-12)
    assert set(got) <= set(time_rope.PARTS)


def _dkv_stated() -> dict:
    """The dk/dv CTA's note in csrc/hires_attention_bwd.cu: NV -> (bytes,
    CTAs per SM)."""
    text = (CSRC / "hires_attention_bwd.cu").read_text()
    return {int(m.group(1)): (int(m.group(2)), int(m.group(3)))
            for m in re.finditer(r"//\s+dkv_cc_smem at NV = (\d): (\d+) "
                                 r"bytes, (\d+) CTAs? per SM", text)}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_dkv_smem_agrees_with_the_source_note(name):
    """At every attention shape of the config, as the rope route's fp32
    backward (D padded to pad4(Dc + Dr)) and the hires kernels (D = Dc +
    Dr; hires-cls-1024 also at heads=6) call the CUDA-core dk/dv kernel:
    its CTA's shared memory at the slice's NV (4 for 3 on the register
    path) is the source note's, fits 232,448 bytes and leaves the CTAs
    per SM the note states."""
    stated = _dkv_stated()
    assert sorted(stated) == [1, 2, 3, 4]
    mcfg = CONFIGS[name].model
    models = [mcfg] + ([dataclasses.replace(mcfg, heads=6)]
                       if name == "hires-cls-1024" else [])
    shapes = {(ka._pad4(dc + dr), dv)
              for s, dc, dr, dv in time_rope.attention_shapes(mcfg)}
    for m in models:
        shapes |= {(d, dv) for _, d, dv in time_hires.kernel_shapes(m)}
    assert shapes
    for d, dv in sorted(shapes):
        ns, cols, nv = ka.dkv_split(d, dv)
        assert ns == -(-max(d, dv) // 256) and cols <= 256 and cols % 4 == 0
        assert ns * cols >= max(d, dv) > (ns - 1) * cols
        for n in {nv, 4 if nv == 3 else nv}:
            nbytes, ctas = stated[n]
            assert ka.dkv_smem(n) == nbytes, (d, dv, n)
            assert 0 < nbytes <= LIMIT and ka.ctas_per_sm(nbytes) == ctas
