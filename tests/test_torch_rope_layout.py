"""The bf16 rope attention kernels' launch geometry and their backward's
stages, on the CPU.

* Every rope-route attention shape of every config in `utils/configs.py`
  fits the forward, rows and keys CTAs' shared memory (232,448 bytes); the
  forward takes a second K/V stage only where two CTAs still share an SM;
  and the sizes (and stages) the Python helpers compute are the ones the
  kernel sources' notes state. On the card, tests/test_torch_gpu.py and
  chip_smoke.py hold the helpers to the sizes the C launches use.
* The backward's stages (rows, keys, weight grads, un-rotation), composed
  from their plain versions, give `fused_rope_attention_bwd_plain`'s 13
  gradients: rtol 1e-5 / atol 1e-6 of each gradient's largest value in
  fp32 (the stages rebuild p from the row statistics: a few ulps), and in
  bf16 within one bf16 ulp (2**-8) of the largest value, since a rounding
  point may fall on the other side.
"""

import math
import pathlib
import re

import numpy as np
import pytest
import torch

from calm_vit_dte_tpu_torch.kernels import axial_attention as ka
from calm_vit_dte_tpu_torch.ops.attention import pick_route
from calm_vit_dte_tpu_torch.ops.rope import rope_tables
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
                if pick_route(v.seq_len_new, dc + dr, v.head_dim) == "rope":
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
        assert ka.smem_bytes_f32(s, d, dv) <= LIMIT
        assert ka.bwd_smem_bytes_f32(s, d, dv) <= LIMIT


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


@pytest.mark.parametrize("source,helpers", [
    ("axial_attention.cu", {"forward": ka.smem_bytes}),
    ("axial_attention_bwd.cu", {"rows": ka.bwd_rows_smem_bytes,
                                "keys": ka.bwd_keys_smem_bytes}),
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
