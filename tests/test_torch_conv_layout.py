"""The conv residual kernels' launch geometry and their backward's stages,
on the CPU, for both compute types (one design each, instantiated for
bf16 and fp32).

* At every conv S of every config in `utils/configs.py`, the forward's and
  the backward's CTAs fit the H100's shared memory (232,448 bytes a CTA)
  with the CTAs an SM that the sources' notes claim for each compute type,
  and the grids cover the image; the helpers that size them
  (`kernels/conv_residual.py`) state what the sources' notes and constants
  state. On the card, tests/test_torch_gpu.py and chip_smoke.py hold the
  helpers to the C launches.
* The backward's staged plain version (dx and one partial row a CTA of
  the kernels' grid: the rows the weight-grad buffer needs; then
  `conv_weight_grad_sum_plain`) gives `conv_residual_bwd_plain`'s dx and
  packed weight grads: rtol 1e-5 /
  atol 1e-6 of each column's largest value in fp32 (the sums are taken
  in another order), and within one bf16 ulp (2**-8) of it in bf16.
"""

import math
import pathlib
import re

import numpy as np
import pytest
import torch

from calm_vit_dte_tpu_torch.kernels import conv_residual as kc
from calm_vit_dte_tpu_torch.tools import time_conv as tconv
from calm_vit_dte_tpu_torch.utils.configs import CONFIGS

torch.set_num_threads(1)

CSRC = pathlib.Path(kc.__file__).resolve().parent.parent / "csrc"
LIMIT = 232448   # shared memory a CTA can use on the H100


def _conv_sizes(cfg) -> set[int]:
    return {b.seq_len_new for _, b in cfg.model.backbone_cfg().block_configs()}


def test_published_conv_sizes_are_known():
    sizes = {name: _conv_sizes(cfg) for name, cfg in CONFIGS.items()}
    assert sizes["imagenet-cls-224"] == {224, 176, 128, 80}
    assert sizes["imagenet-cls-256"] == {256, 208, 160, 112}
    assert sizes["hires-cls-1024"] == {1024, 832, 640, 448}


DTYPES = {torch.bfloat16: "bf16", torch.float32: "fp32"}


# bf16 cases keep their ids (the config's name); fp32 ones add "-float32".
@pytest.mark.parametrize("name,dtype", [
    pytest.param(name, dtype, id=name if dtype == torch.bfloat16
                 else f"{name}-float32")
    for dtype in DTYPES for name in sorted(CONFIGS)])
def test_every_conv_size_fits(name, dtype):
    for s in sorted(_conv_sizes(CONFIGS[name])):
        for what, smem in (("forward", kc.fwd_smem(dtype)),
                           ("forward with residuals",
                            kc.fwd_smem(dtype, save=True)),
                           ("backward", kc.bwd_smem())):
            assert 0 < smem <= LIMIT
            ctas = kc.MIN_CTAS[dtype][what]
            assert ctas >= 2, (what, dtype)
            assert kc.ctas_per_sm(smem, ctas) == ctas, (name, s, what)
        for tile, grid in ((kc.FWD_TILE, kc.fwd_grid(3, s, dtype)),
                           (kc.fwd_tile(dtype, True),
                            kc.fwd_grid(3, s, dtype, True)),
                           (kc.BWD_TILE, kc.bwd_grid(3, s))):
            rows, cols = tile
            gx, gy, gz = grid
            assert (gx - 1) * cols < s <= gx * cols, (name, s, tile)
            assert (gy - 1) * rows < s <= gy * rows, (name, s, tile)
            assert gz == 3
            assert kc.THREADS == 256
        # The forward's 16-column tiles leave no column idle at a
        # published width that is a multiple of 16.
        if name != "tiny-cls" and name != "tiny-reg":
            assert s % kc.FWD_TILE[1] == 0, (name, s)


def _constants(text: str, namespace: str) -> dict:
    block = text[text.index(f"namespace {namespace} {{"):]
    block = block[:block.index(f"}}  // namespace {namespace}")]
    return {k: int(v) for k, v in re.findall(r"\b(k\w+) = (\d+)\b", block)}


@pytest.mark.parametrize(
    "source,namespace,dtype,what,const,rows,tile,smem", [
        ("conv_residual.cu", "fwd", torch.bfloat16, "forward",
         "kMinCtasBf16", "kR", kc.FWD_TILE, kc.fwd_smem),
        ("conv_residual.cu", "fwd", torch.bfloat16, "forward with residuals",
         "kMinCtasSaveBf16", "kR", kc.fwd_tile(torch.bfloat16, True),
         lambda dt: kc.fwd_smem(dt, True)),
        ("conv_residual.cu", "fwd", torch.float32, "forward", "kMinCtasF32",
         "kR", kc.fwd_tile(torch.float32), kc.fwd_smem),
        ("conv_residual.cu", "fwd", torch.float32, "forward with residuals",
         "kMinCtasSaveF32", "kRSaveF32", kc.fwd_tile(torch.float32, True),
         lambda dt: kc.fwd_smem(dt, True)),
        ("conv_residual_bwd.cu", "bwd", torch.bfloat16, "backward",
         "kMinCtasBf16", "kR", kc.BWD_TILE, lambda dt: kc.bwd_smem()),
        ("conv_residual_bwd.cu", "bwd", torch.float32, "backward",
         "kMinCtasF32", "kR", kc.BWD_TILE, lambda dt: kc.bwd_smem()),
    ], ids=["forward-bf16", "forward_with_residuals-bf16", "forward-fp32",
            "forward_with_residuals-fp32", "backward-bf16", "backward-fp32"])
def test_helpers_agree_with_the_source_notes(source, namespace, dtype, what,
                                             const, rows, tile, smem):
    text = (CSRC / source).read_text()
    consts = _constants(text, namespace)
    assert (consts[rows], consts["kC"]) == tile
    stated = re.findall(
        rf"//\s+{DTYPES[dtype]} {what}: (\d+) bytes, (\d+) CTAs per SM", text)
    assert len(stated) == 1, stated
    nbytes, ctas = (int(v) for v in stated[0])
    assert nbytes == smem(dtype)
    assert ctas == consts[const] == kc.MIN_CTAS[dtype][what]
    assert ctas == kc.ctas_per_sm(nbytes, ctas)
    # Every instantiation's launch bound asks for its type's constant.
    bounds = re.findall(
        rf"__launch_bounds__\({namespace}::kThreads,\s*([^)]*\))\)", text)
    assert len(bounds) == 1 and f"{namespace}::min_ctas(" in bounds[0], bounds
    block = text[text.index(f"namespace {namespace} {{"):]
    rule = block[block.index("constexpr int min_ctas("):]
    assert const in rule[:rule.index("}")], const
    common = (CSRC / "conv_residual_common.cuh").read_text()
    bound = re.search(r"kErfBf16MaxErr = ([0-9.e-]+)f;", common).group(1)
    assert float(bound) == kc.ERF_BF16_MAX_ERR


def _inputs(rng, b, s, dtype):
    def n(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32))

    return (n(b, s, s, 3).to(dtype), n(b, s, s, 3, scale=0.5).to(dtype),
            n(32, 3, scale=0.3), n(32, scale=0.1), n(3, 3, 32, scale=0.3),
            n(32, scale=0.1), n(3, 32, scale=0.2))


@pytest.mark.parametrize("s", [8, 13, 20, 36])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_stages_compose_to_the_plain_backward(s, dtype):
    x, g, *w = _inputs(np.random.default_rng(s), 2, s, dtype)
    dx, rows = kc.conv_residual_bwd_partials_plain(x, g, *w, dtype=dtype)
    assert rows.shape == (math.prod(kc.bwd_grid(2, s)), 32 * 17)
    assert rows.dtype == torch.float32
    want_dx, want_wg = kc.conv_residual_bwd_plain(x, g, *w, dtype=dtype)
    assert torch.equal(dx, want_dx)
    got = kc.conv_weight_grad_sum_plain(rows)
    frac = 1e-6 if dtype == torch.float32 else 2.0 ** -8
    for j in range(kc.WG_COLS):
        top = float(want_wg[:, j].abs().max())
        torch.testing.assert_close(got[:, j], want_wg[:, j],
                                   rtol=1e-5 if frac < 1e-3 else 0.0,
                                   atol=frac * top, msg=f"wg[:, {j}]")
    # Rows go in the grid's order, image slowest: each image's rows add up
    # to that image's weight grads.
    per_image = rows.view(2, -1, 32 * 17).sum(1)
    for i in range(2):
        _, wg_i = kc.conv_residual_bwd_plain(x[i:i + 1], g[i:i + 1], *w,
                                             dtype=dtype)
        torch.testing.assert_close(
            per_image[i].view(32, 17), wg_i[:, :17], rtol=1e-4,
            atol=1e-5 * float(wg_i.abs().max()), msg=f"image {i}")


@pytest.mark.parametrize("kind", ["fwd", "fwd_resid", "bwd"])
def test_fp32_floor_counts_the_exact_gelu(kind):
    """The fp32 CUDA-core floor counts the exact GELU's recorded lane-ops
    (tools/time_conv.py), more than the bf16 GELU's, and scales with them
    at equal work."""
    assert tconv.LANE_OPS_F32 == tconv.lane_ops(tconv.GELU_OPS_F32,
                                                tconv.DGELU_OPS_F32)
    assert tconv.LANE_OPS_F32[kind] > tconv.LANE_OPS[kind]
    ratio = (tconv.floor_ms(kind, 8, 224, 132, 1.98e9, torch.float32)
             / tconv.floor_ms(kind, 8, 224, 132, 1.98e9))
    assert ratio == pytest.approx(tconv.LANE_OPS_F32[kind]
                                  / tconv.LANE_OPS[kind], rel=1e-12)
