"""The port's long-sequence attention route (kernels/hires_attention.py,
`attention_impl("hires")`) against the JAX package on the CPU, and the
port's config registry against the JAX one.

On the CPU the wrappers run their plain versions; they are held here against
the JAX package's `fused_hires_attention` and `fused_attention_forward` with
their Pallas kernels in interpret mode (at the limits of
tests/test_kernels.py:323-356), and the whole layer and model under the
forced hires route against the JAX layer and model on carried weights.
tests/test_torch_gpu.py holds the CUDA kernels against the plain versions on
the card.
"""

import dataclasses
import importlib.util
import math
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _sn_warmup import converged_sn_state
from calm_vit_dte_tpu.kernels.axial_attention import (
    fused_attention_forward as jax_fused_attention_forward,
)
from calm_vit_dte_tpu.kernels.axial_attention import (
    fused_hires_attention as jax_fused_hires_attention,
)
from calm_vit_dte_tpu.models.vit import vit_init
from calm_vit_dte_tpu.models.vmla import VMLAConfig as JVMLAConfig
from calm_vit_dte_tpu.models.vmla import vmla_apply, vmla_init
from calm_vit_dte_tpu.nn.spectral_norm import (
    normalize_tree as jax_normalize_tree,
)
from calm_vit_dte_tpu.ops.latent_state import LatentState as JLatentState
from calm_vit_dte_tpu.utils import configs as jax_configs
from calm_vit_dte_tpu_torch.compat import from_jax
from calm_vit_dte_tpu_torch.kernels import hires_attention as kh
from calm_vit_dte_tpu_torch.models.vit import ViT
from calm_vit_dte_tpu_torch.models.vmla import VMLA, VMLAConfig
from calm_vit_dte_tpu_torch.ops.attention import attention_impl, pick_route
from calm_vit_dte_tpu_torch.ops.latent_state import LatentState
from calm_vit_dte_tpu_torch.ops.variational import noise_override
from calm_vit_dte_tpu_torch.train.optim import FusedAdamW
from calm_vit_dte_tpu_torch.train.state import TrainState
from calm_vit_dte_tpu_torch.train.step import make_train_step
from calm_vit_dte_tpu_torch.utils import configs

# One intra-op thread: the suite runs several worker processes per machine,
# and a torch thread pool per worker oversubscribes the cores.
torch.set_num_threads(1)

F32 = torch.float32
NAMES = "q k v w1 b1 w2 b2".split()


def _inputs(b=2, h=3, s=64, d=16, seed=3):
    """The JAX kernel tests' input distribution, drawn with numpy."""
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return [n(b, h, s, d), n(b, h, s, d), n(b, h, s, d),
            n(2 * s, s, scale=1 / math.sqrt(s)), n(2 * s, scale=0.1),
            n(s, 2 * s, scale=1 / math.sqrt(2 * s)), n(s, scale=0.1)]


def test_hires_function_matches_pallas():
    """The forward with residuals and both backward passes (plain versions,
    through the autograd Function) against the Pallas hires kernels in
    interpret mode: the output and all seven gradients."""
    args = _inputs()
    scale = 1.0 / math.sqrt(args[0].shape[-1])

    def loss_jax(*a):
        out = jax_fused_hires_attention(*a, scale=scale, dtype=jnp.float32,
                                        interpret=True)
        return jnp.sum(out * jnp.cos(out.shape[-1] + out)), out

    (_, want_out), want = jax.value_and_grad(
        loss_jax, argnums=tuple(range(7)), has_aux=True)(
        *map(jnp.asarray, args))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    out = kh.fused_hires_attention(*leaves, scale=scale, dtype=F32)
    (out * torch.cos(out.shape[-1] + out)).sum().backward()
    assert kh.fused_hires_attention.launches == 0   # CPU: plain versions
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               rtol=1e-5, atol=1e-5)
    for name, leaf, w in zip(NAMES, leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   rtol=5e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("use_mask", [True, False])
def test_forward_only_matches_pallas(use_mask):
    """The forward-only kernel's plain version against `_make_fwd_only` in
    interpret mode."""
    args = _inputs(s=48, seed=4)
    scale = 0.25
    want = jax_fused_attention_forward(
        *map(jnp.asarray, args), scale=scale, dtype=jnp.float32,
        use_mask=use_mask, interpret=True)
    got = kh.fused_attention_forward(*map(torch.from_numpy, args),
                                     scale=scale, dtype=F32,
                                     use_mask=use_mask)
    assert kh.fused_attention_forward.launches == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_weight_grad_reduction_matches_the_dq_pass():
    """`hires_weight_grads` (the reduction the dq pass launches on the card)
    from the pass's per-row factors gives the dq pass's weight grads."""
    q, k, v, w1, b1, w2, b2 = map(torch.from_numpy, _inputs(s=32, seed=5))
    g = torch.from_numpy(_inputs(s=32, seed=6)[0])
    scale = 0.25
    o, m, lse = kh.hires_fwd_res(q, k, v, w1, b1, w2, b2, scale=scale,
                                 dtype=F32)
    delta = (g * o).sum(-1)
    want = kh.hires_dq(q, k, v, g, m, lse, delta, w1, b1, w2, scale=scale,
                       dtype=F32)[2:]
    scores = q @ k.transpose(-1, -2)
    ssum = scores.sum(1)
    p = torch.exp(scores * scale + m[:, None] - lse[..., None])
    dm = (p * (g @ v.transpose(-1, -2) - delta[..., None])).sum(1)
    h1 = ssum @ w1.T + b1
    a = torch.nn.functional.gelu(h1)
    dh1 = (dm @ w2) * kh._dgelu(h1)
    got = kh.hires_weight_grads(ssum, dm, a, dh1)
    assert kh.hires_weight_grads.launches == 0
    for name, x, y in zip(("dw1", "db1", "dw2", "db2"), got, want):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6, msg=name)


def test_wrappers_raise_off_cpu_and_cuda():
    """No route runs a plain version on a device other than the CPU."""
    meta = [torch.from_numpy(a).to("meta") for a in _inputs(s=16, d=8)]
    with pytest.raises(ValueError, match="no kernel for device"):
        kh.fused_attention_forward(*meta, scale=0.25, dtype=F32)
    with pytest.raises(ValueError, match="no kernel for device"):
        kh.fused_hires_attention(*meta, scale=0.25, dtype=F32)
    with pytest.raises(ValueError, match="attention route"):
        with attention_impl("plain"):
            pass


CSRC = pathlib.Path(kh.__file__).resolve().parent.parent / "csrc"


_FAMILY = (r"struct Family \{ bool aligned, tc_fwd, tc_dq, tc_dkv; \}; "
           r"inline Family family_of\(int is_bf16, int S, int D, int Dv\) "
           r"\{ const bool aligned = is_bf16 && !\(S % (\d+) \|\| D % (\d+) "
           r"\|\| Dv % (\d+)\); return \{aligned, ([^,]+), ([^,]+), "
           r"([^,]+)\}; \}")
_LIMIT = r"aligned(?: && D <= (\w+))?(?: && Dv <= (\w+))?"


def _c_constants(text):
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (k\w+) = (\d+);", text)}


@pytest.mark.parametrize("source", ["hires_attention.cu",
                                    "hires_attention_bwd.cu"])
def test_bf16_shape_rule_matches_the_source(source):
    """The wrapper's BF16_MULTIPLE and TC_MAX_D are the multiple of S, D
    and Dv and, pass by pass, the widest D and Dv at which the C entries'
    bf16 calls run each attention pass on the tensor cores (`family_of` in
    csrc/hires_common.cuh, which each entry asks, and whose tc_fwd, tc_dq
    and tc_dkv pick the forward's, the dq pass's and the dk/dv pass's
    kernels); TC_SLICE is the width past which the forward and dk/dv
    passes take their wide kernels; the forward's limit is the widest D
    whose CTA fits in 232,448 bytes; `tensor_cores` states the rule."""
    text = (CSRC / source).read_text()
    assert "family_of(is_bf16, S, D, Dv)" in text
    flat = " ".join(text.split())
    common = " ".join((CSRC / "hires_common.cuh").read_text().split())
    rules = re.findall(_FAMILY, common)
    assert len(rules) == 1
    assert {int(x) for x in rules[0][:3]} == {kh.BF16_MULTIPLE}
    consts = _c_constants(common)
    got = {}
    for name, expr in zip(("fwd", "dq", "dkv"), rules[0][3:]):
        limit = re.fullmatch(_LIMIT, expr.strip())
        assert limit, expr
        got[name] = tuple(None if c is None else consts[c]
                          for c in limit.groups())
    assert got == kh.TC_MAX_D
    assert consts["kSlice"] == kh.TC_SLICE
    passes = {"hires_attention.cu": ["tc_fwd"],
              "hires_attention_bwd.cu": ["tc_dkv", "tc_dq"]}[source]
    assert sorted(set(re.findall(r"fam\.(tc_\w+)", text))) == passes
    wide = ("tc && D <= kSlice && Dv <= kSlice" if source ==
            "hires_attention.cu" else "fam.tc_dkv && (D > kSlice || Dv > "
            "kSlice)")
    assert wide in flat
    # The forward CTA: 64 rows of q ([64][D + 8] bf16) and the ring of
    # four [64][72] bf16 stages, in at most kMaxCtaSmem bytes.
    ring = 4 * 64 * 72 * 2
    fwd_d = kh.TC_MAX_D["fwd"][0]
    assert consts["kMaxCtaSmem"] == 232448
    assert 64 * (fwd_d + 8) * 2 + ring <= 232448 \
        < 64 * (fwd_d + 16 + 8) * 2 + ring
    bf16, f32 = torch.bfloat16, torch.float32
    m, top = kh.BF16_MULTIPLE, kh.TC_MAX_D["dq"][0]
    # All three passes (pass_ None): D, Dv up to the dq pass's 256.
    assert kh.tensor_cores(1024, top, top, bf16)
    assert not kh.tensor_cores(1024, top + m, top, bf16)
    assert not kh.tensor_cores(1024, top, top + m, bf16)
    assert not kh.tensor_cores(1024 - m // 2, top, top, bf16)
    assert not kh.tensor_cores(1024, top - m // 2, top, bf16)
    assert not kh.tensor_cores(1024, top, top, f32)
    # Pass by pass.
    assert kh.tensor_cores(1024, top, top, bf16, "dq")
    assert not kh.tensor_cores(1024, top + m, top, bf16, "dq")
    assert not kh.tensor_cores(1024, top, top + m, bf16, "dq")
    assert kh.tensor_cores(1024, fwd_d, 4096, bf16, "fwd")
    assert not kh.tensor_cores(1024, fwd_d + m, 64, bf16, "fwd")
    assert kh.tensor_cores(1024, 4096, 4096, bf16, "dkv")
    for pass_ in ("fwd", "dq", "dkv"):
        assert kh.tensor_cores(1024, top + m, top - m, bf16, pass_) == \
            (pass_ != "dq")
        assert not kh.tensor_cores(1024 - m // 2, top, top, bf16, pass_)
        assert not kh.tensor_cores(1024, top - m // 2, top, bf16, pass_)
        assert not kh.tensor_cores(1024, top, top, f32, pass_)


_DIMS_CHECK = {
    "hires_attention.cu": r"if \(B < 1 \|\| H < 1 \|\| S < 1 \|\| D < 1 "
                          r"\|\| Dv < 1 \|\|",
    "hires_attention_bwd.cu": r"return B < 1 \|\| H < 1 \|\| S < 1 \|\| "
                              r"D < 1 \|\| Dv < 1;",
}


def test_forward_and_backward_entries_refuse_the_same_dims():
    """The forward's C entry and the backward's `bad_dims` refuse the same
    shapes, none with positive dims (so no shape has a hires forward
    without its backward, and the JAX package's `pallas_fwd` route has no
    shape to take in the port), and `hires_attention.refusal` states it:
    the kernels take every positive S, D, Dv in fp32 and bf16."""
    for source, check in _DIMS_CHECK.items():
        text = " ".join((CSRC / source).read_text().split())
        assert len(re.findall(check, text)) == 1, source
        assert not re.search(r"[DS] > \d+ \|\||is_bf16 && \(S %", text), \
            source
    bf16, f32 = torch.bfloat16, torch.float32
    for s, d, dv in ((1024, 256, 256), (1024, 512, 512), (1020, 264, 200),
                     (37, 3, 1000), (1, 1, 1)):
        for dtype in (bf16, f32):
            assert kh.refusal(s, d, dv, dtype) is None, (s, d, dv, dtype)
    assert "dtype" in kh.refusal(1024, 64, 64, torch.float16)
    assert "positive" in kh.refusal(1024, 0, 64, f32)


def _c_entries(source):
    """{name: (parameters, body)} of the extern "C" entries of a source."""
    text = (CSRC / source).read_text()
    return {m.group(1): (" ".join(m.group(2).split()),
                         text[m.end():text.index("\n}\n", m.end())])
            for m in re.finditer(r'extern "C" \w[\w ]*?(\w+)\(([^)]*)\)\s*\{',
                                 text)}


def test_bf16_entries_pass_is_bf16_to_the_shape_check():
    """Every C entry of the backward source that takes is_bf16 and checks
    its dims with bad_dims (the dq and dk/dv passes) passes is_bf16, S, D
    and Dv to `family_of`, which picks its kernels, and reports its
    launches and shared memory; the weight grads' entry picks its split
    from is_bf16 and S."""
    entries = _c_entries("hires_attention_bwd.cu")
    checked = {name for name, (_, body) in entries.items()
               if "bad_dims(" in body}
    assert checked == {"hires_attention_dq", "hires_attention_dkv"}
    for name in checked:
        params, body = entries[name]
        assert params.startswith("int is_bf16,"), name
        assert re.findall(r"bad_dims\((\w+),", body) == ["B"], name
        assert re.findall(r"family_of\(([\w, ]+)\)", body) == \
            ["is_bf16, S, D, Dv"], name
        assert params.endswith("int* launched, long long* smem"), name
    for name in ("hires_weight_grads", "hires_weight_grads_scratch"):
        assert "split_weight_grads(is_bf16, S)" in entries[name][1], name


def test_every_hires_shape_takes_the_bf16_kernels():
    """Every attention shape of every config that `pick_route` sends to the
    hires route passes the kernels' shape check and runs the bf16
    tensor-core kernels; an S off the multiple passes the check and runs
    the CUDA-core kernels."""
    shapes = set()
    for cfg in configs.CONFIGS.values():
        for _, bcfg in cfg.model.backbone_cfg().block_configs():
            for v in (bcfg.encoder_cfg(), bcfg.decoder_cfg(),
                      bcfg.cross_cfg()):
                d = (v.head_dim_content + v.head_dim_rope) if v.reduce \
                    else v.head_dim
                s = v.seq_len_new
                if pick_route(1, v.heads, s, s, d, v.head_dim,
                              torch.bfloat16)[0] == "hires":
                    shapes.add((v.seq_len_new, d, v.head_dim))
    assert (1024, 256, 256) in shapes and (448, 112, 112) in shapes
    bf16 = torch.bfloat16
    for s, d, dv in sorted(shapes):
        q = torch.empty(1, 1, s, d, dtype=bf16)
        v = torch.empty(1, 1, s, dv, dtype=bf16)
        assert kh._dims(q, q, v, bf16) == (1, 1, s, d, dv)
        assert kh.tensor_cores(s, d, dv, bf16), (s, d, dv)
    q, v = torch.empty(1, 1, 452, 112, dtype=bf16), \
        torch.empty(1, 1, 452, 112, dtype=bf16)
    assert kh._dims(q, q, v, bf16) == (1, 1, 452, 112, 112)
    assert not kh.tensor_cores(452, 112, 112, bf16)
    # hires-cls-1024 at heads=6 (chip_smoke.py phase 15): the forward and
    # dk/dv passes on the tensor cores at all four shapes (the wide kernels
    # past 256), the dq pass on the CUDA cores at the three past 256.
    base = configs.get_config("hires-cls-1024").model
    six = {}
    for _, bcfg in dataclasses.replace(base, heads=6).backbone_cfg() \
            .block_configs():
        for v in (bcfg.encoder_cfg(), bcfg.decoder_cfg(), bcfg.cross_cfg()):
            d = (v.head_dim_content + v.head_dim_rope) if v.reduce \
                else v.head_dim
            key = (v.seq_len_new, d, v.head_dim)
            six[key] = six.get(key, 0) + 1
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parent.parent
        / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert six == smoke.ROUTES_LAYERS
    assert len(six) == 4
    for s, d, dv in six:
        assert pick_route(1, 6, s, s, d, dv, bf16)[0] == "hires"
        assert kh.tensor_cores(s, d, dv, bf16, "fwd"), (s, d, dv)
        assert kh.tensor_cores(s, d, dv, bf16, "dkv"), (s, d, dv)
        assert kh.tensor_cores(s, d, dv, bf16, "dq") == (d <= 256), (s, d)
    assert sum(n for (_, d, _), n in six.items() if d > 256) == 15


VMLA_CFGS = {
    "non_reduce": dict(heads=3, dim1=144, dim2=144, mean_var_hidden=24,
                       seq_length=48, seq_len_reduce=8, seq_len_new=48,
                       mlp_dim=288),
    "reduce": dict(heads=3, dim1=144, dim2=108, mean_var_hidden=24,
                   seq_length=48, seq_len_reduce=8, seq_len_new=36,
                   mlp_dim=216, is_cross=True),
}


def _carry(params, state):
    return from_jax.state_dict_from_jax(jax.tree.map(np.asarray, params),
                                        jax.tree.map(np.asarray, state))


@pytest.mark.parametrize("name", sorted(VMLA_CFGS))
def test_vmla_hires_route_matches_jax(name):
    """A VMLA layer under the forced hires route (RoPE rotated in torch),
    with grad (the autograd Function's forward) and without (the
    forward-only kernel), against the JAX layer on carried weights."""
    kw = VMLA_CFGS[name]
    jcfg = JVMLAConfig(**kw)
    params, state = vmla_init(jcfg, jax.random.PRNGKey(7))
    for _ in range(30):
        state = jax_normalize_tree(params, state, training=True)[1]
    layer = VMLA(VMLAConfig(**kw), torch.Generator().manual_seed(0)).eval()
    layer.load_state_dict(_carry(params, state))
    rng = np.random.default_rng(6)
    xq, xkv = (rng.standard_normal((2, 48, 144)).astype(np.float32)
               for _ in range(2))
    kv = xkv if jcfg.is_cross else None

    def fwd(p, s, q, kv_):
        y, _, _ = vmla_apply(jcfg, p, s, q, input_kv=kv_,
                             latent=JLatentState(mode="sum"),
                             training=False)
        return y

    ref = np.asarray(jax.jit(fwd)(params, state, jnp.asarray(xq),
                                  None if kv is None else jnp.asarray(kv)))
    calls = {"fwd_res": 0}
    plain = kh.hires_fwd_res_plain

    def counting(*a, **k):
        calls["fwd_res"] += 1
        return plain(*a, **k)

    with attention_impl("hires"), pytest.MonkeyPatch.context() as mp:
        mp.setattr(kh, "hires_fwd_res_plain", counting)
        kv_t = None if kv is None else torch.from_numpy(kv)
        y_grad = layer(torch.from_numpy(xq), input_kv=kv_t,
                       latent=LatentState(mode="sum"))
        assert calls["fwd_res"] == 1     # the Function's forward
        with torch.no_grad():
            y = layer(torch.from_numpy(xq), input_kv=kv_t,
                      latent=LatentState(mode="sum"))
        assert calls["fwd_res"] == 1     # forward-only, no residuals
    for got in (y, y_grad.detach()):
        np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=2e-5)


def test_tiny_cls_logits_hires_route_match_jax():
    """The whole tiny-cls forward under the forced hires route against the
    JAX model on carried weights."""
    from calm_vit_dte_tpu.models.factory import create_vit as jax_create_vit
    from calm_vit_dte_tpu.models.vit import vit_apply

    cfg, params, state = jax_create_vit("tiny-cls", seed=0)
    state = converged_sn_state(configs.TINY_VIT, params, state)
    x = np.random.default_rng(1).standard_normal((2, 48, 48, 3)).astype(
        np.float32)
    ref, kl_ref = jax.jit(lambda p, s, x_: vit_apply(
        cfg, p, s, x_, training=False)[:2])(params, state, jnp.asarray(x))
    model = ViT(configs.TINY_VIT, torch.Generator().manual_seed(0)).eval()
    model.load_state_dict(_carry(params, state))
    with attention_impl("hires"), torch.no_grad():
        logits, kl = model(torch.from_numpy(x))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(float(kl), float(kl_ref), rtol=1e-4)


class _Capture(FusedAdamW):
    """Keeps the gradients a step hands the optimizer and changes nothing."""

    def __init__(self):
        self.grads = None

    def update(self, params, grads, state):
        self.grads = [g.clone() for g in grads]


class _Gnorm:
    gnorm = 0.0


class _NoiseSeq:
    def __init__(self):
        self.i = 0

    def __call__(self, shape):
        self.i += 1
        return np.random.default_rng(2000 + self.i).standard_normal(
            shape).astype(np.float32)


def test_remat_train_step_hires_route_matches_default_route():
    """A tiny-cls training step with remat under the forced hires route
    against the default (rope kernel) route, same weights and noise: loss
    and every gradient agree in fp32, and the hires forward ran once per
    attention layer (none in the Block replay)."""
    from calm_vit_dte_tpu_torch.nn.spectral_norm import normalize_tree

    base = ViT(configs.TINY_VIT, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for _ in range(30):
            normalize_tree(base, training=True)
    rng = np.random.default_rng(3)
    t = rng.random((2, 10)).astype(np.float32)
    batch = {"image": rng.standard_normal((2, 48, 48, 3)).astype(np.float32),
             "label": t / t.sum(-1, keepdims=True)}
    layers = sum(3 for _ in base.cfg.backbone_cfg().block_configs())

    def run(route):
        import copy

        cap = _Capture()
        model = copy.deepcopy(base)
        step = make_train_step(configs.TINY_VIT, cap, "cls", dtype=F32,
                               remat=True)
        state = TrainState(model=model, opt_state=_Gnorm(), step=0, seed=0)
        with attention_impl(route), noise_override(_NoiseSeq()):
            _, m = step(state, batch)
        return float(m["loss"]), cap.grads

    calls = []
    plain = kh.hires_fwd_res_plain
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kh, "hires_fwd_res_plain",
                   lambda *a, **k: calls.append(1) or plain(*a, **k))
        loss_h, grads_h = run("hires")
    assert len(calls) == layers == 24
    loss_r, grads_r = run("auto")
    np.testing.assert_allclose(loss_h, loss_r, rtol=1e-5)
    for (name, _), a, b in zip(base.named_parameters(), grads_h, grads_r):
        torch.testing.assert_close(
            a, b, rtol=1e-4, atol=1e-5 * float(b.abs().max()) + 1e-12,
            msg=lambda m_, n=name: f"{n}: {m_}")


def test_config_registry_matches_jax():
    """Every JAX config is in the port with the same model and training
    fields."""
    assert sorted(configs.CONFIGS) == sorted(jax_configs.CONFIGS)
    port_fields = {f.name for f in dataclasses.fields(configs.TrainConfig)}
    for name, jcfg in jax_configs.CONFIGS.items():
        cfg = configs.get_config(name)
        assert dataclasses.asdict(cfg.model) == dataclasses.asdict(
            jcfg.model), name
        for field in port_fields - {"model"}:
            assert getattr(cfg, field) == getattr(jcfg, field), (name, field)


def test_hires_parameter_shapes_match_jax():
    """hires-cls-1024's parameters and u/v buffers, built on the meta device
    (nothing allocated), against `jax.eval_shape` of the JAX init. The JAX
    initializers draw on the host with numpy, which an abstract trace cannot
    run, so they are traced as zeros of their shapes."""
    from calm_vit_dte_tpu.nn import init as jax_init

    cfg = configs.get_config("hires-cls-1024").model
    jcfg = jax_configs.get_config("hires-cls-1024").model
    with pytest.MonkeyPatch.context() as mp:
        for fn in ("kaiming_uniform", "bias_uniform", "normalized_normal"):
            mp.setattr(jax_init, fn, lambda key, shape, *a, **k: jnp.zeros(
                shape, jnp.float32))
        params, sn = jax.eval_shape(
            lambda: vit_init(jcfg, jax.random.PRNGKey(0)))
    with torch.device("meta"):
        model = ViT(cfg, torch.Generator().manual_seed(0))
    sd = model.state_dict()
    want = {from_jax._param_name(path): tuple(leaf.shape)
            for path, leaf in from_jax._leaves(params)}

    def walk(node, path):
        if "u" in node and "v" in node:
            prefix = ".".join(from_jax._rename_back(path))
            want[f"{prefix}.weight_u"] = tuple(node["u"].shape)
            want[f"{prefix}.weight_v"] = tuple(node["v"].shape)
            return
        for k, v in node.items():
            walk(v, path + [k])

    walk(sn, [])
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    n = sum(v.numel() for v in model.parameters())
    assert n == sum(int(np.prod(s)) for s in jax.tree.leaves(
        jax.tree.map(lambda x: x.shape, params),
        is_leaf=lambda x: isinstance(x, tuple)))
    assert abs(n / 1e6 - 935.57) < 0.01
