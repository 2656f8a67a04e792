"""The port's modules against the committed goldens and against the JAX
package on carried weights (fp32, CPU)."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calm_vit_dte_tpu.models.block import BlockConfig as JBlockConfig
from calm_vit_dte_tpu.models.block import block_apply, block_init
from calm_vit_dte_tpu.models.vmla import VMLAConfig as JVMLAConfig
from calm_vit_dte_tpu.models.vmla import vmla_apply, vmla_init
from calm_vit_dte_tpu.nn.norm import layer_norm_apply
from calm_vit_dte_tpu.nn.spectral_norm import (
    normalize_tree as jax_normalize_tree,
)
from calm_vit_dte_tpu.nn.spectral_norm import spectral_normalize as jax_sn
from calm_vit_dte_tpu.ops.latent_state import LatentState as JLatentState
from calm_vit_dte_tpu_torch.compat.from_jax import state_dict_from_jax
from calm_vit_dte_tpu_torch.models.block import Block, BlockConfig
from calm_vit_dte_tpu_torch.models.vmla import VMLA, VMLAConfig
from calm_vit_dte_tpu_torch.nn.conv import SNConv2d
from calm_vit_dte_tpu_torch.nn.linear import SNLinear
from calm_vit_dte_tpu_torch.nn.norm import LayerNorm
from calm_vit_dte_tpu_torch.nn.spectral_norm import (
    freeze,
    normalize_tree,
    spectral_normalize,
)
from calm_vit_dte_tpu_torch.ops.latent_state import LatentState
from calm_vit_dte_tpu_torch.ops.rope import rope_apply

GOLDEN = pathlib.Path(__file__).parent / "golden"
VMLA_CFGS = {
    "vmla_plain": dict(heads=3, dim1=144, dim2=144, mean_var_hidden=24,
                       seq_length=48, seq_len_reduce=8, seq_len_new=48,
                       mlp_dim=288),
    "vmla_reduce": dict(heads=3, dim1=144, dim2=108, mean_var_hidden=24,
                        seq_length=48, seq_len_reduce=8, seq_len_new=36,
                        mlp_dim=216, is_cross=True),
}
BLOCK_CFG = dict(heads=3, dim1=144, dim_step=-12, mean_var_hidden=24,
                 seq_length=48, seq_len_step=-4, is_first_block=True,
                 is_last_block=False, seq_len_reduce=8)


def load(name):
    d = np.load(GOLDEN / f"{name}.npz")
    sd = {k[3:]: torch.from_numpy(d[k]) for k in d.files
          if k.startswith("sd/")}
    ins = {k[3:]: d[k] for k in d.files if k.startswith("in/")}
    outs = {k[4:]: d[k] for k in d.files if k.startswith("out/")}
    return sd, ins, outs


def _gen():
    return torch.Generator().manual_seed(0)


def test_sn_linear_train_golden():
    """Two training-mode forwards: y and the updated (u, v) follow torch's
    power-iteration semantics."""
    d = np.load(GOLDEN / "sn_linear_train.npz")
    layer = SNLinear(24, 16, generator=_gen())
    layer.load_state_dict({k[4:]: torch.from_numpy(d[k]) for k in d.files
                           if k.startswith("sd0/")})
    layer.train()
    for step in (1, 2):
        y = layer(torch.from_numpy(d[f"in/x{step}"]))
        np.testing.assert_allclose(y.detach().numpy(), d[f"out/y{step}"],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(layer.weight_u.numpy(),
                                   d[f"sd{step}/weight_u"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(layer.weight_v.numpy(),
                                   d[f"sd{step}/weight_v"], rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("shape", [(16, 24), (32, 1, 3, 3)])
@pytest.mark.parametrize("training", [False, True])
def test_spectral_normalize_matches_jax(shape, training):
    rng = np.random.default_rng(3)
    w = rng.standard_normal(shape).astype(np.float32)
    u = rng.standard_normal(shape[0]).astype(np.float32)
    v = rng.standard_normal(int(np.prod(shape[1:]))).astype(np.float32)
    u /= np.linalg.norm(u)
    v /= np.linalg.norm(v)
    wj, sj = jax_sn(jnp.asarray(w), {"u": jnp.asarray(u),
                                     "v": jnp.asarray(v)}, training=training)
    wt, ut, vt = spectral_normalize(torch.from_numpy(w), torch.from_numpy(u),
                                    torch.from_numpy(v), training=training)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(ut.numpy(), np.asarray(sj["u"]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(vt.numpy(), np.asarray(sj["v"]), rtol=1e-5,
                               atol=1e-6)


def test_normalize_tree_batches_like_per_layer():
    """The batched pre-pass equals per-layer normalization, in eval (freeze)
    and in training (u/v updates)."""
    g = _gen()
    model = torch.nn.ModuleList(
        [SNLinear(24, 16, generator=g), SNLinear(24, 16, generator=g),
         SNLinear(8, 16, generator=g), SNConv2d(32, 32, 3, groups=32,
                                                generator=g)])
    ref = [spectral_normalize(m.weight_orig, m.weight_u, m.weight_v,
                              training=True) for m in model]
    out = normalize_tree(model, training=True)
    for m, (w, u, v) in zip(model, ref):
        torch.testing.assert_close(out[m], w, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(m.weight_u, u, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(m.weight_v, v, rtol=1e-5, atol=1e-6)
    model.eval()
    before = [m.normalized_weight() for m in model]
    freeze(model)
    for m, w in zip(model, before):
        torch.testing.assert_close(m.weight_frozen, w, rtol=1e-5, atol=1e-6)
        assert m.normalized_weight() is m.weight_frozen


def test_rope_golden():
    sd, ins, outs = load("rope")
    y = rope_apply(sd["inv_freq"], torch.from_numpy(ins["x"]))
    np.testing.assert_allclose(y.numpy(), outs["y"], rtol=1e-5, atol=1e-5)


def test_layer_norm_matches_jax():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((2, 5, 144)) * 3 + 1).astype(np.float32)
    scale = rng.standard_normal(144).astype(np.float32)
    ln = LayerNorm(144)
    ln.weight.data = torch.from_numpy(scale)
    ref = layer_norm_apply({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    np.testing.assert_allclose(ln(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["sum", "sma", "ema", "lp", "static"])
def test_latent_state_matches_jax(mode):
    """Every combine mode, including the restart on a shape change."""
    rng = np.random.default_rng(5)
    js, ts = JLatentState(mode=mode), LatentState(mode=mode)
    for shape in [(2, 8, 24)] * 3 + [(2, 6, 24)] * 2:
        arrs = [rng.standard_normal(shape).astype(np.float32)
                for _ in range(2)]
        arrs += [rng.standard_normal(shape).astype(np.float32),
                 np.abs(rng.standard_normal(shape)).astype(np.float32) + 0.1,
                 rng.standard_normal(shape).astype(np.float32),
                 np.abs(rng.standard_normal(shape)).astype(np.float32) + 0.1]
        jq, jkv = js.update(*map(jnp.asarray, arrs))
        tq, tkv = ts.update(*map(torch.from_numpy, arrs))
        np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(tkv.numpy(), np.asarray(jkv), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_allclose(float(ts.kl_loss()), float(js.kl_loss()),
                               rtol=1e-5)


@pytest.mark.parametrize("name", ["vmla_plain", "vmla_reduce"])
def test_vmla_golden(name):
    sd, ins, outs = load(name)
    layer = VMLA(VMLAConfig(**VMLA_CFGS[name]), _gen()).eval()
    layer.load_state_dict(sd)
    xkv = torch.from_numpy(ins["xkv"]) if "xkv" in ins else None
    with torch.no_grad():
        y = layer(torch.from_numpy(ins["xq"]), input_kv=xkv)
    np.testing.assert_allclose(y.numpy(), outs["y"], rtol=2e-4, atol=2e-5)


def test_block_golden():
    sd, ins, outs = load("block_first")
    block = Block(BlockConfig(**BLOCK_CFG), _gen()).eval()
    block.load_state_dict(sd)
    csm = LatentState(mode="sum")
    x = torch.from_numpy(ins["x"]).permute(0, 2, 3, 1)  # NCHW -> NHWC
    with torch.no_grad():
        y = block(x, csm=csm)
    np.testing.assert_allclose(y.numpy(), outs["y"], rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(float(csm.kl_loss()), outs["kl"], rtol=1e-4)


def _converged(params, state):
    """Run the JAX power iteration to convergence first: at raw init the
    sigma estimates are far too small and the layer outputs overflow to
    ~1e9, where fp32 comparisons say nothing."""
    for _ in range(30):
        state = jax_normalize_tree(params, state, training=True)[1]
    return state


def _carry(params, state):
    return state_dict_from_jax(jax.tree.map(np.asarray, params),
                               jax.tree.map(np.asarray, state))


def test_vmla_matches_jax_on_carried_weights():
    """A reducing cross layer (t_reduce, decoupled RoPE, latent update) with
    weights initialized by the JAX package."""
    kw = VMLA_CFGS["vmla_reduce"]
    params, state = vmla_init(JVMLAConfig(**kw), jax.random.PRNGKey(7))
    state = _converged(params, state)
    layer = VMLA(VMLAConfig(**kw), _gen()).eval()
    layer.load_state_dict(_carry(params, state))
    rng = np.random.default_rng(6)
    xq, xkv = (rng.standard_normal((2, 48, 144)).astype(np.float32)
               for _ in range(2))

    def fwd(p, s, q, kv):
        latent = JLatentState(mode="sum")
        y, _, _ = vmla_apply(JVMLAConfig(**kw), p, s, q, input_kv=kv,
                             latent=latent, training=False)
        return y, latent.kl_loss()

    ref, kl_ref = jax.jit(fwd)(params, state, jnp.asarray(xq),
                               jnp.asarray(xkv))
    latent = LatentState(mode="sum")
    with torch.no_grad():
        y = layer(torch.from_numpy(xq), input_kv=torch.from_numpy(xkv),
                  latent=latent)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(float(latent.kl_loss()), float(kl_ref),
                               rtol=1e-4)


def test_block_matches_jax_on_carried_weights():
    params, state = block_init(JBlockConfig(**BLOCK_CFG),
                               jax.random.PRNGKey(8))
    state = _converged(params, state)
    block = Block(BlockConfig(**BLOCK_CFG), _gen()).eval()
    block.load_state_dict(_carry(params, state))
    x = np.random.default_rng(9).standard_normal((2, 48, 48, 3)).astype(
        np.float32)

    def fwd(p, s, x):
        csm = JLatentState(mode="sum")
        y, _ = block_apply(JBlockConfig(**BLOCK_CFG), p, s, x, csm=csm,
                           training=False)
        return y, csm.kl_loss()

    ref, kl_ref = jax.jit(fwd)(params, state, jnp.asarray(x))
    csm = LatentState(mode="sum")
    with torch.no_grad():
        y = block(torch.from_numpy(x), csm=csm)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(float(csm.kl_loss()), float(kl_ref),
                               rtol=1e-4)
