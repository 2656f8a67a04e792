"""The training-mode modules of the port against the JAX package (fp32,
CPU): VMLA and Block forward and gradients on carried weights under the same
injected noise, the differentiable spectral-norm pre-pass, the losses, the
schedules and the optimizer.

Tolerances: forward rtol 2e-4 per layer, gradients rtol 5e-3 with atol 2e-4
of the leaf's largest value (the limits of tests/test_parity_grad.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from calm_vit_dte_tpu.models.block import BlockConfig as JBlockConfig
from calm_vit_dte_tpu.models.block import block_apply, block_init
from calm_vit_dte_tpu.models.vmla import VMLAConfig as JVMLAConfig
from calm_vit_dte_tpu.models.vmla import vmla_apply, vmla_init
from calm_vit_dte_tpu.nn.spectral_norm import (
    normalize_tree as jax_normalize_tree,
)
from calm_vit_dte_tpu.ops.latent_state import LatentState as JLatentState
from calm_vit_dte_tpu.ops.variational import noise_override as jax_noise
from calm_vit_dte_tpu.train import losses as jax_losses
from calm_vit_dte_tpu.train import optim as jax_optim
from calm_vit_dte_tpu_torch.compat.from_jax import state_dict_from_jax
from calm_vit_dte_tpu_torch.models.block import Block, BlockConfig
from calm_vit_dte_tpu_torch.models.vmla import VMLA, VMLAConfig
from calm_vit_dte_tpu_torch.nn.spectral_norm import (
    SpectralNormed,
    normalize_tree,
)
from calm_vit_dte_tpu_torch.ops.latent_state import LatentState
from calm_vit_dte_tpu_torch.ops.variational import noise_override
from calm_vit_dte_tpu_torch.train import losses, optim

# One intra-op thread: the suite runs several worker processes per machine,
# and a torch thread pool per worker oversubscribes the cores.
torch.set_num_threads(1)

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


class NoiseSeq:
    """The n-th call returns standard normal noise from seed 1000 + n, the
    sequence tests/test_parity_grad.py injects."""

    def __init__(self):
        self.i = 0

    def __call__(self, shape):
        arr = np.random.default_rng(1000 + self.i).standard_normal(shape)
        self.i += 1
        return arr.astype(np.float32)


def _gen():
    return torch.Generator().manual_seed(0)


def _converged(params, state):
    """Power-iterate the JAX state first: at raw init sigma is far too small
    and the outputs overflow to ~1e9, where fp32 comparisons say nothing."""
    for _ in range(30):
        state = jax_normalize_tree(params, state, training=True)[1]
    return state


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def assert_grads_close(named_got: dict, jax_grads: dict, what: str):
    """Per-leaf rtol 5e-3, atol 2e-4 of the leaf's largest value."""
    want = state_dict_from_jax(_np(jax_grads), {})
    assert set(want) == set(named_got), what
    for name, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(
            named_got[name].numpy(), w, rtol=5e-3,
            atol=2e-4 * max(np.abs(w).max(), 1e-12),
            err_msg=f"{what}: {name}")


def assert_uv_close(module, jax_state, what: str):
    want = state_dict_from_jax({}, _np(jax_state))
    got = dict(module.named_buffers())
    assert want, what
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=f"{what}: {name}")


@pytest.mark.parametrize("name", ["vmla_plain", "vmla_reduce"])
def test_vmla_training_forward_and_gradients_match_jax(name):
    kw = VMLA_CFGS[name]
    jcfg = JVMLAConfig(**kw)
    params, state = vmla_init(jcfg, jax.random.PRNGKey(7))
    state = _converged(params, state)
    rng = np.random.default_rng(6)
    xq = rng.standard_normal((2, 48, 144)).astype(np.float32)
    xkv = (rng.standard_normal((2, 48, 144)).astype(np.float32)
           if kw.get("is_cross") else None)
    s_out = kw["seq_len_new"]
    g = rng.standard_normal((2, s_out, kw["dim2"])).astype(np.float32)

    def loss(p, q, kv):
        latent = JLatentState(mode="sum")
        y, new_state, _ = vmla_apply(jcfg, p, state, q, input_kv=kv,
                                     latent=latent, training=True,
                                     rng=jax.random.PRNGKey(1))
        return jnp.sum(y * g) + latent.kl_loss(), (y, new_state,
                                                   latent.kl_loss())

    with jax_noise(NoiseSeq()):
        (gp, gq), (y_ref, new_state, kl_ref) = jax.jit(jax.grad(
            loss, argnums=(0, 1), has_aux=True))(
            params, jnp.asarray(xq), None if xkv is None
            else jnp.asarray(xkv))

    layer = VMLA(VMLAConfig(**kw), _gen()).train()
    layer.load_state_dict(state_dict_from_jax(_np(params), _np(state)))
    tq = torch.from_numpy(xq).requires_grad_()
    latent = LatentState(mode="sum")
    with noise_override(NoiseSeq()):
        y = layer(tq, input_kv=None if xkv is None
                  else torch.from_numpy(xkv), latent=latent)
    (torch.sum(y * torch.from_numpy(g)) + latent.kl_loss()).backward()

    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(float(latent.kl_loss().detach()),
                               float(kl_ref), rtol=1e-4)
    assert_uv_close(layer, new_state, name)   # one power iteration each
    assert_grads_close({k: p.grad for k, p in layer.named_parameters()}, gp,
                       name)
    gq = np.asarray(gq)
    np.testing.assert_allclose(tq.grad.numpy(), gq, rtol=5e-3,
                               atol=2e-4 * np.abs(gq).max())


def test_vmla_dropout_matches_jax_on_its_keep_mask():
    """p = 0.25 after out_proj: the port takes the keep-mask the JAX layer
    draws (bernoulli of fold_in(rng, 1)), injected through noise_override."""
    kw = dict(VMLA_CFGS["vmla_plain"], dropout=0.25)
    jcfg = JVMLAConfig(**kw)
    params, state = vmla_init(jcfg, jax.random.PRNGKey(7))
    state = _converged(params, state)
    xq = np.random.default_rng(8).standard_normal((2, 48, 144)).astype(
        np.float32)
    key = jax.random.PRNGKey(5)
    y_ref, _, _ = vmla_apply(jcfg, params, state, jnp.asarray(xq),
                             training=True, rng=key)
    mask = np.array(jax.random.bernoulli(jax.random.fold_in(key, 1), 0.75,
                                         (2, 48, 144)))
    assert 0.6 < mask.mean() < 0.9
    layer = VMLA(VMLAConfig(**kw), _gen()).train()
    layer.load_state_dict(state_dict_from_jax(_np(params), _np(state)))
    with noise_override(keep_mask=lambda shape: mask.reshape(shape)):
        y = layer(torch.from_numpy(xq))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref),
                               rtol=2e-4, atol=2e-5)
    # From a generator: about a quarter dropped, the rest scaled by 1/keep.
    from calm_vit_dte_tpu_torch.ops.variational import dropout
    x = torch.ones(64, 64)
    d = dropout(x, 0.25, training=True, generator=_gen())
    assert d.unique().tolist() == [0.0, float(np.float32(1.0) / 0.75)]
    assert 0.2 < float((d == 0).float().mean()) < 0.3
    assert dropout(x, 0.25, training=False) is x
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, 0.25, training=True)


def test_block_training_forward_and_gradients_match_jax():
    jcfg = JBlockConfig(**BLOCK_CFG)
    params, state = block_init(jcfg, jax.random.PRNGKey(8))
    state = _converged(params, state)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 48, 48, 3)).astype(np.float32)
    g = rng.standard_normal((2, 36, 108)).astype(np.float32)

    def loss(p, x):
        csm = JLatentState(mode="sum")
        y, new_state = block_apply(jcfg, p, state, x, csm=csm, training=True,
                                   rng=jax.random.PRNGKey(1))
        return jnp.sum(y * g) + csm.kl_loss(), (y, new_state, csm.kl_loss())

    with jax_noise(NoiseSeq()):
        gp, (y_ref, new_state, kl_ref) = jax.jit(
            jax.grad(loss, has_aux=True))(params, jnp.asarray(x))

    block = Block(BlockConfig(**BLOCK_CFG), _gen()).train()
    block.load_state_dict(state_dict_from_jax(_np(params), _np(state)))
    csm = LatentState(mode="sum")
    with noise_override(NoiseSeq()):
        y = block(torch.from_numpy(x), csm=csm)
    (torch.sum(y * torch.from_numpy(g)) + csm.kl_loss()).backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(float(csm.kl_loss().detach()), float(kl_ref),
                               rtol=1e-4)
    assert_uv_close(block, new_state, "block")
    assert_grads_close({k: p.grad for k, p in block.named_parameters()}, gp,
                       "block")


def test_training_needs_a_noise_source():
    layer = VMLA(VMLAConfig(**VMLA_CFGS["vmla_reduce"]), _gen()).train()
    x = torch.zeros(1, 48, 144)
    with pytest.raises(ValueError, match="Generator"):
        layer(x, input_kv=x)
    y = layer(x, input_kv=x, generator=_gen())
    assert y.shape == (1, 36, 108)


def test_normalize_tree_pull_back_matches_jax_vjp():
    """The training pre-pass as graph tensors: u/v updated once, and one
    backward through w/sigma equals jax.vjp(normalize_tree)."""
    kw = VMLA_CFGS["vmla_reduce"]
    params, state = vmla_init(JVMLAConfig(**kw), jax.random.PRNGKey(3))
    rng = np.random.default_rng(4)
    cot = jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), jnp.float32),
        params)   # the normalized tree has the parameters' structure

    @jax.jit
    def pre_pass(p, cot):
        (normed, new_state), vjp = jax.vjp(
            lambda p: jax_normalize_tree(p, state, training=True), p)
        (grads,) = vjp((cot, jax.tree.map(jnp.zeros_like, new_state)))
        return normed, new_state, grads

    normed, new_state, grads = pre_pass(params, cot)

    layer = VMLA(VMLAConfig(**kw), _gen()).train()
    layer.load_state_dict(state_dict_from_jax(_np(params), _np(state)))
    out = normalize_tree(layer, training=True)
    assert all(w.requires_grad for w in out.values())
    named = {m: n for n, m in layer.named_modules()
             if isinstance(m, SpectralNormed)}
    want_w = state_dict_from_jax(_np(normed), {})
    cots = state_dict_from_jax(_np(cot), {})
    for m, w in out.items():
        np.testing.assert_allclose(
            w.detach().numpy(), want_w[f"{named[m]}.weight_orig"].numpy(),
            rtol=1e-5, atol=1e-6)
    torch.autograd.backward(
        list(out.values()),
        [cots[f"{named[m]}.weight_orig"] for m in out])
    assert_uv_close(layer, new_state, "pre-pass")
    got = {k: p.grad for k, p in layer.named_parameters()
           if k.endswith("weight_orig")}
    want = {k: v for k, v in state_dict_from_jax(_np(grads), {}).items()
            if k.endswith("weight_orig")}
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(
            got[k].numpy(), w.numpy(), rtol=5e-3,
            atol=2e-4 * float(w.abs().max()), err_msg=k)
    # Under no_grad (freeze, serving) nothing is recorded.
    with torch.no_grad():
        assert not any(w.requires_grad for w in
                       normalize_tree(layer, training=False).values())


@pytest.mark.parametrize("soft", [True, False])
def test_classification_losses_match_jax(soft):
    rng = np.random.default_rng(11)
    logits = rng.standard_normal((6, 10)).astype(np.float32) * 3
    if soft:
        t = rng.random((6, 10)).astype(np.float32)
        targets = t / t.sum(-1, keepdims=True)
    else:
        targets = rng.integers(0, 10, 6)
    for name in ("softmax_cross_entropy", "dominant_class_accuracy"):
        want = getattr(jax_losses, name)(jnp.asarray(logits),
                                         jnp.asarray(targets))
        got = getattr(losses, name)(torch.from_numpy(logits),
                                    torch.from_numpy(targets))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_reconstruction_losses_match_jax():
    rng = np.random.default_rng(12)
    tokens = rng.standard_normal((2, 8, 24)).astype(np.float32) * 2
    image = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    kl = np.float32(0.37)
    np.testing.assert_allclose(
        float(losses.huber(torch.from_numpy(tokens.reshape(2, 8, 8, 3)),
                           torch.from_numpy(image))),
        float(jax_losses.huber(jnp.asarray(tokens.reshape(2, 8, 8, 3)),
                               jnp.asarray(image))), rtol=1e-6)
    np.testing.assert_allclose(
        float(losses.reconstruction_loss(torch.from_numpy(tokens),
                                         torch.from_numpy(image),
                                         torch.tensor(kl))),
        float(jax_losses.reconstruction_loss(jnp.asarray(tokens),
                                             jnp.asarray(image),
                                             jnp.asarray(kl))), rtol=1e-6)


@pytest.mark.parametrize("kind", ["cosine", "steplr"])
def test_schedules_match_jax(kind):
    if kind == "cosine":
        args = (3.1e-3, 5, 3, 1e-6)
        want = jax_optim.cosine_per_epoch_schedule(*args)
        got = optim.cosine_per_epoch_schedule(*args)
    else:
        args = (3.1e-3, 3, 2, 0.1)
        want = jax_optim.step_lr_schedule(*args)
        got = optim.step_lr_schedule(*args)
    for step in range(0, 24):
        np.testing.assert_allclose(got(step), float(want(jnp.asarray(step))),
                                   rtol=1e-6)


@pytest.mark.parametrize("schedule,decoupled,moments", [
    ("cosine-epoch", True, "float32"), ("steplr", False, "float32"),
    ("cosine-epoch", True, "bfloat16")])
def test_adamw_matches_jax_with_a_skipped_step(schedule, decoupled, moments):
    """Four updates on a random tree, the third with a non-finite gradient:
    it is skipped (count and schedule do not advance, `notfinite` counts it)
    and the trajectory continues. Large gradients exercise the clip."""
    rng = np.random.default_rng(13)
    shapes = {"a": (7, 5), "b": (5,), "c": (3, 2, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    kw = dict(base_lr=3.1e-3, weight_decay=0.02, b1=0.9, b2=0.98, epochs=3,
              steps_per_epoch=1, clip_norm=1.0, schedule=schedule,
              lr_step_size=1, decoupled_wd=decoupled)
    jtx = jax_optim.make_optimizer(**kw, moment_dtype=jnp.dtype(moments))
    tx = optim.make_optimizer(**kw, moment_dtype=getattr(torch, moments))
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jtx.init(jp)
    tp = [torch.from_numpy(params[k].copy()) for k in sorted(params)]
    tstate = tx.init(tp)
    for step in range(4):
        grads = {k: (rng.standard_normal(s) * (0.1 if step == 1 else 2.0)
                     ).astype(np.float32) for k, s in shapes.items()}
        if step == 2:
            grads["b"][1] = np.inf
        updates, jstate = jtx.update(jax.tree.map(jnp.asarray, grads),
                                     jstate, jp)
        jp = optax.apply_updates(jp, updates)
        tx.update(tp, [torch.from_numpy(grads[k]) for k in sorted(grads)],
                  tstate)
        if isinstance(jstate, jax_optim.FusedAdamWState):
            assert tstate.count == int(jstate.count)
            assert tstate.notfinite == int(jstate.notfinite)
            if step != 2:
                np.testing.assert_allclose(float(tstate.gnorm),
                                           float(jstate.gnorm), rtol=1e-6)
        for k, t in zip(sorted(params), tp):
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]),
                                       rtol=2e-5, atol=1e-6,
                                       err_msg=f"step {step} {k}")
    assert tstate.count == 3 and tstate.notfinite == 0
