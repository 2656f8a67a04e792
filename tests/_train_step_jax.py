"""The port's `make_train_step` and `make_eval_step` against the JAX
package's at the tiny configs (tiny-cls and tiny-reg, S=48, fp32, CPU), on
carried weights, u/v and optimizer state under the same injected noise,
compared after every step. tests/test_torch_train_step_jax.py runs the
tiny-cls case and tests/test_torch_train_step_jax_reg.py the tiny-reg one,
so that the two JAX compiles run in two files.

Limits are those of tests/test_parity_grad.py: losses rtol 2e-4, grad norms
rtol 2e-3, parameters rtol 1e-3 / atol 5e-4 of the leaf's largest value,
u/v rtol 5e-3 / atol 2e-3 of it. The spectral-norm pre-pass
(`normalize_tree`, both modes) is held leaf by leaf before and after each
step at rtol 1e-5 / atol 1e-6 of the leaf's largest value: the two sides
differ there only in the fp32 reduction order of u, v and sigma, a few ulps.
"""

import copy
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _sn_warmup import converged_sn_state

from calm_vit_dte_tpu.models.vit import ViTConfig as JViTConfig
from calm_vit_dte_tpu.models.vit import vit_init
from calm_vit_dte_tpu.nn.spectral_norm import (
    normalize_tree as jax_normalize_tree,
)
from calm_vit_dte_tpu.ops.variational import noise_override as jax_noise
from calm_vit_dte_tpu.train.optim import make_optimizer as jax_make_optimizer
from calm_vit_dte_tpu.train.state import (
    create_train_state as jax_create_train_state,
)
from calm_vit_dte_tpu.train.step import make_eval_step as jax_make_eval_step
from calm_vit_dte_tpu.train.step import make_train_step as jax_make_train_step
from calm_vit_dte_tpu_torch.compat.from_jax import (
    adamw_state_from_jax,
    params_to_jax,
    state_dict_from_jax,
)
from calm_vit_dte_tpu_torch.kernels import axial_attention as ka
from calm_vit_dte_tpu_torch.models.vit import ViT
from calm_vit_dte_tpu_torch.nn.spectral_norm import normalize_tree
from calm_vit_dte_tpu_torch.ops.variational import noise_override
from calm_vit_dte_tpu_torch.train.optim import make_optimizer
from calm_vit_dte_tpu_torch.train.state import TrainState
from calm_vit_dte_tpu_torch.train.step import make_eval_step, make_train_step
from calm_vit_dte_tpu_torch.utils.configs import TINY_VIT

# One intra-op thread: the suite runs several worker processes per machine,
# and a torch thread pool per worker oversubscribes the cores.
torch.set_num_threads(1)

OPT = dict(base_lr=3.1e-3, weight_decay=0.02, b1=0.9, b2=0.98, epochs=5,
           steps_per_epoch=2, clip_norm=1.0)
F32 = torch.float32


class NoiseSeq:
    """Call n returns standard normal noise from seed 1000 + n."""

    def __init__(self):
        self.i = 0

    def __call__(self, shape):
        arr = np.random.default_rng(1000 + self.i).standard_normal(shape)
        self.i += 1
        return arr.astype(np.float32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(b=4, seed=0):
    rng = np.random.default_rng(seed)
    t = rng.random((b, 10)).astype(np.float32)
    return {"image": rng.standard_normal((b, 48, 48, 3)).astype(np.float32),
            "label": t / t.sum(-1, keepdims=True)}


def assert_leaves_close(got: dict, want: dict, rtol, atol_frac, what):
    assert set(got) == set(want), what
    for name, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(
            np.asarray(got[name]), w, rtol=rtol,
            atol=atol_frac * max(np.abs(w).max(), 1e-12),
            err_msg=f"{what}: {name}")


# The JAX pre-pass in both modes, as one compiled program.
_jax_prepass = jax.jit(lambda p, s: (
    jax_normalize_tree(p, s, training=False),
    jax_normalize_tree(p, s, training=True)))


def _prepass_close(model, jparams, jsn, what):
    """The port's `normalize_tree` against the JAX one on the same (JAX)
    state, in eval and in training mode."""
    both = _jax_prepass(jparams, jsn)
    for training in (False, True):
        jp, js = both[training]
        want = state_dict_from_jax(_np(jp), _np(js))
        m = copy.deepcopy(model)
        m.load_state_dict(state_dict_from_jax(_np(jparams), _np(jsn)))
        with torch.no_grad():
            normed = normalize_tree(m, training=training)
        names = {mod: name for name, mod in m.named_modules()}
        got = {f"{names[mod]}.weight_orig": w.numpy()
               for mod, w in normed.items()}
        assert_leaves_close(got, {k: want[k] for k in got}, 1e-5, 1e-6,
                            f"{what}: normalize_tree(training={training})")
        if training:
            uv = {k: v.numpy() for k, v in m.named_buffers()
                  if k.endswith(("weight_u", "weight_v"))}
            assert_leaves_close(uv, {k: want[k] for k in uv}, 1e-5, 1e-6,
                                f"{what}: normalize_tree u/v")


def three_steps_match_jax_on_carried_state(task, steps):
    """One JAX step first, so the carried optimizer state is not trivial;
    then `steps` steps of both, compared after each: loss, grad norm, kl,
    parameters and u/v, and the pre-pass before and after. The JAX step is jitted once under the
    noise hook, so it sees the same noise every step; the port gets the
    same. tiny-reg is TINY_VIT with out_features 144 and `generate`."""
    cfg = TINY_VIT if task == "cls" else replace(
        TINY_VIT, out_features=144, generate=True)
    jcfg = JViTConfig(**{f: getattr(cfg, f) for f in (
        "heads", "seq_length", "in_features", "dim_step", "mean_var_hidden",
        "seq_len_step", "seq_len_reduce", "out_features", "generate")})
    params, sn = vit_init(jcfg, jax.random.PRNGKey(0))
    sn = converged_sn_state(cfg, params, sn)
    jtx = jax_make_optimizer(**OPT)
    jstate = jax_create_train_state(params, sn, jtx, jax.random.PRNGKey(3))
    jstep = jax.jit(jax_make_train_step(jcfg, jtx, task, dtype=jnp.float32,
                                        remat=False))
    batch = _batch()
    if task == "reg":
        del batch["label"]
    jbatch = jax.tree.map(jnp.asarray, batch)
    with jax_noise(NoiseSeq()):
        jstate, _ = jstep(jstate, jbatch)

    model = ViT(cfg, torch.Generator().manual_seed(0))
    model.load_state_dict(state_dict_from_jax(_np(jstate.params),
                                              _np(jstate.sn_state)))
    opt = jstate.opt_state
    tx = make_optimizer(**OPT)
    state = TrainState(model=model, step=int(jstate.step), seed=3,
                       opt_state=adamw_state_from_jax(
                           _np(jstate.params), opt.count, opt.mu, opt.nu,
                           model))
    assert state.opt_state.count == 1
    step = make_train_step(cfg, tx, task, dtype=F32, remat=False)
    flat_j0 = jax.tree_util.tree_leaves_with_path(_np(jstate.params))

    _prepass_close(model, jstate.params, jstate.sn_state, f"{task} start")
    for i in range(steps):
        what = f"{task} step {i + 1}"
        jstate, jm = jstep(jstate, jbatch)
        with noise_override(NoiseSeq()):
            state, m = step(state, batch)
        for name, rtol in (("loss", 2e-4), ("grad_norm", 2e-3), ("kl", 2e-4)):
            np.testing.assert_allclose(float(m[name]), float(jm[name]),
                                       rtol=rtol, err_msg=f"{what}: {name}")
        if task == "cls":
            assert float(m["accuracy"]) == float(jm["accuracy"])
        # Parameters through the inverse carry (the port's parameters in
        # the JAX tree's layout), u/v through the forward one.
        back = params_to_jax(model, _np(jstate.params))
        flat_b = jax.tree_util.tree_leaves_with_path(back)
        flat_j = jax.tree_util.tree_leaves_with_path(_np(jstate.params))
        assert [p for p, _ in flat_b] == [p for p, _ in flat_j]
        assert_leaves_close(
            {jax.tree_util.keystr(p): v for p, v in flat_b},
            {jax.tree_util.keystr(p): v for p, v in flat_j}, 1e-3, 5e-4,
            f"{what}: params")
        uv_w = state_dict_from_jax({}, _np(jstate.sn_state))
        got = {k: v for k, v in model.named_buffers() if k in uv_w}
        assert_leaves_close(got, uv_w, 5e-3, 2e-3, f"{what}: u/v")
    _prepass_close(model, jstate.params, jstate.sn_state, f"{task} end")
    assert state.step == steps + 1 and state.opt_state.count == steps + 1
    assert ka.fused_rope_attention.launches == 0    # CPU: plain versions
    assert any(not np.array_equal(v, w) for (_, v), (_, w) in zip(
        flat_j0, jax.tree_util.tree_leaves_with_path(_np(jstate.params))))

    # The eval step on the trained state.
    if task == "cls":
        labels = np.argmax(batch["label"], axis=-1)
        ebatch = {"image": batch["image"], "label": labels}
    else:
        ebatch = dict(batch)
    jev = jax.jit(jax_make_eval_step(jcfg, task, dtype=jnp.float32))(
        jstate, jax.tree.map(jnp.asarray, ebatch))
    ev = make_eval_step(cfg, task, dtype=F32)(state, ebatch)
    np.testing.assert_allclose(float(ev["kl"]), float(jev["kl"]), rtol=2e-4)
    if task == "cls":
        assert int(ev["correct"]) == int(jev["correct"])
        assert int(ev["total"]) == 4
    else:
        np.testing.assert_allclose(float(ev["loss"]), float(jev["loss"]),
                                   rtol=2e-4)
