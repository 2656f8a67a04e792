"""The port's data- and tensor-parallel steps against the JAX package's
GSPMD data-parallel step: tiny-cls, fp32, two steps under the same
injected global noise, from a carried state (tests/_torch_parallel_runs
.py). The port runs on four gloo ranks (4x1 and 2x2, tp_min_shard_dim 64)
while this process runs JAX DP on make_mesh(data=4, model=1) over
conftest's virtual CPU devices: the one JAX train-step compile of the
parallel tests. Limits: tests/test_parity_grad.py:183-195 (losses rtol
2e-4, grad norms 2e-3, params rtol 1e-3 / atol 5e-4 of the leaf's largest
value).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parallel_runs import (
    BATCH,
    COMMON,
    carry_state,
    four_ranks,
    losses,
    rank_runs,
)
from _train_step_jax import NoiseSeq, OPT, _np, assert_leaves_close

from calm_vit_dte_tpu.models.vit import ViTConfig as JViTConfig
from calm_vit_dte_tpu.ops.variational import noise_override as jax_noise
from calm_vit_dte_tpu.parallel.mesh import batch_sharding
from calm_vit_dte_tpu.parallel.mesh import make_mesh as jax_make_mesh
from calm_vit_dte_tpu.parallel.mesh import replicated_sharding
from calm_vit_dte_tpu.train.optim import FusedAdamWState
from calm_vit_dte_tpu.train.optim import make_optimizer as jax_make_optimizer
from calm_vit_dte_tpu.train.state import (
    create_train_state as jax_create_train_state,
)
from calm_vit_dte_tpu.train.step import make_train_step as jax_make_train_step
from calm_vit_dte_tpu_torch.compat.from_jax import (
    adamw_state_to_jax,
    jax_trees,
    params_to_jax,
)
from calm_vit_dte_tpu_torch.models.factory import create_vit
from calm_vit_dte_tpu_torch.models.vit import ViT
from calm_vit_dte_tpu_torch.tools import parallel_step as ps
from calm_vit_dte_tpu_torch.train.checkpoint import restore_checkpoint
from calm_vit_dte_tpu_torch.train.optim import make_optimizer
from calm_vit_dte_tpu_torch.train.state import create_train_state
from calm_vit_dte_tpu_torch.utils.configs import TINY_VIT

# One intra-op thread: the suite runs several worker processes per machine.
torch.set_num_threads(1)


def _jax_dp_steps(run: dict) -> dict:
    """JAX DP from the carried state under the same injected noise:
    losses, grad norms and the final params."""
    jcfg = JViTConfig(**{f: getattr(TINY_VIT, f) for f in (
        "heads", "seq_length", "in_features", "dim_step", "mean_var_hidden",
        "seq_len_step", "seq_len_reduce", "out_features", "generate")})
    _, model = create_vit("tiny-cls", seed=0, device="cpu")
    carried = create_train_state(model, make_optimizer(**OPT), seed=0)
    restore_checkpoint(run["restore"], carried)
    opt = carried.opt_state
    params, sn = jax_trees(model.state_dict())
    mu, nu = adamw_state_to_jax(model, opt)
    mesh = jax_make_mesh(data=4, model=1, devices=jax.devices()[:4])
    jtx = jax_make_optimizer(**OPT)
    state = jax_create_train_state(jax.tree.map(jnp.asarray, params),
                                   jax.tree.map(jnp.asarray, sn), jtx,
                                   jax.random.PRNGKey(3))
    state = dataclasses.replace(
        state, step=jnp.asarray(carried.step, jnp.int32),
        opt_state=FusedAdamWState(
            count=jnp.asarray(opt.count, jnp.int32),
            notfinite=jnp.asarray(opt.notfinite, jnp.int32),
            gnorm=jnp.asarray(float(opt.gnorm), jnp.float32),
            mu=jnp.asarray(mu), nu=jnp.asarray(nu)))
    state = jax.device_put(state, replicated_sharding(mesh))
    step = jax.jit(jax_make_train_step(jcfg, jtx, "cls", dtype=jnp.float32,
                                       remat=False))
    sh = batch_sharding(mesh)
    batch = {k: jax.device_put(v, sh)
             for k, v in ps.global_batch(run).items()}
    out = {"losses": [], "grad_norms": []}
    for i in range(run["steps"]):
        if i == 0:   # traced here: the same noise every step
            with jax_noise(NoiseSeq()):
                state, m = step(state, batch)
        else:
            state, m = step(state, batch)
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
    out["params"] = _np(state.params)
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("parallel_jax")
    run = dict(COMMON, name="jax", steps=2, preprocess=False,
               noise_seed=1000, restore=carry_state(out / "carried"),
               meshes=[[4, 1], [2, 2]])
    with four_ranks([run], out) as res:
        res["jax"] = _jax_dp_steps(run)
    return res


@pytest.mark.parametrize("layout", ["4x1", "2x2"])
def test_parallel_steps_match_jax_dp(results, layout):
    """(d) two fp32 steps under the same injected global noise against the
    JAX package's DP step on a 4-device mesh."""
    ref = results["jax"]
    rec = rank_runs(results, "jax", layout)[0]
    np.testing.assert_allclose(losses(rec), ref["losses"], rtol=2e-4)
    np.testing.assert_allclose([m["grad_norm"] for m in rec["metrics"]],
                               ref["grad_norms"], rtol=2e-3)
    model = ViT(TINY_VIT, torch.Generator().manual_seed(0))
    model.load_state_dict(rec["state"])
    got = params_to_jax(model, ref["params"])
    flat = jax.tree_util.tree_leaves_with_path
    assert_leaves_close(
        {jax.tree_util.keystr(p): v for p, v in flat(got)},
        {jax.tree_util.keystr(p): v for p, v in flat(ref["params"])},
        1e-3, 5e-4, f"{layout} params")
    # Every draw had the global batch's rows.
    assert rec["noise_shapes"][0] and all(
        s[0] == BATCH for s in rec["noise_shapes"][0])
