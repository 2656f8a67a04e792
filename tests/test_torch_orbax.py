"""The JAX package's Orbax checkpoints in the port (compat/orbax.py), at
tiny-cls on the CPU: the JAX package's own `save_checkpoint` in both
optimizer layouts, and a format-1 directory, read and imported bit for bit;
the port's export restored bit for bit by the JAX package's unedited
`restore_checkpoint`, into a fused-flat and, through its own migration, a
tree template; `create_vit(weights=)` from every source; serving an Orbax
directory against the JAX forward; a trainer resuming a JAX run's
checkpoint_dir; and a process that reads and writes Orbax through the port
with no jax loaded."""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from calm_vit_dte_tpu.models.vit import vit_init
from calm_vit_dte_tpu.nn.spectral_norm import normalize_tree
from calm_vit_dte_tpu.serve import Predictor as JaxPredictor
from calm_vit_dte_tpu.train.checkpoint import (
    migrate_opt_state,
    opt_layout,
    restore_checkpoint as jax_restore,
    save_checkpoint as jax_save,
)
from calm_vit_dte_tpu.train.optim import FusedAdamWState, make_optimizer
from calm_vit_dte_tpu.train.state import TrainState as JaxTrainState
from calm_vit_dte_tpu_torch.compat import orbax
from calm_vit_dte_tpu_torch.compat.from_jax import (
    _leaves,
    _param_name,
    adamw_state_from_jax,
    jax_path,
    state_dict_from_jax,
)
from calm_vit_dte_tpu_torch.models.factory import create_vit
from calm_vit_dte_tpu_torch.serve import Predictor
from calm_vit_dte_tpu_torch.train import train_cls
from calm_vit_dte_tpu_torch.train.checkpoint import (
    checkpoint_meta,
    restore_checkpoint,
    save_checkpoint,
)
from calm_vit_dte_tpu_torch.train.optim import make_optimizer as port_optim
from calm_vit_dte_tpu_torch.train.state import create_train_state
from calm_vit_dte_tpu_torch.utils.configs import get_config

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONFIG = "tiny-cls"
STEP = 3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _migrator(tree_tx):
    """The JAX package's `migrate_opt_state` of a fused state into a fresh
    state of `tree_tx`, as one compiled program (eagerly it is ~1000 small
    ones)."""
    return jax.jit(lambda f, p: migrate_opt_state(f, tree_tx.init(p), p))


@pytest.fixture(scope="module")
def jax_states():
    """A tiny-cls JAX TrainState in each optimizer layout, holding the same
    values: params and u/v from the JAX init, moments, count, skip counter,
    gnorm, step and key made from a seed (the tree state's moments by the
    JAX package's own migration of the fused ones)."""
    cfg = get_config(CONFIG)
    params, sn_state = vit_init(cfg.model, jax.random.PRNGKey(0))
    n = sum(np.size(leaf) for leaf in jax.tree.leaves(params))
    rng = np.random.default_rng(0)
    fused = FusedAdamWState(
        count=jnp.asarray(STEP, jnp.int32),
        notfinite=jnp.asarray(1, jnp.int32),
        gnorm=jnp.asarray(0.75, jnp.float32),
        mu=jnp.asarray(rng.standard_normal(n) * 1e-3, jnp.float32),
        nu=jnp.asarray(rng.random(n) * 1e-6, jnp.float32))
    tx_t = make_optimizer(1e-3, 0.02, epochs=4, steps_per_epoch=2,
                          flatten=False)
    flat = JaxTrainState(params=params, sn_state=sn_state, opt_state=fused,
                         step=jnp.asarray(STEP, jnp.int32),
                         rng=jax.random.PRNGKey(7))
    migrate = _migrator(tx_t)
    tree = JaxTrainState(params=params, sn_state=sn_state,
                         opt_state=migrate(fused, params), step=flat.step,
                         rng=flat.rng)
    return {"fused-flat": flat, "tree": tree, "migrate": migrate}


def _save(kind, states, root: pathlib.Path) -> str:
    path = root / kind
    if kind == "v1":   # rounds 1-4: the bare state, no meta item
        with ocp.CheckpointManager(
                str(path),
                options=ocp.CheckpointManagerOptions(create=True)) as mgr:
            mgr.save(STEP, args=ocp.args.StandardSave(states["fused-flat"]))
    else:
        jax_save(str(path), states[kind])
    return str(path)


@pytest.fixture(scope="module")
def saved(jax_states, tmp_path_factory):
    root = tmp_path_factory.mktemp("orbax")
    return {kind: _save(kind, jax_states, root)
            for kind in ("fused-flat", "tree", "v1")}


def _port_state(seed=0):
    _, model = create_vit(CONFIG, seed=seed, device="cpu")
    return create_train_state(model, port_optim(), seed=seed)


def _assert_port_holds(state, jax_state_):
    """The port's state holds the JAX state bit for bit: parameters, u/v,
    moments (carried from the fused-flat layout), count, skip counter,
    step and key."""
    want = state_dict_from_jax(_np(jax_state_.params),
                               _np(jax_state_.sn_state))
    got = state.model.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    fused = jax_state_.opt_state
    opt = adamw_state_from_jax(_np(jax_state_.params), fused.count,
                               fused.mu, fused.nu, state.model)
    for a, b in zip(state.opt_state.mu + state.opt_state.nu,
                    opt.mu + opt.nu):
        assert torch.equal(a, b)
    assert state.opt_state.count == STEP
    assert state.opt_state.notfinite == 1
    assert state.step == STEP
    assert state.jax_rng == [int(x) for x in
                             np.asarray(jax.random.key_data(
                                 jax_state_.rng)).ravel()]


@pytest.mark.parametrize("kind", ["fused-flat", "tree", "v1"])
def test_read_and_import(kind, saved, jax_states, tmp_path):
    """read_orbax and the import CLI on each kind of directory: the values
    bit for bit, through a step_<n>.pt and back."""
    path = saved[kind]
    ck = orbax.read_orbax(path)
    assert ck["opt"]["layout"] == ("tree" if kind == "tree"
                                   else "fused-flat")
    assert ck["meta"] == ({"format_version": 1} if kind == "v1" else
                          {"format_version": 2, "opt_layout": ck["opt"][
                              "layout"], "step": STEP})
    assert checkpoint_meta(path)["format_version"] == (
        1 if kind == "v1" else 2)
    ref = jax_states["fused-flat"]
    for (p, a), (_, b) in zip(_leaves(ck["params"]),
                              _leaves(_np(ref.params))):
        assert a.dtype == b.dtype and np.array_equal(a, b), p
    gnorm = 0.0 if kind == "tree" else 0.75
    assert ck["opt"]["gnorm"] == np.float32(gnorm)
    orbax.main(["import", path, str(tmp_path / "pt"), "--config", CONFIG])
    state = _port_state(seed=9)
    assert restore_checkpoint(str(tmp_path / "pt"), state) is state
    _assert_port_holds(state, ref)
    assert float(state.opt_state.gnorm) == np.float32(gnorm)
    assert state.seed == get_config(CONFIG).init_seed + 1
    direct = _port_state(seed=9)
    assert restore_checkpoint(path, direct) is direct
    _assert_port_holds(direct, ref)
    assert direct.seed == 9   # an Orbax restore keeps the port's seed


def test_names_invert():
    """jax_path undoes the port's naming for every tiny-cls leaf."""
    params, sn_state = vit_init(get_config(CONFIG).model,
                                jax.random.PRNGKey(0))
    for path, _ in _leaves(_np(params)):
        assert jax_path(_param_name(path)) == ("params", path)
    names = state_dict_from_jax(_np(params), _np(sn_state))
    uv = [n for n in names if n.endswith(("weight_u", "weight_v"))]
    assert uv
    for name in uv:
        tree, path = jax_path(name)
        node = sn_state
        for k in path:
            node = node[k]
        assert tree == "sn_state"
        assert torch.equal(names[name], torch.from_numpy(np.asarray(node)))


def test_export_restores_in_jax(saved, jax_states, tmp_path):
    """The port's state, exported, restores in the JAX package bit for bit
    into both templates, and reads back through the port unchanged."""
    state = _port_state()
    restore_checkpoint(saved["fused-flat"], state)
    with torch.no_grad():   # the port's own values, not only carried ones
        for p in state.model.parameters():
            p.add_(0.25)
    state.step = state.opt_state.count = STEP + 2
    save_checkpoint(str(tmp_path / "pt"), state)
    orbax.main(["export", str(tmp_path / "pt"), str(tmp_path / "ox"),
                "--config", CONFIG])
    ref = jax_states["fused-flat"]
    fused = jax_restore(str(tmp_path / "ox"), ref)
    assert opt_layout(fused.opt_state) == "fused-flat"
    assert int(fused.step) == STEP + 2
    assert np.array_equal(np.asarray(jax.random.key_data(fused.rng)),
                          np.asarray(jax.random.key_data(ref.rng)))
    sd = state_dict_from_jax(_np(fused.params), _np(fused.sn_state))
    for k, v in state.model.state_dict().items():
        assert torch.equal(sd[k], v), k
    back = adamw_state_from_jax(_np(fused.params), fused.opt_state.count,
                                fused.opt_state.mu, fused.opt_state.nu,
                                state.model)
    for a, b in zip(back.mu + back.nu,
                    state.opt_state.mu + state.opt_state.nu):
        assert torch.equal(a, b)
    assert int(fused.opt_state.count) == STEP + 2
    assert int(fused.opt_state.notfinite) == 1
    tree = jax_restore(str(tmp_path / "ox"), jax_states["tree"])
    assert opt_layout(tree.opt_state) == "tree"
    mig = jax_states["migrate"](fused.opt_state, fused.params)
    for a, b in zip(jax.tree.leaves(tree.opt_state), jax.tree.leaves(mig)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    again = _port_state(seed=3)
    restore_checkpoint(str(tmp_path / "ox"), again)
    got = again.model.state_dict()
    for k, v in state.model.state_dict().items():
        assert torch.equal(got[k], v), k
    for a, b in zip(again.opt_state.mu, state.opt_state.mu):
        assert torch.equal(a, b)
    with pytest.raises(FileExistsError):
        orbax.export_state(str(tmp_path / "ox"), state)


def test_create_vit_weights_sources(saved, jax_states, tmp_path):
    """create_vit(weights=) from None, a .pth, a port checkpoint directory
    and an Orbax directory; a missing or unsupported source raises."""
    ref = jax_states["fused-flat"]
    want = state_dict_from_jax(_np(ref.params), _np(ref.sn_state))
    _, fresh = create_vit(CONFIG, seed=4, device="cpu")
    _, same = create_vit(CONFIG, seed=4, device="cpu", weights=None)
    got = same.state_dict()
    for k, v in fresh.state_dict().items():
        assert torch.equal(got[k], v)
    torch.save(want, tmp_path / "w.pth")
    state = _port_state()
    restore_checkpoint(saved["tree"], state)
    save_checkpoint(str(tmp_path / "pt"), state)
    for source in (str(tmp_path / "w.pth"), str(tmp_path / "pt"),
                   saved["fused-flat"], saved["tree"], saved["v1"]):
        _, model = create_vit(CONFIG, seed=4, device="cpu", weights=source)
        got = model.state_dict()
        for k in want:
            assert torch.equal(got[k], want[k]), (source, k)
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        create_vit(CONFIG, device="cpu", weights=str(tmp_path / "empty"))
    with pytest.raises(ValueError):
        create_vit(CONFIG, device="cpu", weights=str(tmp_path / "w.npz"))


def test_predictor_serves_an_orbax_dir(saved, jax_states):
    """Predictor.from_checkpoint(<Orbax dir>) against the JAX Predictor on
    the same weights, fp32, at tests/test_parity_torch.py's limits."""
    ref = jax_states["fused-flat"]
    p = Predictor.from_checkpoint(saved["fused-flat"], CONFIG, device="cpu",
                                  dtype=torch.float32)
    # The weights the JAX Predictor freezes, computed as one program.
    frozen, _ = jax.jit(normalize_tree, static_argnames="training")(
        ref.params, ref.sn_state, training=False)
    jp = JaxPredictor(get_config(CONFIG).model, frozen, ref.sn_state,
                      crop=get_config(CONFIG).crop, dtype=jnp.float32,
                      _prefrozen=True)
    images = np.random.default_rng(3).integers(0, 256, (2, 56, 56, 3),
                                               dtype=np.uint8)
    logits, _ = p.predict(images)
    want, _ = jp._predict(jp.params, jp.sn_state, jnp.asarray(images))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-5)


def test_trainer_resumes_a_jax_checkpoint_dir(saved, jax_states, tmp_path,
                                              capsys):
    """train_cls.main on a JAX run's checkpoint_dir resumes at its step,
    with its weights, and saves the JAX key in the port's checkpoint."""
    import shutil

    ckpt = tmp_path / "ckpt"
    shutil.copytree(saved["fused-flat"], ckpt)
    state = train_cls.main(["--config", CONFIG, "--max-steps", "1",
                            "--device", "cpu", f"checkpoint_dir={ckpt}",
                            "epochs=1", "dataset_root=synthetic",
                            "log_every=100"])
    assert f"resumed from step {STEP}" in capsys.readouterr().out
    assert state.step == STEP + 1 and state.opt_state.count == STEP + 1
    meta = checkpoint_meta(str(ckpt))
    assert meta["step"] == STEP + 1
    assert meta["jax_rng"] == state.jax_rng == [
        int(x) for x in np.asarray(jax.random.key_data(
            jax_states["fused-flat"].rng)).ravel()]


def test_missing_tensorstore_is_named(saved, monkeypatch):
    """Without tensorstore (the card's machine) an Orbax restore raises an
    ImportError that names it; the meta still reads."""
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(ImportError, match="tensorstore"):
        restore_checkpoint(saved["fused-flat"], _port_state())
    assert checkpoint_meta(saved["fused-flat"])["opt_layout"] == "fused-flat"


def test_orbax_round_trip_loads_no_jax(saved, tmp_path):
    """A process that reads an Orbax directory, imports it, exports it and
    reads the export back through the port loads no jax* and no
    calm_vit_dte_tpu* module."""
    code = (
        "import sys\n"
        "from calm_vit_dte_tpu_torch.compat import orbax\n"
        f"orbax.main(['import', {saved['tree']!r}, {str(tmp_path / 'pt')!r},"
        f" '--config', {CONFIG!r}])\n"
        f"orbax.main(['export', {str(tmp_path / 'pt')!r}, "
        f"{str(tmp_path / 'ox')!r}, '--config', {CONFIG!r}])\n"
        f"ck = orbax.read_orbax({str(tmp_path / 'ox')!r})\n"
        f"assert ck['step'] == {STEP}, ck['step']\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] == 'jax' or "
        "m.startswith('jax') or m.startswith('calm_vit_dte_tpu.') or "
        "m == 'calm_vit_dte_tpu')\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
