"""The training step as a whole at the tiny config (S=48, fp32, CPU): the
port's `make_train_step` against the committed reference trajectory, then
the step's own contracts (microbatches, remat, resume).
tests/test_torch_train_step_jax.py holds it against the JAX package's step.

Limits are those of tests/test_parity_grad.py: losses rtol 2e-4, grad norms
rtol 2e-3, final parameters rtol 1e-3 / atol 5e-4 of the leaf's largest
value, u/v rtol 5e-3 / atol 2e-3 of it.
"""

import copy
import pathlib

import numpy as np
import pytest
import torch

from calm_vit_dte_tpu_torch.models.vit import ViT
from calm_vit_dte_tpu_torch.ops.variational import noise_override
from calm_vit_dte_tpu_torch.train.optim import FusedAdamW, make_optimizer
from calm_vit_dte_tpu_torch.train.state import TrainState, create_train_state
from calm_vit_dte_tpu_torch.train.step import make_train_step
from calm_vit_dte_tpu_torch.utils.configs import TINY_VIT

# One intra-op thread: the suite runs several worker processes per machine,
# and a torch thread pool per worker oversubscribes the cores.
torch.set_num_threads(1)

GOLDEN = pathlib.Path(__file__).parent / "golden"
OPT = dict(base_lr=3.1e-3, weight_decay=0.02, b1=0.9, b2=0.98, epochs=5,
           steps_per_epoch=2, clip_norm=1.0)
F32 = torch.float32


class NoiseSeq:
    """Call n returns standard normal noise from seed 1000 + n."""

    def __init__(self, start=0):
        self.i = start

    def __call__(self, shape):
        arr = np.random.default_rng(1000 + self.i).standard_normal(shape)
        self.i += 1
        return arr.astype(np.float32)


def _model(state_dict=None) -> ViT:
    model = ViT(TINY_VIT, torch.Generator().manual_seed(0))
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return model


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


class Capture(FusedAdamW):
    """Records the gradients the step hands the optimizer; no update."""

    def __init__(self):
        pass

    def init(self, params):
        return None

    def update(self, params, grads, state):
        self.grads = [g.clone() for g in grads]


class _Gnorm:
    gnorm = 0.0


def _capture_state(model) -> TrainState:
    return TrainState(model=model, opt_state=_Gnorm(), step=0, seed=3)


def test_trajectory_matches_the_reference_golden():
    """Ten optimizer steps from the reference's initial state dict: losses,
    pre-clip grad norms, final parameters and final u/v of the committed
    torch AdamW + clip + per-epoch cosine trajectory."""
    d = np.load(GOLDEN / "grad_traj_cls_tiny.npz")
    sd0 = {k[3:]: torch.from_numpy(d[k]) for k in d.files
           if k.startswith("sd/")}
    sdF = {k[4:]: d[k] for k in d.files if k.startswith("sdF/")}
    model = _model(sd0)
    tx = make_optimizer(**OPT)
    state = create_train_state(model, tx, seed=3)
    step = make_train_step(TINY_VIT, tx, "cls", dtype=F32, remat=False)
    batch = {"image": d["in/x"].transpose(0, 2, 3, 1),   # NCHW -> NHWC
             "label": d["in/targets"]}
    losses, gnorms = [], []
    seq = NoiseSeq()
    with noise_override(seq):
        for _ in range(10):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
    assert seq.i == int(d["out/noise_count"])
    np.testing.assert_allclose(losses, d["out/losses"], rtol=2e-4)
    np.testing.assert_allclose(gnorms, d["out/gnorms"], rtol=2e-3)
    got = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    uv = {k for k in sdF if k.endswith(("weight_u", "weight_v"))}
    assert_leaves_close({k: got[k] for k in sdF if k not in uv},
                        {k: sdF[k] for k in sdF if k not in uv}, 1e-3, 5e-4,
                        "final params")
    assert_leaves_close({k: got[k] for k in uv}, {k: sdF[k] for k in uv},
                        5e-3, 2e-3, "final u/v")


@pytest.fixture(scope="module")
def warm_model():
    """A tiny model with converged u/v (raw-init sigma overflows)."""
    from calm_vit_dte_tpu_torch.nn.spectral_norm import normalize_tree
    model = _model()
    with torch.no_grad():
        for _ in range(30):
            normalize_tree(model, training=True)
    return model


def _grads(model, batch, *, start=0, **kw):
    """The gradients one train step computes, under injected noise from
    call `start` on; the model is a copy, so u/v updates do not leak."""
    cap = Capture()
    model = copy.deepcopy(model)
    step = make_train_step(TINY_VIT, cap, "cls", dtype=F32, **kw)
    seq = NoiseSeq(start)
    with noise_override(seq):
        _, m = step(_capture_state(model), batch)
    return cap.grads, m, seq.i - start, model


def test_microbatches_equal_the_mean_of_half_batch_gradients(warm_model):
    batch = _batch(4, seed=1)
    halves = [{k: v[:2] for k, v in batch.items()},
              {k: v[2:] for k, v in batch.items()}]
    g0, m0, n, _ = _grads(warm_model, halves[0], remat=False)
    g1, m1, _, _ = _grads(warm_model, halves[1], start=n, remat=False)
    g, m, drawn, model = _grads(warm_model, batch, remat=False,
                                microbatches=2)
    assert drawn == 2 * n          # a distinct noise stream per microbatch
    for a, b0, b1 in zip(g, g0, g1):
        torch.testing.assert_close(a, (b0 + b1) / 2, rtol=1e-4,
                                   atol=1e-6 * float(a.abs().max()) + 1e-12)
    for name in ("loss", "accuracy", "kl"):
        np.testing.assert_allclose(float(m[name]),
                                   (float(m0[name]) + float(m1[name])) / 2,
                                   rtol=1e-5)
    # u/v took ONE power iteration, not one per microbatch.
    once = copy.deepcopy(warm_model)
    from calm_vit_dte_tpu_torch.nn.spectral_norm import normalize_tree
    with torch.no_grad():
        normalize_tree(once, training=True)
    for (k, a), (_, b) in zip(model.named_buffers(), once.named_buffers()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)


def test_remat_equals_no_remat(warm_model):
    batch = _batch(2, seed=2)
    g, m, n, _ = _grads(warm_model, batch, remat=False)
    gr, mr, nr, _ = _grads(warm_model, batch, remat=True)
    assert nr == n     # the replay reuses the first run's noise
    assert float(mr["loss"]) == float(m["loss"])
    for a, b in zip(gr, g):
        torch.testing.assert_close(a, b, rtol=1e-5,
                                   atol=1e-7 * float(b.abs().max()) + 1e-12)


def test_batch_not_divisible_by_microbatches_raises(warm_model):
    step = make_train_step(TINY_VIT, Capture(), "cls", dtype=F32,
                           microbatches=3)
    with pytest.raises(ValueError, match="not divisible"):
        step(_capture_state(copy.deepcopy(warm_model)), _batch(4))
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(TINY_VIT, Capture(), "cls", microbatches=0)
    with pytest.raises(ValueError):
        make_train_step(TINY_VIT, Capture(), "seg")


def test_resume_from_seed_and_step_reproduces_the_noise(warm_model):
    """Noise comes from a generator seeded by (seed, step, stream): a state
    rebuilt at step 1 takes the step the uninterrupted run took."""
    tx = make_optimizer(**OPT)
    step = make_train_step(TINY_VIT, tx, "cls", dtype=F32, remat=True)
    batch = _batch(2, seed=4)
    state = create_train_state(copy.deepcopy(warm_model), tx, seed=11)
    state, m1 = step(state, batch)
    resumed = TrainState(model=copy.deepcopy(state.model),
                         opt_state=copy.deepcopy(state.opt_state), step=1,
                         seed=11)
    state, m2 = step(state, batch)
    resumed, r2 = step(resumed, batch)
    assert float(r2["loss"]) == float(m2["loss"])
    assert float(m2["loss"]) != float(m1["loss"])
    for a, b in zip(state.model.parameters(), resumed.model.parameters()):
        assert torch.equal(a, b)
    a, b, c = (torch.randn(4, generator=TrainState(
        state.model, None, step=at, seed=11).generator(0))
        for at in (5, 5, 6))
    assert torch.equal(a, b) and not torch.equal(a, c)
