"""Shared by tests/test_torch_parallel.py and tests/test_torch_parallel_jax
.py: the runs of tools/parallel_step.py at tiny-cls, the carried state
they start from, and one launch of four gloo ranks that runs them while
the test process computes its references."""

import json
from contextlib import contextmanager

import numpy as np
import torch

from _train_step_jax import OPT

from calm_vit_dte_tpu_torch.data.mixup import draw_mix_params
from calm_vit_dte_tpu_torch.tools import parallel_step as ps
from calm_vit_dte_tpu_torch.train.state import TrainState

BATCH = 8
WORLD = 4
COMMON = {"config": "tiny-cls", "batch": BATCH, "min_shard_dim": 64}
assert ps.OPT == OPT   # the runs' optimizer is the JAX parity tests'



def cutmix_then_mixup_seed() -> int:
    """A TrainState seed whose preprocessing draws CutMix at step 0 and
    MixUp at step 1."""
    def cutmix(seed, step):
        gen = TrainState(model=torch.nn.Linear(1, 1), opt_state=None,
                         step=step, seed=seed).generator(1)
        return draw_mix_params(gen, 48, 48)["cutmix"]

    return next(s for s in range(100) if cutmix(s, 0) and not cutmix(s, 1))


def carry_state(path) -> str:
    """The state the comparisons start from (tools/parallel_step.py::
    carry_state): the protocol of tests/_train_step_jax.py, u/v converged
    (tests/_sn_warmup.py's 30 power iterations) and one step taken under
    injected noise."""
    return ps.carry_state(dict(COMMON, state_seed=3), str(path),
                          torch.device("cpu"))


@contextmanager
def four_ranks(runs: list[dict], out):
    """Start the runs on four gloo ranks (OMP_NUM_THREADS=1); the body
    runs meanwhile; on exit wait for them (120 s each) and set
    `results["ranks"]` to {"<name>_<DxM>_rank<r>": record}."""
    spec_path = out / "spec.json"
    spec_path.write_text(json.dumps({
        "out": str(out), "device": "cpu", "timeout_s": 60, "runs": runs}))
    procs = ps.spawn(str(spec_path), WORLD, env={"OMP_NUM_THREADS": "1"})
    results: dict = {}
    try:
        yield results
    finally:
        ps.collect(procs, timeout=120)
    results["ranks"] = {p.name[:-3]: torch.load(p, weights_only=False)
                        for p in out.glob("*_rank*.pt")}


def rank_runs(results, name, layout):
    return [results["ranks"][f"{name}_{layout}_rank{r}"]
            for r in range(WORLD)]


def losses(rec):
    return [m["loss"] for m in rec["metrics"]]


def assert_state_close(got, want, rtol, atol):
    for name, w in want["state"].items():
        np.testing.assert_allclose(got["state"][name].numpy(), w.numpy(),
                                   rtol=rtol, atol=atol, err_msg=name)


def assert_ranks_identical(recs):
    for rec in recs[1:]:
        for name, t in recs[0]["state"].items():
            assert torch.equal(rec["state"][name], t), name
        for a, b in zip(recs[0]["mu"] + recs[0]["nu"], rec["mu"] + rec["nu"]):
            assert torch.equal(a, b)
        assert rec["metrics"] == recs[0]["metrics"]
