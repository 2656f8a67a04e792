"""Data and tensor parallelism (parallel/mesh.py through train/step.py)
against the port's single process at tiny-cls on the CPU, and the
tensor-parallel rule against the JAX package's.

One launch of four gloo ranks (tools/parallel_step.py, one process each,
OMP_NUM_THREADS=1) runs the multi-process cases while this process
computes the single-process references. Limits:
  * DP (4x1) against one process on the same global batch:
    tests/test_sharding.py:58-66 (loss rtol 1e-5, params rtol 3e-3 /
    atol 3e-5); the preprocessed global batch bit for bit; every rank's
    final state bit for bit;
  * TP (2x2) against DP: tests/test_sharding.py:126-132 (loss rtol 1e-5,
    params rtol 3e-3 / atol 3e-4).
The comparison with the JAX package's GSPMD step is
tests/test_torch_parallel_jax.py.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_parallel_runs import (
    BATCH,
    COMMON,
    assert_ranks_identical,
    assert_state_close,
    carry_state,
    cutmix_then_mixup_seed,
    four_ranks,
    losses,
    rank_runs,
)

from calm_vit_dte_tpu.models.vit import ViTConfig as JViTConfig
from calm_vit_dte_tpu.models.vit import vit_init
from calm_vit_dte_tpu.parallel.mesh import make_mesh as jax_make_mesh
from calm_vit_dte_tpu.parallel.mesh import (
    param_shardings as jax_param_shardings,
)
from calm_vit_dte_tpu_torch.compat.from_jax import jax_path
from calm_vit_dte_tpu_torch.models.vit import ViT
from calm_vit_dte_tpu_torch.parallel.mesh import param_shardings
from calm_vit_dte_tpu_torch.tools import parallel_step as ps
from calm_vit_dte_tpu_torch.utils.configs import TINY_VIT, get_config

# One intra-op thread: the suite runs several worker processes per machine.
torch.set_num_threads(1)


def _microbatch_order(data: int, k: int) -> list[int]:
    """The global rows in the order the DP step groups them: microbatch i
    is every data rank's i-th slice, rank by rank."""
    b = BATCH // data
    return [d * b + i * (b // k) + j for i in range(k) for d in range(data)
            for j in range(b // k)]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("parallel")
    carried = carry_state(out / "carried")
    pre = dict(COMMON, name="pre", steps=2, preprocess=True,
               state_seed=cutmix_then_mixup_seed(), meshes=[[4, 1], [2, 2]])
    # The microbatch grouping (ROADMAP, recorded divergences).
    micro = dict(COMMON, name="micro", steps=1, preprocess=True,
                 microbatches=2, restore=carried, meshes=[[4, 1]])
    order = _microbatch_order(4, micro["microbatches"])

    def grouped(preprocess):
        return lambda g, b: {k: v[order] for k, v in
                             preprocess(g, b).items()}

    cpu = torch.device("cpu")
    with four_ranks([pre, micro], out) as res:
        res["single"] = {
            "pre": ps.run_one(pre, None, cpu),
            "micro": ps.run_one(micro, None, cpu),
            "micro_grouped": ps.run_one(micro, None, cpu, grouped),
        }
    return res


def test_tp_rule_matches_jax_on_tiny_and_counts_the_flagship():
    """(a) tiny-cls at min_shard_dim 64: the port's sharded parameters are
    the JAX rule's (make_mesh(4, 2)) through the name bridge, 108 weights;
    the flagship's shapes at 512: 59 weights, 26,535,936 of its
    42,577,130 elements."""
    jcfg = JViTConfig(**{f: getattr(TINY_VIT, f) for f in (
        "heads", "seq_length", "in_features", "dim_step", "mean_var_hidden",
        "seq_len_step", "seq_len_reduce", "out_features", "generate")})
    params, _ = vit_init(jcfg, jax.random.PRNGKey(0))
    jsh = jax_param_shardings(jax_make_mesh(4, 2), params, min_shard_dim=64)
    want = {tuple(getattr(k, "key", k) for k in path)
            for path, s in jax.tree_util.tree_leaves_with_path(jsh)
            if s.spec and s.spec[0] == "model"}
    model = ViT(TINY_VIT, torch.Generator().manual_seed(0))
    got = {tuple(jax_path(n)[1]) for n, spec in
           param_shardings(model, 64).items() if spec}
    assert got == want and len(got) == 108

    with torch.device("meta"):
        flagship = ViT(get_config("imagenet-cls-224").model,
                       torch.Generator())
    sizes = {n: p.numel() for n, p in flagship.named_parameters()}
    sharded = [n for n, spec in param_shardings(flagship).items() if spec]
    assert len(sharded) == 59
    assert sum(sizes[n] for n in sharded) == 26_535_936
    assert sum(sizes.values()) == 42_577_130


def test_dp_step_matches_the_single_process_step(results):
    """(b) 4x1 with augmentation, CutMix (step 1) and MixUp (step 2)."""
    single = results["single"]["pre"]
    recs = rank_runs(results, "pre", "4x1")
    np.testing.assert_allclose(losses(recs[0]), losses(single), rtol=1e-5)
    for step in range(2):
        for key in ("image", "label"):
            gathered = torch.cat([r["preprocessed"][step][key]
                                  for r in recs])
            assert torch.equal(gathered, single["preprocessed"][step][key])
    assert_state_close(recs[0], single, rtol=3e-3, atol=3e-5)
    assert_ranks_identical(recs)
    assert recs[0]["counters"] == single["counters"] == {
        "step": 2, "count": 2, "notfinite": 0}


def test_tp_step_matches_the_dp_step(results):
    """(c) 2x2 (tp_min_shard_dim 64) against 4x1; each rank stores half
    the rows of every sharded weight and of its moments."""
    dp = rank_runs(results, "pre", "4x1")[0]
    recs = rank_runs(results, "pre", "2x2")
    np.testing.assert_allclose(losses(recs[0]), losses(dp), rtol=1e-5)
    assert_state_close(recs[0], dp, rtol=3e-3, atol=3e-4)
    assert_ranks_identical(recs)
    stored = recs[0]["stored"]
    assert len(stored["sharded"]) == 108
    for name, (local, full) in stored["sharded"].items():
        assert local == [full[0] // 2, *full[1:]], name
        assert stored["moment_shapes"][name] == local, name
    saved = sum(np.prod(full) // 2 for _, full in stored["sharded"].values())
    assert dp["stored"]["params"] - stored["params"] == 4 * saved
    assert dp["stored"]["moments"] - stored["moments"] == 8 * saved


def test_dp_microbatches_group_each_ranks_rows(results):
    """microbatches=2 on 4x1 splits each rank's rows: it equals the single
    process on the global batch grouped rank by rank (after the
    preprocessing), not on the batch as it is (the JAX grouping)."""
    rec = rank_runs(results, "micro", "4x1")[0]
    grouped = results["single"]["micro_grouped"]
    plain = results["single"]["micro"]
    np.testing.assert_allclose(losses(rec), losses(grouped), rtol=1e-5)
    assert_state_close(rec, grouped, rtol=3e-3, atol=3e-5)
    # The grouping decides which noise rows meet which images.
    assert abs(losses(rec)[0] - losses(plain)[0]) > 1e-4


def test_excess_names_the_worst_element():
    """`parallel_step.excess` reports the tensor, flat index and both values
    of the element furthest past rtol / atol, and how far past it is."""
    want = {"state": {"a": torch.tensor([1.0, -2.0, 0.0]),
                      "b": torch.tensor([[10.0, 0.0], [0.0, 4.0]])}}
    got = {"state": {"a": torch.tensor([1.0, -2.1, 0.0]),
                     "b": torch.tensor([[10.0, 0.0], [0.0, 4.5]])}}
    worst = ps.excess(got, want, 1e-2, 1e-3)
    assert (worst["tensor"], worst["index"], worst["got"], worst["want"]) \
        == ("b", 3, 4.5, 4.0)
    assert worst["excess"] == pytest.approx(0.5 - (1e-3 + 1e-2 * 4.0))
    assert ps.excess(want, want, 1e-2, 1e-3)["excess"] < 0
