"""The reg proof's trajectory against the JAX package's over 30 steps at
tiny-reg on the CPU, with the augmentation inside the step (the proof's
protocol; tests/_reg_trajectory_jax.py runs it, and for 400 steps as a
script)."""

import jax
import numpy as np
import torch

from _reg_trajectory_jax import trajectory

torch.set_num_threads(1)


def test_reg_proof_trajectory_follows_jax_with_the_augmentation(tmp_path):
    """The proof's reg protocol with the augmentation inside the step
    (tests/_reg_trajectory_jax.py): the JAX package's jitted step, and the
    port's step fed JAX's jitted augmentation for the same key, take the
    same 30 batches after a carried first step; every step's loss at
    rtol 2e-4 and the final parameters at tests/test_parity_grad.py's
    limits."""
    jl, pl, jparams, pparams = trajectory(tmp_path / "corpus", 30, "jax",
                                          n_train=32)
    np.testing.assert_allclose(pl, jl, rtol=2e-4)
    assert jl[-10:].mean() < 0.6 * jl[:10].mean()      # it learns
    for (path, got), (_, want) in zip(
            jax.tree_util.tree_leaves_with_path(pparams),
            jax.tree_util.tree_leaves_with_path(jparams)):
        np.testing.assert_allclose(
            got, want, rtol=1e-3, atol=5e-4 * max(np.abs(want).max(), 1e-12),
            err_msg=jax.tree_util.keystr(path))
