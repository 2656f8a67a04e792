"""The port's training and eval steps against the JAX package's at
tiny-reg, compared after each of 10 steps (tests/_train_step_jax.py; the
tiny-cls case is tests/test_torch_train_step_jax.py)."""

import pytest
import torch

from _train_step_jax import three_steps_match_jax_on_carried_state

# One intra-op thread: the suite runs several worker processes per machine,
# and a torch thread pool per worker oversubscribes the cores.
torch.set_num_threads(1)


@pytest.mark.parametrize("task,steps", [("reg", 10)])
def test_three_steps_match_jax_on_carried_state(task, steps):
    three_steps_match_jax_on_carried_state(task, steps)
