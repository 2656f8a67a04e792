"""Writes the table from which calm_vit_dte_tpu_torch/compat/jax_init.py
rebuilds the JAX package's initial weights without jax.

It runs the JAX package's own `create_vit(config, seed=seed)` with
`calm_vit_dte_tpu.nn.init._np_rng` wrapped, so that each draw's key data and
distribution are recorded (the JAX package itself is not edited). Every
entry of the port's state_dict of the result (`compat/from_jax.py::
state_dict_from_jax`) is then matched to the recorded draw whose redraw
(`compat/jax_init.py::draw`) has the same float32 bytes; keys are distinct,
so the match is unambiguous, and every draw must be matched once. Leaves no
draw made are `ones`, `zeros` or kept as values (the RoPE frequencies).

    python tests/_jax_init_table.py --config imagenet-reg-224 --seed 0

writes calm_vit_dte_tpu_torch/compat/jax_init/imagenet-reg-224_seed0.json.gz.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import pathlib
import sys

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from calm_vit_dte_tpu.models.factory import create_vit  # noqa: E402
from calm_vit_dte_tpu.nn import init as vinit  # noqa: E402
from calm_vit_dte_tpu_torch.compat import jax_init  # noqa: E402
from calm_vit_dte_tpu_torch.compat.from_jax import (  # noqa: E402
    state_dict_from_jax,
)

SN_EPS = 1e-12         # calm_vit_dte_tpu/nn/init.py::normalized_normal's


class _Recorder:
    """Stands in for the generator `_np_rng` returns and records each draw:
    the key data, the distribution and the shape."""

    def __init__(self, key, draws: list):
        self.key = [int(k) for k in np.asarray(
            jax.random.key_data(key)).astype(np.uint32).ravel()]
        self.rng = jax_init.key_rng(self.key)
        self.draws = draws

    def uniform(self, low, high, size):
        if low != -high:
            raise ValueError(f"uniform({low}, {high}) is not symmetric")
        self.draws.append({"init": "uniform", "bound": float(high),
                           "key": self.key, "shape": list(size)})
        return self.rng.uniform(low, high, size)

    def standard_normal(self, size):
        self.draws.append({"init": "normalized_normal", "eps": SN_EPS,
                           "key": self.key, "shape": list(size)})
        return self.rng.standard_normal(size)


@contextlib.contextmanager
def recording(draws: list):
    saved = vinit._np_rng
    vinit._np_rng = lambda key: _Recorder(key, draws)
    try:
        yield
    finally:
        vinit._np_rng = saved


def jax_init_with_draws(config: str, seed: int):
    """The JAX package's (params, sn_state) of `config` at `seed`, and the
    draws that made them."""
    draws: list = []
    with recording(draws):
        _, params, sn_state = create_vit(config, seed=seed)
    return params, sn_state, draws


def build_table(config: str, seed: int, params, sn_state,
                draws: list) -> dict:
    """Match every entry of the port's state_dict of (params, sn_state) to
    its draw or constant; raises on an entry nothing explains or a draw no
    entry took."""
    by_digest: dict = {}
    for d in draws:
        by_digest.setdefault(jax_init.digest(jax_init.draw(
            dict(d, name="?"))), []).append(d)
    if any(len(v) > 1 for v in by_digest.values()):
        raise ValueError("two draws gave the same values")
    leaves, used, values = [], set(), {}
    sd = state_dict_from_jax(params, sn_state)
    for name in sorted(sd):
        arr = sd[name].numpy()
        sha = jax_init.digest(arr)
        entry = {"name": name, "shape": list(arr.shape), "sha": sha}
        if sha in by_digest:
            entry.update(by_digest[sha][0])
            used.add(sha)
        elif (arr == 1).all():
            entry["init"] = "ones"
        elif (arr == 0).all():
            entry["init"] = "zeros"
        elif name.endswith("inv_freq"):
            entry["init"] = "values"
            values[sha] = [float(x) for x in arr.ravel()]
        else:
            raise ValueError(f"{name}: no draw or constant gives it")
        if jax_init.digest(jax_init.draw(entry, values)) != sha:
            raise ValueError(f"{name}: its {entry['init']} redraw differs")
        leaves.append(entry)
    if len(used) != len(by_digest):
        raise ValueError(f"{len(by_digest) - len(used)} draws match no "
                         "leaf")
    return {"format": jax_init.FORMAT, "config": config, "seed": seed,
            "jax_version": jax.__version__,
            "jax_threefry_partitionable":
                bool(jax.config.jax_threefry_partitionable),
            "numpy_version": np.__version__, "draws": len(draws),
            "numel": int(sum(np.prod(e["shape"]) for e in leaves)),
            "values": values, "leaves": leaves}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default="imagenet-reg-224")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    out = args.out or jax_init.table_path(args.config, args.seed)
    table = build_table(args.config, args.seed,
                        *jax_init_with_draws(args.config, args.seed))
    jax_init.write_table(table, out)
    print(f"{out}: {len(table['leaves'])} entries, {table['draws']} draws, "
          f"{table['numel']} values, jax {table['jax_version']}, "
          f"threefry_partitionable {table['jax_threefry_partitionable']}")


if __name__ == "__main__":
    main()
