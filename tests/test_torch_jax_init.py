"""The JAX package's initial weights rebuilt in the port without jax
(compat/jax_init.py): the committed imagenet-reg-224 seed-0 table equals
one written now from the JAX package's own init, the rebuilt state_dict is
bit-identical to the JAX package's `create_vit` carried through
`state_dict_from_jax` (at tiny-reg from a table written here, and at
imagenet-reg-224 from the committed table), and a wrong digest raises."""

import numpy as np
import pytest
import torch

from _jax_init_table import build_table, jax_init_with_draws
from calm_vit_dte_tpu_torch.compat import jax_init
from calm_vit_dte_tpu_torch.compat.from_jax import state_dict_from_jax
from calm_vit_dte_tpu_torch.models.vit import ViT
from calm_vit_dte_tpu_torch.utils.configs import get_config

torch.set_num_threads(1)

FLAGSHIP = "imagenet-reg-224"


@pytest.fixture(scope="module")
def flagship():
    """imagenet-reg-224 at seed 0 from the JAX package, with its draws."""
    return jax_init_with_draws(FLAGSHIP, 0)


@pytest.fixture(scope="module")
def tiny_table(tmp_path_factory):
    """tiny-reg at seed 0 from the JAX package, and its table written to a
    directory of its own."""
    params, sn_state, draws = jax_init_with_draws("tiny-reg", 0)
    path = tmp_path_factory.mktemp("jax_init") / "tiny-reg_seed0.json.gz"
    jax_init.write_table(build_table("tiny-reg", 0, params, sn_state, draws),
                         path)
    return params, sn_state, path


def test_committed_table_equals_a_rewrite(flagship):
    """The committed table is the one the JAX package's init gives now, and
    names the jax version and threefry mode it was written under."""
    committed = jax_init.load_table(jax_init.table_path(FLAGSHIP, 0))
    rewritten = build_table(FLAGSHIP, 0, *flagship)
    assert committed == rewritten
    assert committed["draws"] == 966 and len(committed["leaves"]) == 1119
    assert committed["jax_threefry_partitionable"] is True


def _assert_rebuilt(sd, params, sn_state, config):
    want = state_dict_from_jax(params, sn_state)
    assert set(sd) == set(want)
    for k, v in want.items():
        assert sd[k].dtype == torch.float32
        assert torch.equal(sd[k], v), k
    model = ViT(get_config(config).model, torch.Generator().manual_seed(1))
    model.load_state_dict(sd)   # strict: every entry of the port's model


@pytest.mark.parametrize("config", ["tiny-reg", FLAGSHIP])
def test_rebuild_is_bit_identical(config, flagship, tiny_table):
    if config == FLAGSHIP:
        params, sn_state, _ = flagship
        path = jax_init.table_path(FLAGSHIP, 0)
    else:
        params, sn_state, path = tiny_table
    _assert_rebuilt(jax_init.state_dict_from_jax_init(path), params,
                    sn_state, config)


def test_a_wrong_digest_or_key_raises(tmp_path):
    """A redraw that misses the table's digest raises, naming the entry:
    here a changed digest, and a changed key (which a numpy with another
    stream amounts to)."""
    table = jax_init.load_table(jax_init.table_path(FLAGSHIP, 0))
    drawn = next(e for e in table["leaves"]
                 if "key" in e and np.prod(e["shape"]) < 64)
    for field in ("sha", "key"):
        entry = dict(drawn)
        if field == "sha":
            entry["sha"] = "0" * 16
        else:
            entry["key"] = [entry["key"][0], entry["key"][1] ^ 1]
        path = tmp_path / f"{field}.json.gz"
        jax_init.write_table(dict(table, leaves=[entry]), path)
        with pytest.raises(ValueError, match=entry["name"]):
            jax_init.state_dict_from_jax_init(path)

