"""tools/reg_witness.py --init jax on the CPU: the reg protocol starts from
the JAX package's own initial weights, rebuilt from a table
(compat/jax_init.py), at tiny-reg."""

import torch

from _jax_init_table import build_table, jax_init_with_draws
from calm_vit_dte_tpu_torch.compat import jax_init
from calm_vit_dte_tpu_torch.compat.from_jax import state_dict_from_jax

torch.set_num_threads(1)


def test_reg_witness_starts_from_the_table(tmp_path, monkeypatch):
    """tools/reg_witness.py --init jax trains from the table's weights
    (tiny-reg, 2 steps on the CPU) and records the table it used."""
    from calm_vit_dte_tpu_torch.tools import reg_witness, train_proof

    params, sn_state, draws = jax_init_with_draws("tiny-reg", 0)
    path = tmp_path / "tables" / "tiny-reg_seed0.json.gz"
    path.parent.mkdir()
    jax_init.write_table(build_table("tiny-reg", 0, params, sn_state, draws),
                         path)
    monkeypatch.setattr(jax_init, "TABLES", path.parent)
    built = []
    create_vit = train_proof.create_vit

    def recording_create_vit(*args, **kwargs):
        cfg, model = create_vit(*args, **kwargs)
        built.append({k: v.clone() for k, v in model.state_dict().items()})
        return cfg, model

    monkeypatch.setattr(train_proof, "create_vit", recording_create_vit)
    out = reg_witness.run([
        "--init", "jax", "--config", "tiny-reg", "--device", "cpu",
        "--steps", "2", "--batch", "8", "--n-train", "16", "--eval-every",
        "2", "--corpus-size", "64", "--root", str(tmp_path / "corpus"),
        "--out", str(tmp_path / "out")])
    assert out["init"] == "jax" and out["route"] == "kernels"
    assert out["jax_init_table"]["file"] == path.name
    assert len(out["step_losses"]) == 2
    assert len(built) == 1
    want = state_dict_from_jax(params, sn_state)
    for k, v in want.items():
        assert torch.equal(built[0][k], v), k
