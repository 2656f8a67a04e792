"""The port's int8 serving path (quantize.py and the quantized SNLinear)
against the JAX package's quantize.py, on the CPU.

Weights start from a JAX tiny init; the spectral-norm power iteration is
converged in the port (the 30 warm-up iterations of Predictor.fresh) and
the u/v vectors are carried back, so both packages serve the same weights.
The JAX forward costs a compile of about 7 s per (config, mode) here, so
it is compared on tiny-cls in both modes; tiny-reg is held against the
port's own bf16 forward.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calm_vit_dte_tpu import quantize as jq
from calm_vit_dte_tpu.compat.torch_export import _rename_back
from calm_vit_dte_tpu.models.factory import create_vit as jax_create_vit
from calm_vit_dte_tpu.nn.spectral_norm import normalize_tree as jax_normalize
from calm_vit_dte_tpu.serve import Predictor as JaxPredictor
from calm_vit_dte_tpu_torch import quantize as tq
from calm_vit_dte_tpu_torch.compat.from_jax import state_dict_from_jax
from calm_vit_dte_tpu_torch.models.factory import create_vit
from calm_vit_dte_tpu_torch.nn.spectral_norm import SpectralNormed, freeze
from calm_vit_dte_tpu_torch.serve import WARMUP_POWER_ITERATIONS, Predictor
from calm_vit_dte_tpu_torch.utils.configs import get_config

torch.set_num_threads(1)

MODES = {"int8": "w8a8", "int8-wo": "w8a16"}


_jax_freeze = jax.jit(lambda p, s: jax_normalize(p, s, training=False)[0])
_jax_quantize = jax.jit(jq.quantize_tree, static_argnames="mode")


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 unit in the last place at each value (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def test_quantize_weight_matches_jax():
    w = np.random.default_rng(0).normal(size=(48, 96)).astype(np.float32)
    w[3] = 0.0                                  # an all-zero row
    wq, ws = tq.quantize_weight(torch.from_numpy(w))
    jwq, jws = jq.quantize_weight(jnp.asarray(w))
    assert wq.dtype == torch.int8 and ws.shape == (48,)
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq))
    np.testing.assert_allclose(ws.numpy(), np.asarray(jws), rtol=1e-6)


_SEQ = {"qdot": False, "qdot_wo": False, "qdot_seq": True,
        "qdot_seq_wo": True}


@pytest.mark.parametrize("name", list(_SEQ))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qdot_matches_jax(name, dtype):
    """Each quantized product against the JAX package's on the same numpy
    inputs: within one bf16 ulp in bf16; in fp32 rtol 1e-6, with an atol of
    1e-6 of the largest value (the weight-only products sum in fp32 in
    another order than XLA's, so outputs near zero differ in the last
    bits)."""
    rng = np.random.default_rng(len(name))
    x = rng.normal(size=(4, 32, 96)).astype(np.float32)
    w = rng.normal(size=(24, 32) if _SEQ[name] else (48, 96)).astype(
        np.float32)
    b = rng.normal(size=(48,)).astype(np.float32)
    jwq, jws = jq.quantize_weight(jnp.asarray(w))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx, tx = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    twq, tws = torch.from_numpy(np.array(jwq)), torch.from_numpy(
        np.array(jws))
    extra_j, extra_t = ((), ()) if _SEQ[name] else (
        (jnp.asarray(b),), (torch.from_numpy(b),))
    want = np.asarray(getattr(jq, name)(jx, jwq, jws, *extra_j, dtype=jdt)
                      .astype(jnp.float32))
    got = getattr(tq, name)(tx, twq, tws, *extra_t, dtype=tdt)
    assert got.dtype == tdt and got.shape == want.shape
    got = got.float().numpy()
    if dtype == "bfloat16":
        assert (np.abs(got - want) <= _bf16_ulp(want)).all()
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())


def _sn_paths(sn_state, path=()):
    """(JAX path, port module name) of every spectral-normed layer."""
    if isinstance(sn_state, dict) and "u" in sn_state and "v" in sn_state:
        yield path, ".".join(_rename_back(list(path)))
        return
    for key, sub in sn_state.items():
        yield from _sn_paths(sub, path + (key,))


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


@functools.lru_cache(maxsize=None)
def _carried(config):
    """JAX tiny init; the port's model on the same weights with its power
    iteration converged; the JAX (params, sn_state) with those u/v."""
    _, params, sn_state = jax_create_vit(config, seed=0)
    params = jax.tree.map(np.asarray, params)
    sn_state = jax.tree.map(np.asarray, sn_state)
    _, model = create_vit(config, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, sn_state))
    from calm_vit_dte_tpu_torch.nn.spectral_norm import normalize_tree

    with torch.no_grad():
        for _ in range(WARMUP_POWER_ITERATIONS):
            normalize_tree(model, training=True)
    mods = dict(model.named_modules())
    for path, name in _sn_paths(sn_state):
        node = _at(sn_state, path)
        node["u"] = mods[name].weight_u.numpy().copy()
        node["v"] = mods[name].weight_v.numpy().copy()
    return params, sn_state, model


def test_quantize_model_matches_quantize_tree():
    """quantize_model quantizes exactly the layers quantize_tree does, to
    the same int8 values and scales, and skips the attention mask MLP. The
    port is handed the JAX package's frozen weights (its own normalize pass
    differs from JAX's in the last bit of some weights, which can move a
    value across an int8 rounding boundary)."""
    params, sn_state, model = _carried("tiny-cls")
    frozen = _jax_freeze(params, sn_state)
    qtree = _jax_quantize(frozen, sn_state, mode="w8a8")
    _, port = create_vit("tiny-cls", device="cpu")
    mods = dict(port.named_modules())
    for path, name in _sn_paths(sn_state):
        w = torch.from_numpy(np.array(_at(frozen, path)["w"]))
        mods[name].weight_frozen = w.reshape(mods[name].weight_orig.shape)
    done = tq.quantize_model(port, "w8a8")
    jax_done = {name for path, name in _sn_paths(sn_state)
                if "w_q" in _at(qtree, path)}
    assert set(done) == jax_done and len(done) > 10
    assert not any("linear_mask" in n for n in done)
    for path, name in _sn_paths(sn_state):
        m, node = mods[name], _at(qtree, path)
        if name in jax_done:
            np.testing.assert_array_equal(m.w_q.numpy(),
                                          np.asarray(node["w_q"]))
            np.testing.assert_allclose(m.w_s.numpy(), np.asarray(node["w_s"]),
                                       rtol=1e-6)
            assert m.weight_frozen is None and m.w_so is None
        else:
            assert m.weight_frozen is not None and "w" in node
    # Weight-only mode: the same int8 weights, the scale under w_so.
    _, port16 = create_vit("tiny-cls", device="cpu")
    freeze(port16)
    tq.quantize_model(port16, "w8a16")
    head = port16.head["0"]
    assert head.w_so is not None and head.w_s is None
    with pytest.raises(ValueError, match="unknown quantize_model mode"):
        tq.quantize_model(port16, "int4")


def _jax_logits(config, quantize, params, sn_state, images):
    """The JAX package's quantized Predictor (bf16) on (params, sn_state),
    its frozen, quantized tree built by the JAX functions its constructor
    calls (compiled here: run op by op they take tens of seconds)."""
    tree = _jax_quantize(_jax_freeze(params, sn_state), sn_state,
                         mode=MODES[quantize])
    p = JaxPredictor(get_config(config).model, tree, sn_state,
                     crop=get_config(config).crop, quantize=quantize,
                     _prefrozen=True)
    out, _ = p._predict(p.params, p.sn_state, jnp.asarray(images))
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("config,quantize,shape,against_jax", [
    ("tiny-cls", "int8", (4, 56, 56, 3), True),
    ("tiny-cls", "int8-wo", (4, 56, 56, 3), True),
    ("tiny-reg", "int8", (2, 56, 56, 3), False),
    ("tiny-reg", "int8-wo", (2, 56, 56, 3), False)])
def test_quantized_predictor(config, quantize, shape, against_jax):
    """The port's quantized Predictor (bf16) against its own bf16 logits
    and, where compared, against the JAX package's quantized Predictor on
    the same weights, by tests/test_quantize.py:145-162's limits: relative
    logit error < 0.15, and for tiny-cls top-1 agreement on at least 3 of
    4 images."""
    import copy

    params, sn_state, model = _carried(config)
    images = np.random.default_rng(0).integers(0, 256, shape,
                                               dtype=np.uint8)
    crop = get_config(config).crop
    base, _ = Predictor(copy.deepcopy(model), crop=crop).predict(images)
    pq = Predictor(copy.deepcopy(model), crop=crop, quantize=quantize)
    assert any(m.w_q is not None for m in pq.model.modules()
               if isinstance(m, SpectralNormed) and hasattr(m, "w_q"))
    got, _ = pq.predict(images)
    got, base = got.float().numpy(), base.float().numpy()
    refs = [base]
    if against_jax:
        refs.append(_jax_logits(config, quantize, params, sn_state, images))
    for ref in refs:
        rel = np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-9)
        assert rel < 0.15, rel
        if config == "tiny-cls":
            assert (got.argmax(-1) == ref.argmax(-1)).sum() >= 3


def test_unknown_quantize_mode_raises():
    with pytest.raises(ValueError, match="unknown quantize mode"):
        Predictor.fresh("tiny-cls", device="cpu", quantize="fp4")
