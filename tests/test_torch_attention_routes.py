"""The port's attention dispatch and its 'chunked' and 'xla' routes
(ops/attention.py) against the JAX package's on the CPU.

* `pick_route` equals the JAX `_pick_impl` (route and chunk) on shapes no
  kernel takes: Sq != Skv and a dtype no kernel takes, on both sides of the
  score budget. On the CPU the JAX package takes no Pallas route, so its
  `_pick_impl` answers 'chunked' or 'xla'.
* Every shape the TPU runs on a Pallas kernel takes a kernel in the port:
  `_pick_impl` with the JAX package told it runs on a TPU, at
  hires-cls-1024 with every head count it validates, B 1, 8 and 16.
* The routes' forward against JAX `attention_impl("chunked", chunk=2)` and
  `("xla")`, fp32 and bf16, with and without the mask: fp32 at rtol 1e-5 /
  atol 1e-6 (tests/test_kernels.py:198-199 holds chunked against
  whole-batch so); bf16 as tests/test_torch_bf16_jax.py holds the bf16
  step: each side's departure from the fp32 output of the same size (ratio
  within 0.8-1.25). The bf16 forward also against the JAX package's ops
  run one by one (each rounded to its dtype), element by element: at most
  one bf16 ulp apart, where the kernels' plain version (its mask MLP in
  fp32) is not.
* Gradients (q, k, v, the raw mask weights through the eval spectral norm,
  and through `masked_rope_attention` the RoPE frequencies) against
  `jax.grad` of the same route: fp32 at rtol 5e-3 / atol 2e-4 of each
  gradient's largest value (docs/ADR-bitexact.md section 2); bf16 gradients
  are rounded at different points of two summation orders, so, as in
  tests/test_torch_bf16_jax.py, each side's departure from its own fp32
  gradient is held to the other's.
* In fp32 the route is the kernels' plain version op for op.
* TINY_VIT under a forced 'chunked' route against the JAX model under the
  same route on carried weights; a remat training step under it against
  the default route's, remat on and off, its forward run once a layer.
* The guard: every attention shape of every config, fp32 and bf16, mask on
  and off, takes a kernel route.
"""

import copy
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _sn_warmup import converged_sn_state
from calm_vit_dte_tpu.models.factory import create_vit as jax_create_vit
from calm_vit_dte_tpu.models.vit import vit_apply
from calm_vit_dte_tpu.ops import attention as jax_attention
from calm_vit_dte_tpu_torch.compat import from_jax
from calm_vit_dte_tpu_torch.kernels import axial_attention as ka
from calm_vit_dte_tpu_torch.kernels import hires_attention as kh
from calm_vit_dte_tpu_torch.models.vit import ViT
from calm_vit_dte_tpu_torch.nn.spectral_norm import normalize_tree
from calm_vit_dte_tpu_torch.ops import attention as port
from calm_vit_dte_tpu_torch.ops.attention import attention_impl, pick_route
from calm_vit_dte_tpu_torch.ops.variational import noise_override
from calm_vit_dte_tpu_torch.train.optim import FusedAdamW
from calm_vit_dte_tpu_torch.train.state import TrainState
from calm_vit_dte_tpu_torch.train.step import make_train_step
from calm_vit_dte_tpu_torch.utils import configs

# One intra-op thread: the suite runs several worker processes per machine,
# and a torch thread pool per worker oversubscribes the cores.
torch.set_num_threads(1)

F32, BF16 = torch.float32, torch.bfloat16
DTYPES = {"fp32": (F32, jnp.float32), "bf16": (BF16, jnp.bfloat16)}

# (B, H, Sq, Skv, D, Dv, dtype): shapes no kernel takes.
ROUTE_SHAPES = [
    (1, 6, 1024, 512, 512, 512, F32),       # hires-cls-1024 widths, Sq != Skv
    (8, 6, 1024, 512, 512, 512, BF16),
    (16, 6, 1024, 1000, 512, 512, BF16),    # past the budget: chunk 2
    (16, 6, 832, 800, 416, 416, BF16),      # 255.6 MB, just inside it
    (16, 4, 2048, 512, 264, 264, F32),      # exactly the budget: xla
    (17, 4, 2048, 512, 264, 264, F32),      # past it; 4 lowered to 1
    (32, 12, 1024, 1020, 256, 256, BF16),   # chunk 1
    (4, 12, 224, 256, 56, 56, F32),
    (128, 12, 224, 256, 56, 56, BF16),      # chunk 24 lowered to 16
    (8, 12, 224, 200, 55, 57, BF16),        # odd Dc and Dv in bf16
    (2, 8, 512, 256, 64, 320, F32),         # Dv over 256
    (4, 4, 64, 64, 32, 32, torch.float16),  # a dtype no kernel takes
    (16, 12, 1024, 1024, 64, 64, torch.float16),   # chunk 1
    (3, 2, 16, 24, 12, 10, torch.float16),
]


@pytest.mark.parametrize("shape", ROUTE_SHAPES,
                         ids=lambda s: "x".join(map(str, s[:6])) + str(s[6]))
def test_pick_route_matches_jax(shape):
    b, h, sq, skv, d, dv, dtype = shape
    assert pick_route(b, h, sq, skv, d, dv, dtype) == \
        jax_attention._pick_impl(b, h, sq, skv, d)
    for forced in (("chunked", None), ("chunked", 3), ("xla", None)):
        with attention_impl(*forced), jax_attention.attention_impl(*forced):
            assert pick_route(b, h, sq, skv, d, dv, dtype) == \
                jax_attention._pick_impl(b, h, sq, skv, d)


@pytest.mark.parametrize("limit", port.ROUTE_LIMITS, ids=lambda x: x[0])
def test_each_limit_moves_the_shape_to_the_next_route(limit):
    """Just inside a limit the shape takes the first route, just past the
    second; a hires shape past a hires kernel's limit stays on the hires
    route and runs other hires kernels (in bf16, a pass changes family: the
    wide tensor-core kernels, or the CUDA-core kernels past the tensor-core
    ones; in fp32, the CUDA-core kernels on both sides); forcing a kernel
    route on a shape its kernels refuse raises."""
    _, inside, past, first, second, dtypes = limit
    for dtype in (getattr(torch, n) for n in dtypes):
        for use_mask in (True, False):
            for shape, want in ((inside, first), (past, second)):
                b, h, sq, skv, dc, dr, dv = shape
                got, _ = pick_route(b, h, sq, skv, dc + dr, dv, dtype, dr=dr,
                                    use_mask=use_mask)
                assert got == want, (shape, dtype, use_mask)
            b, h, sq, skv, dc, dr, dv = past
            if first == second:   # the hires kernels' families
                fams = [[kh.family(x[2], x[4] + x[5], x[6], dtype, p)
                         for p in kh.TC_MAX_D] for x in (inside, past)]
                if dtype == F32:
                    assert fams == [["cuda_core"] * 3] * 2
                else:
                    assert kh.tensor_cores(inside[2], sum(inside[4:6]),
                                           inside[6], dtype)
                    assert fams[0] != fams[1], fams
                continue
            with attention_impl(first), pytest.raises(ValueError,
                                                      match="refuses"):
                pick_route(b, h, sq, skv, dc + dr, dv, dtype, dr=dr,
                           use_mask=use_mask)


def _hires_heads():
    """{heads: {(H, S, Dc, Dr, Dv)}} of hires-cls-1024 at every head count
    its config validates (`create_vit(..., heads=H)`)."""
    base = configs.get_config("hires-cls-1024").model
    out = {}
    for heads in (1, 2, 3, 4, 5, 6, 8, 12, 16, 24):
        cfg = dataclasses.replace(base, heads=heads)
        try:
            cfg.validate()
        except (ValueError, AssertionError):
            continue
        out[heads] = {(v.heads, v.seq_len_new,
                       v.head_dim_content if v.reduce else 0,
                       v.head_dim_rope if v.reduce else v.head_dim,
                       v.head_dim)
                      for _, bcfg in cfg.backbone_cfg().block_configs()
                      for v in (bcfg.encoder_cfg(), bcfg.decoder_cfg(),
                                bcfg.cross_cfg())}
    return out


HIRES_HEADS = _hires_heads()


@pytest.mark.parametrize("heads", sorted(HIRES_HEADS))
def test_every_shape_the_tpu_runs_on_pallas_takes_a_kernel(heads,
                                                           monkeypatch):
    """hires-cls-1024 with `heads` overridden, B 1, 8 and 16: where the JAX
    package on a TPU takes a Pallas route (`_pick_impl` with
    `jax.default_backend()` answering 'tpu': its VMEM estimators decide),
    the port takes a kernel route in fp32 and bf16; where the TPU takes
    'chunked' or 'xla' the port takes a kernel or the same route and
    chunk."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    assert 6 in HIRES_HEADS and 12 in HIRES_HEADS
    pallas = {"pallas", "pallas_hires", "pallas_fwd"}
    seen = set()
    for h, s, dc, dr, dv in HIRES_HEADS[heads]:
        for b in (1, 8, 16):
            tpu = jax_attention._pick_impl(b, h, s, s, dc + dr)
            for dtype in (F32, BF16):
                got = pick_route(b, h, s, s, dc + dr, dv, dtype, dr=dr)
                if tpu[0] in pallas:
                    assert got[0] in ("rope", "hires"), (b, h, s, dc, dr,
                                                         dtype, tpu, got)
                else:
                    assert got[0] in ("rope", "hires") or got == tpu
                seen.add(tpu[0])
    if heads == 6:
        assert seen <= pallas


def _config_shapes():
    """{(H, S, Dc, Dr, Dv)} of every config's attention calls."""
    shapes = set()
    for cfg in configs.CONFIGS.values():
        for _, bcfg in cfg.model.backbone_cfg().block_configs():
            for v in (bcfg.encoder_cfg(), bcfg.decoder_cfg(),
                      bcfg.cross_cfg()):
                dc = v.head_dim_content if v.reduce else 0
                dr = v.head_dim_rope if v.reduce else v.head_dim
                shapes.add((v.heads, v.seq_len_new, dc, dr, v.head_dim))
    return shapes


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["fp32", "bf16"])
def test_every_config_shape_takes_a_kernel(dtype):
    """No config's attention leaves the kernels, and none changed kernel:
    every shape within S 256, D 64 and Dv 64 takes the rope kernels and
    every other the hires kernels (in bf16 their tensor-core kernels), as
    before the predicates. The routes of this module serve only shapes with
    Sq != Skv or a dtype no kernel takes."""
    shapes = _config_shapes()
    assert (12, 1024, 128, 128, 256) in shapes
    routes = set()
    for h, s, dc, dr, dv in shapes:
        want = "rope" if s <= 256 and dc + dr <= 64 and dv <= 64 else "hires"
        for b in (1, 8, 128):
            for use_mask in (True, False):
                route, _ = pick_route(b, h, s, s, dc + dr, dv, dtype, dr=dr,
                                      use_mask=use_mask)
                assert route == want, (h, s, dc, dr, dv, route)
                routes.add(route)
                if route == "hires" and dtype == BF16:
                    assert kh.tensor_cores(s, dc + dr, dv, dtype)
    assert routes == {"rope", "hires"}


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _mask(rng, skv):
    """Raw mask weights and a spectral-norm state holding their top
    singular vectors (eval sigma then the true spectral norm)."""
    raw = {"fc1": (_normal(rng, 2 * skv, skv, scale=1 / math.sqrt(skv)),
                   _normal(rng, 2 * skv, scale=0.1)),
           "fc2": (_normal(rng, skv, 2 * skv, scale=1 / math.sqrt(2 * skv)),
                   _normal(rng, skv, scale=0.1))}
    state = {}
    for fc, (w, _) in raw.items():
        u, _, vt = np.linalg.svd(w.astype(np.float64))
        state[fc] = {"u": u[:, 0].astype(np.float32),
                     "v": vt[0].astype(np.float32)}
    return raw, state


def _jax_mask(raw, state):
    return ({fc: {"w": jnp.asarray(w), "b": jnp.asarray(b)}
             for fc, (w, b) in raw.items()},
            {fc: {k: jnp.asarray(x) for k, x in st.items()}
             for fc, st in state.items()})


def _port_mask(ws, state):
    """(w1, b1, w2, b2) normalized as the JAX eval spectral norm does,
    w / (u . W v), differentiable in the raw torch weights `ws`."""
    out = []
    for fc, w, b in (("fc1", ws[0], ws[1]), ("fc2", ws[2], ws[3])):
        u, v = (torch.from_numpy(state[fc][k]) for k in ("u", "v"))
        out += [w / (u @ (w @ v)), b]
    return tuple(out)


def _attention_inputs(seed, b=4, h=2, sq=16, skv=24, d=12, dv=10):
    rng = np.random.default_rng(seed)
    q = _normal(rng, b, h, sq, d)
    k = _normal(rng, b, h, skv, d)
    v = _normal(rng, b, h, skv, dv)
    raw, state = _mask(rng, skv)
    g = _normal(rng, b, h, sq, dv)
    return q, k, v, raw, state, g


def _jax_route(route, fn):
    """`fn` jitted and traced under the JAX route of the port's name."""
    forced = ("chunked", 2) if route == "chunked" else ("xla", None)
    jitted = jax.jit(fn)

    def call(*args):
        with jax_attention.attention_impl(*forced):
            return jitted(*args)

    return call, forced


def _departures_agree(port16, jax16, ref32):
    """Each side's bf16 departure from the fp32 output, of one size."""
    dp = float(np.linalg.norm(port16 - ref32))
    dj = float(np.linalg.norm(jax16 - ref32))
    assert dj > 0 and 0.8 < dp / dj < 1.25, (dp, dj)


@pytest.mark.parametrize("use_mask", [True, False], ids=["mask", "nomask"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("route", ["chunked", "xla"])
def test_route_forward_matches_jax(route, dtype, use_mask):
    """masked_attention on Sq = 16, Skv = 24 under each forced route."""
    q, k, v, raw, state, _ = _attention_inputs(seed=11)
    tdt, jdt = DTYPES[dtype]
    jparams, jstate = _jax_mask(raw, state)
    mask = tuple(t.detach() for t in _port_mask(
        [torch.from_numpy(x) for pair in raw.values() for x in pair], state))

    def jax_fn(q_, k_, v_, p_, dt):
        return jax_attention.masked_attention(
            q_, k_, v_, p_, jstate, training=False, dtype=dt,
            use_mask=use_mask)[0].astype(jnp.float32)

    args = [jnp.asarray(x) for x in (q, k, v)] + [jparams]
    call, forced = _jax_route(route, lambda *a: jax_fn(*a, jdt))
    ref = np.asarray(call(*args))
    before = dict(port.route_calls)
    with attention_impl(*forced):
        out = port.masked_attention(*map(torch.from_numpy, (q, k, v)), mask,
                                    dtype=tdt, use_mask=use_mask)
    assert port.route_calls[route] == before[route] + 1
    assert out.dtype == tdt and out.shape == (4, 2, 16, 10)
    if dtype == "fp32":
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)
        return
    call32, _ = _jax_route(route, lambda *a: jax_fn(*a, jnp.float32))
    _departures_agree(out.float().numpy(), ref, np.asarray(call32(*args)))


def _bf16_ulp(x):
    """The spacing of bf16 numbers at |x| (x bf16-valued, fp32 numpy)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


@pytest.mark.parametrize("case", [(11, {}),
                                  (21, dict(b=4, h=4, sq=32, skv=32, d=16,
                                            dv=16)),
                                  (31, dict(b=2, h=6, sq=48, skv=40, d=24,
                                            dv=20))],
                         ids=["16x24", "32x32", "48x40"])
def test_bf16_route_rounds_where_jax_rounds(case):
    """The bf16 'xla' route with the mask against the JAX package's
    `masked_attention` under 'xla' run op by op (not jitted, so each op
    rounds to the dtype it names and XLA keeps no excess precision):
    every output element within one bf16 ulp, under 1% of them apart at
    all. The control, the kernels' plain version `attention_core` (its mask
    MLP in fp32) on the same inputs, fails the same comparison: over 30%
    of its elements are apart and some by more than an ulp. The ulp is
    that of the largest element of the output row (b, h, q): where one
    bf16 rounding upstream falls the other way (a mask element, from fp32
    sums in another order), the row's elements move by about an ulp of
    their weighted sum, however small an element is."""
    seed, shape = case
    q, k, v, raw, state, _ = _attention_inputs(seed=seed, **shape)
    jparams, jstate = _jax_mask(raw, state)
    mask = tuple(t.detach() for t in _port_mask(
        [torch.from_numpy(x) for pair in raw.values() for x in pair], state))
    with jax_attention.attention_impl("xla"):
        ref = np.asarray(jax_attention.masked_attention(
            *(jnp.asarray(x) for x in (q, k, v)), jparams, jstate,
            training=False, dtype=jnp.bfloat16)[0].astype(jnp.float32))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    with attention_impl("xla"):
        out = port.masked_attention(tq, tk, tv, mask, dtype=BF16)
    control = ka.attention_core(tq, tk, tv, *mask, dtype=BF16,
                                scale=1 / math.sqrt(q.shape[-1]),
                                use_mask=True)
    for name, x in (("route", out), ("control", control)):
        x = x.float().numpy()
        apart = x != ref
        within = np.abs(x - ref) <= _bf16_ulp(np.abs(ref).max(
            axis=-1, keepdims=True))
        if name == "route":
            assert within.all() and apart.mean() < 0.01, apart.mean()
        else:
            assert apart.mean() > 0.3 and not within.all(), apart.mean()


def _assert_grads_close(got: dict, want: dict):
    """fp32: docs/ADR-bitexact.md section 2's limits, leaf by leaf."""
    for name, w in want.items():
        np.testing.assert_allclose(
            got[name], w, rtol=5e-3, atol=2e-4 * float(np.abs(w).max())
            + 1e-12, err_msg=name)


def _assert_departures_alike(port: dict, jax_: dict, apart=("b1", "b2")):
    """bf16 as tests/test_torch_bf16_jax.py holds the bf16 step: each
    side's bf16 gradient departs from its own fp32 one; over the leaves the
    two departures are of one size (median ratio and root sum of squares
    within 0.8-1.25). The leaves `apart` are held apart, the port's
    departure under 0.1: the mask biases, which the JAX package adds in
    bf16 and whose gradients it sums in bf16 (the port in fp32), and the
    RoPE frequencies, four elements each, every one a sum over all (b, h,
    s) of bf16 products."""
    rows = []
    for name, j32 in jax_["fp32"].items():
        scale = max(float(np.linalg.norm(j32)), 1e-30)
        rows.append((name,
                     float(np.linalg.norm(jax_["bf16"][name] - j32)) / scale,
                     float(np.linalg.norm(port["bf16"][name]
                                          - port["fp32"][name])) / scale))
    shared = [(j, p) for name, j, p in rows if name not in apart]
    ratio = np.median([p / j for j, p in shared])
    both = (np.sqrt(sum(p * p for _, p in shared))
            / np.sqrt(sum(j * j for j, _ in shared)))
    assert 0.8 < ratio < 1.25 and 0.8 < both < 1.25, rows
    assert all(p < 0.1 for name, _, p in rows if name in apart), rows


def _attention_grads(route, dtype, q, k, v, raw, state, g):
    """({name: port gradient}, {name: JAX gradient}) of <out, g> under the
    route, numpy fp32."""
    tdt, jdt = DTYPES[dtype]
    jparams, jstate = _jax_mask(raw, state)

    def loss(q_, k_, v_, p_):
        out, _ = jax_attention.masked_attention(
            q_, k_, v_, p_, jstate, training=False, dtype=jdt)
        return jnp.sum(out.astype(jnp.float32) * g)

    call, forced = _jax_route(route, jax.grad(loss, argnums=(0, 1, 2, 3)))
    dq, dk, dv, dp = call(*(jnp.asarray(x) for x in (q, k, v)), jparams)
    want = {"q": dq, "k": dk, "v": dv, "w1": dp["fc1"]["w"],
            "b1": dp["fc1"]["b"], "w2": dp["fc2"]["w"], "b2": dp["fc2"]["b"]}
    leaves = {n: torch.from_numpy(x).requires_grad_()
              for n, x in (("q", q), ("k", k), ("v", v), ("w1", raw["fc1"][0]),
                           ("b1", raw["fc1"][1]), ("w2", raw["fc2"][0]),
                           ("b2", raw["fc2"][1]))}
    mask = _port_mask([leaves[n] for n in ("w1", "b1", "w2", "b2")], state)
    with attention_impl(*forced):
        out = port.masked_attention(leaves["q"], leaves["k"], leaves["v"],
                                    mask, dtype=tdt)
    (out.float() * torch.from_numpy(g)).sum().backward()
    return ({n: t.grad.float().numpy() for n, t in leaves.items()},
            {n: np.asarray(x, np.float32) for n, x in want.items()})


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("route", ["chunked", "xla"])
def test_route_gradients_match_jax(route, dtype):
    """d/d(q, k, v, w1, b1, w2, b2) of <out, g>, the mask weights raw
    through the eval spectral norm, against jax.grad of the same route."""
    inputs = _attention_inputs(seed=12)
    got, want = _attention_grads(route, "fp32", *inputs)
    if dtype == "fp32":
        _assert_grads_close(got, want)
        return
    got16, want16 = _attention_grads(route, "bf16", *inputs)
    _assert_departures_alike({"fp32": got, "bf16": got16},
                             {"fp32": want, "bf16": want16})


def _rope_run(route, dtype, sq):
    """(port gradients, JAX gradients, port output, JAX output) of
    masked_rope_attention under the route, numpy fp32."""
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(13)
    b, h, skv, dc, dr, dv = 4, 2, 24, 6, 8, 14
    arrays = {"qc": _normal(rng, b, h, sq, dc),
              "qr": _normal(rng, b, h, sq, dr),
              "kc": _normal(rng, b, h, skv, dc),
              "kr": _normal(rng, b, h, skv, dr),
              "v": _normal(rng, b, h, skv, dv),
              "fq": (1.0 / 10.0 ** (np.arange(0, dr, 2) / dr)).astype(
                  np.float32)}
    arrays["fk"] = (arrays["fq"] * 1.3).astype(np.float32)
    raw, state = _mask(rng, skv)
    jparams, jstate = _jax_mask(raw, state)
    g = _normal(rng, b, h, sq, dv)

    def loss(a):
        out, _ = jax_attention.masked_rope_attention(
            a["qc"], a["qr"], a["kc"], a["kr"], a["v"],
            {"inv_freq": a["fq"]}, {"inv_freq": a["fk"]}, jparams, jstate,
            training=False, dtype=jdt)
        return jnp.sum(out.astype(jnp.float32) * g), out.astype(jnp.float32)

    forced = ("chunked", 2) if route == "chunked" else ("auto", None)
    fn = jax.jit(jax.grad(loss, has_aux=True))
    with jax_attention.attention_impl(*forced):
        want, ref = fn({n: jnp.asarray(x) for n, x in arrays.items()})
    leaves = {n: torch.from_numpy(x).requires_grad_()
              for n, x in arrays.items()}
    mask = _port_mask([torch.from_numpy(x) for pair in raw.values()
                       for x in pair], state)
    before = dict(port.route_calls)
    with attention_impl(*forced):
        out = port.masked_rope_attention(
            leaves["qc"], leaves["qr"], leaves["kc"], leaves["kr"],
            leaves["v"], leaves["fq"], leaves["fk"], mask, dtype=tdt)
    taken = "chunked" if route == "chunked" else "xla"
    assert port.route_calls[taken] == before[taken] + 1
    (out.float() * torch.from_numpy(g)).sum().backward()
    return ({n: t.grad.float().numpy() for n, t in leaves.items()},
            {n: np.asarray(x, np.float32) for n, x in want.items()},
            out.detach().float().numpy(), np.asarray(ref))


@pytest.mark.parametrize("case", [("auto", "fp32", 16), ("auto", "bf16", 16),
                                  ("chunked", "fp32", 24),
                                  ("chunked", "bf16", 24)],
                         ids=lambda c: "-".join(map(str, c)))
def test_rope_route_gradients_match_jax(case):
    """masked_rope_attention: the output and the gradients of qc, qr, kc,
    kr, v and both RoPE frequency vectors. Sq = 16 != Skv = 24 takes the
    'xla' route by itself on both sides; Sq = Skv = 24 is forced onto
    'chunked' (chunk 2)."""
    route, dtype, sq = case
    got, want, out, ref = _rope_run(route, "fp32", sq)
    if dtype == "fp32":
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
        _assert_grads_close(got, want)
        return
    got16, want16, out16, ref16 = _rope_run(route, "bf16", sq)
    _departures_agree(out16, ref16, ref)
    _assert_departures_alike({"fp32": got, "bf16": got16},
                             {"fp32": want, "bf16": want16},
                             apart=("fq", "fk"))


def test_fp32_route_is_the_plain_version():
    """In fp32 `route_core` is `axial_attention.attention_core` op for op:
    the forward is the same bits, chunked or not, and the gradients agree
    to fp32 noise with torch autograd of the plain version."""
    q, k, v, raw, state, g = _attention_inputs(seed=14, sq=24)
    args = [torch.from_numpy(x) for x in (q, k, v)] + list(_port_mask(
        [torch.from_numpy(x) for pair in raw.values() for x in pair], state))
    args = [a.detach().requires_grad_() for a in args]
    kw = dict(scale=1 / math.sqrt(12), dtype=F32, use_mask=True)
    plain = ka.attention_core(*args, **kw)
    torch.testing.assert_close(port.route_core(*args, **kw), plain, rtol=0,
                               atol=0)
    want = torch.autograd.grad(plain, args, torch.from_numpy(g))
    for forced in (("xla", None), ("chunked", 1)):
        with attention_impl(*forced):
            out = port.masked_attention(*args[:3], tuple(args[3:]),
                                        dtype=F32)
        torch.testing.assert_close(out, plain, rtol=0, atol=0)
        got = torch.autograd.grad(out, args, torch.from_numpy(g))
        for name, x, y in zip("q k v w1 b1 w2 b2".split(), got, want):
            torch.testing.assert_close(
                x, y, rtol=1e-5, atol=1e-6 * float(y.abs().max()),
                msg=lambda m, n=name: f"{n}: {m}")


def _carry(params, state):
    return from_jax.state_dict_from_jax(jax.tree.map(np.asarray, params),
                                        jax.tree.map(np.asarray, state))


def test_tiny_cls_chunked_route_matches_jax():
    """The whole tiny-cls forward under a forced 'chunked' route (chunk 1)
    against the JAX model under the same route, on carried weights: every
    attention layer through the route, once."""
    cfg, params, state = jax_create_vit("tiny-cls", seed=0)
    state = converged_sn_state(configs.TINY_VIT, params, state)
    x = np.random.default_rng(1).standard_normal((2, 48, 48, 3)).astype(
        np.float32)
    fn = jax.jit(lambda p, s, x_: vit_apply(cfg, p, s, x_,
                                            training=False)[:2])
    with jax_attention.attention_impl("chunked", chunk=1):
        ref, kl_ref = fn(params, state, jnp.asarray(x))
    model = ViT(configs.TINY_VIT, torch.Generator().manual_seed(0)).eval()
    model.load_state_dict(_carry(params, state))
    layers = 3 * len(list(model.cfg.backbone_cfg().block_configs()))
    before = port.route_calls["chunked"]
    with attention_impl("chunked", chunk=1), torch.no_grad():
        logits, kl = model(torch.from_numpy(x))
    assert port.route_calls["chunked"] - before == layers == 24
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(float(kl), float(kl_ref), rtol=1e-4)


class _Capture(FusedAdamW):
    """Keeps the gradients a step hands the optimizer and changes nothing."""

    def __init__(self):
        self.grads = None

    def update(self, params, grads, state):
        self.grads = [g.clone() for g in grads]


class _Gnorm:
    gnorm = 0.0


class _NoiseSeq:
    def __init__(self):
        self.i = 0

    def __call__(self, shape):
        self.i += 1
        return np.random.default_rng(3000 + self.i).standard_normal(
            shape).astype(np.float32)


def test_remat_train_step_chunked_route_matches_default_route():
    """A tiny-cls training step under `attention_impl("chunked", chunk=1)`,
    with remat and without, against the default (rope kernel) route's step
    with remat: loss and every gradient agree in fp32, and the route's
    forward ran once per attention layer a step (none in the Block
    replay)."""
    base = ViT(configs.TINY_VIT, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for _ in range(30):
            normalize_tree(base, training=True)
    rng = np.random.default_rng(4)
    t = rng.random((2, 10)).astype(np.float32)
    batch = {"image": rng.standard_normal((2, 48, 48, 3)).astype(np.float32),
             "label": t / t.sum(-1, keepdims=True)}

    def run(forced, remat):
        cap = _Capture()
        model = copy.deepcopy(base)
        step = make_train_step(configs.TINY_VIT, cap, "cls", dtype=F32,
                               remat=remat)
        state = TrainState(model=model, opt_state=_Gnorm(), step=0, seed=0)
        before = port.route_calls["chunked"]
        with attention_impl(*forced), noise_override(_NoiseSeq()):
            _, m = step(state, batch)
        return (float(m["loss"]), cap.grads,
                port.route_calls["chunked"] - before)

    loss_r, grads_r, _ = run(("auto", None), True)
    for remat in (True, False):
        loss_c, grads_c, calls = run(("chunked", 1), remat)
        assert calls == 24, remat
        np.testing.assert_allclose(loss_c, loss_r, rtol=1e-5)
        for (name, _), a, b in zip(base.named_parameters(), grads_c,
                                   grads_r):
            torch.testing.assert_close(
                a, b, rtol=1e-4, atol=1e-5 * float(b.abs().max()) + 1e-12,
                msg=lambda m_, n=name: f"{n} (remat={remat}): {m_}")
