"""Where the port's tiny-reg trajectory leaves the reference golden.

tests/golden/grad_traj_reg_tiny.npz holds ten steps of the reference's
tiny-reg training (fp32, CPU, fixed injected noise). The port follows its
losses, grad norms, one-step gradients and u/v, but two elements of its
final parameters miss the golden's limit (rtol 1e-3 / atol 5e-4 of the
leaf's largest value). This tool takes the first step apart at those
elements, on the CPU:

  * the step in fp32 (as the tests run it) and the same step in float64
    (every tensor, and every upcast the port writes as `.float()` or
    `.to(torch.float32)`, in float64): how far the fp32 gradient of each
    element is from the float64 one, and how far the golden's is;
  * the cotangent G of the spectral-normed weight (the gradient at w/sigma)
    and the two terms of the pull-back through sigma, G/sigma and
    -(sum G*W)/sigma^2 u v^T, whose cancellation leaves the gradient;
  * the pull-back from the fp32 G computed four ways: as the step computes
    it (autograd through the batched `normalize_tree`), as the reference
    orders it (autograd through w / dot(u, W v) of one weight), from the
    explicit formula in fp32, and in float64;
  * G itself: a sum over the tokens of dy x^T, from the fp32 x and dy (in
    float64, so only the inputs' rounding counts) against the float64 G.

    python -m calm_vit_dte_tpu_torch.tools.reg_drift

Prints one JSON object per element.
"""

from __future__ import annotations

import contextlib
import copy
import json
import pathlib
from dataclasses import replace

import numpy as np
import torch

from calm_vit_dte_tpu_torch.models.vit import ViT
from calm_vit_dte_tpu_torch.ops.variational import noise_override
from calm_vit_dte_tpu_torch.train.optim import make_optimizer
from calm_vit_dte_tpu_torch.train.state import create_train_state
from calm_vit_dte_tpu_torch.train.step import make_train_step
from calm_vit_dte_tpu_torch.utils.configs import TINY_VIT

GOLDEN = (pathlib.Path(__file__).resolve().parents[2] / "tests" / "golden"
          / "grad_traj_reg_tiny.npz")
# The two elements of the final parameters that miss the golden's limit.
ELEMENTS = (("autoencoder.decoder_blocks.2.cross.input_proj", (23, 70)),
            ("autoencoder.decoder_blocks.2.cross.mlp.0", (141, 82)))
# The golden's optimizer (tests/test_parity_grad.py's trajectory).
OPT = dict(base_lr=3.1e-3, weight_decay=0.02, b1=0.9, b2=0.98, epochs=5,
           steps_per_epoch=2, clip_norm=1.0)


class _Noise:
    """Call n returns standard normal noise from seed 1000 + n (the
    goldens' injected sequence)."""

    def __init__(self, dtype):
        self.i, self.dtype = 0, dtype

    def __call__(self, shape):
        arr = np.random.default_rng(1000 + self.i).standard_normal(shape)
        self.i += 1
        return arr.astype(np.float32).astype(self.dtype)


@contextlib.contextmanager
def _float64():
    """Run the port in float64: new tensors, `.float()` and `.to(float32)`
    all give float64."""
    f, to, default = torch.Tensor.float, torch.Tensor.to, \
        torch.get_default_dtype()

    def as_f64(self, *a, **k):
        return self.double() if self.dtype == torch.float64 else f(
            self, *a, **k)

    def to_f64(self, *a, **k):
        a = tuple(torch.float64 if x is torch.float32 else x for x in a)
        if k.get("dtype") is torch.float32:
            k["dtype"] = torch.float64
        return to(self, *a, **k)

    torch.Tensor.float, torch.Tensor.to = as_f64, to_f64
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.Tensor.float, torch.Tensor.to = f, to
        torch.set_default_dtype(default)


def _first_step(d, dtype) -> dict:
    """One step of the golden in `dtype`: per element's layer, W, u, v,
    G, x, dy and the step's gradient."""
    cfg = replace(TINY_VIT, out_features=144, generate=True)
    model = ViT(cfg, torch.Generator().manual_seed(0))
    model.load_state_dict({k[3:]: torch.from_numpy(d[k]) for k in d.files
                           if k.startswith("sd/")})
    model = model.to(dtype)
    mods = dict(model.named_modules())
    w0 = {name: mods[name].weight_orig.detach().clone()
          for name, _ in ELEMENTS}
    taps: dict = {}
    for name, _ in ELEMENTS:
        def hook(mod, inp, out, name=name):
            taps[name, "x"] = inp[0].detach().clone()
            out.register_hook(
                lambda g: taps.__setitem__((name, "dy"), g.detach().clone()))
        mods[name].register_forward_hook(hook)
    pulled = {}
    backward = torch.autograd.backward

    def record(tensors, grads=None, *a, **k):
        if grads is not None:   # the step's one pull-back
            pulled.update(zip((id(t) for t in tensors), grads))
            pulled["tensors"] = list(tensors)
        return backward(tensors, grads, *a, **k)

    tx = make_optimizer(**OPT)
    state = create_train_state(model, tx, seed=3)
    step = make_train_step(cfg, tx, "reg", dtype=dtype, remat=False)
    batch = {"image": d["in/x"].transpose(0, 2, 3, 1).astype(
        np.float32 if dtype == torch.float32 else np.float64)}
    torch.autograd.backward = record
    try:
        with noise_override(_Noise(np.float32 if dtype == torch.float32
                                   else np.float64)):
            step(state, batch)
    finally:
        torch.autograd.backward = backward
    out = {}
    for name, _ in ELEMENTS:
        m = mods[name]
        w = w0[name].reshape(w0[name].shape[0], -1)
        u, v = m.weight_u.detach().clone(), m.weight_v.detach().clone()
        sigma = torch.dot(u, w @ v)
        # The pulled-back tensor of this layer is w / sigma.
        (g,) = [pulled[id(t)] for t in pulled["tensors"]
                if t.shape == m.weight_orig.shape and torch.allclose(
                    t.detach().reshape(w.shape), w / sigma, rtol=1e-5,
                    atol=0.0)]
        out[name] = {"w": w, "u": u, "v": v, "g": g.reshape(w.shape),
                     "grad": m.weight_orig.grad.reshape(w.shape),
                     "x": taps[name, "x"].reshape(-1, w.shape[1]),
                     "dy": taps[name, "dy"].reshape(-1, w.shape[0])}
    return out


def _pullbacks(g, w, u, v) -> dict:
    """The pull-back through sigma of the cotangent g, four ways."""
    g32, w32, u32, v32 = (t.float() for t in (g, w, u, v))
    wl = w32.clone().requires_grad_()
    (wl / torch.dot(u32, wl @ v32)).backward(g32)
    s32 = torch.dot(u32, w32 @ v32)
    explicit = g32 / s32 - ((g32 * w32).sum() / s32**2) * torch.outer(u32,
                                                                      v32)
    g64, w64, u64, v64 = (t.double() for t in (g, w, u, v))
    s64 = torch.dot(u64, w64 @ v64)
    t1 = g64 / s64
    t2 = -((g64 * w64).sum() / s64**2) * torch.outer(u64, v64)
    return {"reference_order_fp32": wl.grad, "explicit_fp32": explicit,
            "float64": t1 + t2, "term_g_over_sigma": t1,
            "term_through_sigma": t2}


def main() -> int:
    torch.set_num_threads(1)
    d = np.load(GOLDEN)
    fp32 = _first_step(d, torch.float32)
    with _float64():
        fp64 = _first_step(d, torch.float64)
    for name, idx in ELEMENTS:
        a, b = fp32[name], fp64[name]
        golden = d[f"grad/{name}.weight_orig"].reshape(a["w"].shape)
        pb = _pullbacks(a["g"], a["w"], a["u"], a["v"])
        o, i = idx
        terms = (a["dy"][:, o].double() * a["x"][:, i].double())
        top = float(np.abs(golden).max())

        def rel_err(x, ref):
            return float((x.double() - ref).abs().max() / ref.abs().max())

        print(json.dumps({
            "element": f"{name}.weight_orig{list(idx)}",
            "leaf_max_abs_gradient": top,
            "gradient": {"port_fp32": float(a["grad"][idx]),
                         "port_float64": float(b["grad"][idx]),
                         "golden": float(golden[idx])},
            "pullback_from_fp32_G": {
                "step_fp32": float(a["grad"][idx]),
                **{k: float(v[idx]) for k, v in pb.items()}},
            "G": {"fp32": float(a["g"][idx]), "float64": float(b["g"][idx]),
                  "from_fp32_x_dy_in_float64": float(terms.sum()),
                  "tokens": int(terms.numel()),
                  "sum_abs_terms": float(terms.abs().sum())},
            "rel_err_fp32_vs_float64": {"x": rel_err(a["x"], b["x"]),
                                        "dy": rel_err(a["dy"], b["dy"]),
                                        "G_leaf": rel_err(a["g"], b["g"])},
        }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
