"""Weight carry: the JAX package's (params, sn_state) pytrees -> the port's
state_dict, its fused-AdamW state -> the port's optimizer state, and the
port's parameters back into a JAX-keyed tree of numpy arrays.

Counterpart of calm_vit_dte_tpu/compat/torch_export.py, whose renaming
(`_rename_back`) is copied here: the port's modules carry the reference's
names (encoder_blocks.N, block_bottle_neck_1, proj.0/2/4, mlp.0/3,
linear_mask.0/2, head.0/2, weight_orig/weight_u/weight_v), so the result
loads with `model.load_state_dict(sd)`. The pytrees arrive as nested dicts
of numpy arrays (or anything np.asarray takes); nothing of JAX is imported.
"""

from __future__ import annotations

import numpy as np
import torch

from calm_vit_dte_tpu_torch.train.optim import AdamWState


def _rename_back(path: list[str]) -> list[str]:
    out: list[str] = []
    for t in path:
        if t.startswith("encoder_") and t[8:].isdigit():
            out += ["encoder_blocks", t[8:]]
        elif t.startswith("decoder_") and t[8:].isdigit():
            out += ["decoder_blocks", t[8:]]
        elif t.startswith("block_") and t[6:].isdigit():
            out += ["encoder_blocks", t[6:]]
        elif t == "bottleneck_1":
            out.append("block_bottle_neck_1")
        elif t == "bottleneck_2":
            out.append("block_bottle_neck_2")
        elif t == "conv1":
            out[-1:] = ["proj", "0"]
        elif t == "conv2":
            out[-1:] = ["proj", "2"]
        elif t == "conv3":
            out[-1:] = ["proj", "4"]
        elif t == "mlp_fc1":
            out += ["mlp", "0"]
        elif t == "mlp_fc2":
            out += ["mlp", "3"]
        elif t == "fc1":
            out.append("0")
        elif t == "fc2":
            out.append("2")
        else:
            out.append(t)
    return out


def _param_name(path: list[str]) -> str:
    """The port's parameter name of the JAX params leaf at `path`."""
    name = path[-1]
    suffix = {"w": "weight_orig", "b": "bias", "scale": "weight",
              "inv_freq": "inv_freq"}.get(name)
    if suffix is not None:
        return ".".join(_rename_back(path[:-1]) + [suffix])
    if name in ("ls_att", "ls_mlp"):
        return ".".join(_rename_back(path))
    raise KeyError(f"unmapped param leaf {'.'.join(path)}")


def _leaves(tree: dict, path: list[str] | None = None):
    """(path, leaf) pairs in JAX's flattening order: dict keys sorted."""
    path = path or []
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], path + [k])
        else:
            yield path + [k], tree[k]


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def state_dict_from_jax(params: dict,
                        sn_state: dict) -> dict[str, torch.Tensor]:
    """Flatten the JAX (params, sn_state) into the port's fp32 state_dict."""
    sd = {_param_name(path): _tensor(leaf) for path, leaf in _leaves(params)}
    tensor = _tensor

    def walk_state(node, path):
        if isinstance(node, dict) and "u" in node and "v" in node:
            prefix = ".".join(_rename_back(path))
            sd[f"{prefix}.weight_u"] = tensor(node["u"])
            sd[f"{prefix}.weight_v"] = tensor(node["v"])
            return
        for k, v in node.items():
            walk_state(v, path + [k])

    walk_state(sn_state, [])
    return sd


def adamw_state_from_jax(params: dict, count, mu, nu, model) -> AdamWState:
    """The JAX package's FusedAdamWState (count and the flat fp32 mu/nu over
    `ravel_pytree(params)`) as the port's AdamWState for `model`, moments
    ordered like `model.parameters()` and on its device."""
    mu, nu = np.asarray(mu, np.float32), np.asarray(nu, np.float32)
    by_name, at = {}, 0
    for path, leaf in _leaves(params):
        shape = np.shape(leaf)
        n = int(np.prod(shape))
        by_name[_param_name(path)] = (mu[at:at + n].reshape(shape),
                                      nu[at:at + n].reshape(shape))
        at += n
    if at != mu.size or at != nu.size:
        raise ValueError(f"moments hold {mu.size} values, params {at}")
    moments = [by_name[name] for name, _ in model.named_parameters()]
    dev = next(model.parameters()).device
    return AdamWState(count=int(count), notfinite=0, gnorm=0.0,
                      mu=[_tensor(m).to(dev) for m, _ in moments],
                      nu=[_tensor(n).to(dev) for _, n in moments])


def params_to_jax(model, params: dict) -> dict:
    """`model`'s parameters as numpy arrays in a tree keyed like the JAX
    `params` (which only lends its structure)."""
    named = {k: v.detach().cpu().numpy()
             for k, v in model.named_parameters()}
    out: dict = {}
    for path, _ in _leaves(params):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = named[_param_name(path)]
    return out
