"""Weight carry: the JAX package's (params, sn_state) pytrees -> the port's
state_dict, its fused-AdamW state -> the port's optimizer state, and the
port's parameters back into a JAX-keyed tree of numpy arrays.

Counterpart of calm_vit_dte_tpu/compat/torch_export.py, whose renaming
(`_rename_back`) is copied here: the port's modules carry the reference's
names (encoder_blocks.N, block_bottle_neck_1, proj.0/2/4, mlp.0/3,
linear_mask.0/2, head.0/2, weight_orig/weight_u/weight_v), so the result
loads with `model.load_state_dict(sd)`. The pytrees arrive as nested dicts
of numpy arrays (or anything np.asarray takes); nothing of JAX is imported.

`state_dict_from_jax` carries the ViT and Encoder8 (its block_{i} become
encoder_blocks.{i}, the golden encoder8.npz's names). The way back, for the
ViT: `jax_path` names the JAX leaf of a port parameter or buffer, and
`jax_trees` builds the (params, sn_state) trees of a port model.

The AdamW moments come in the JAX package's two layouts
(calm_vit_dte_tpu/train/checkpoint.py): `fused-flat`, one fp32 vector over
`ravel_pytree(params)` (the params' leaves in sorted-key order, which is
not `model.parameters()` order), carried by `adamw_state_from_jax` and
back by `adamw_state_to_jax`; and `tree`, optax's per-leaf moments keyed
like params, carried by `adamw_state_from_jax_tree`.
`latent_diffusion_state_dict_from_jax` carries CALMLatentDiffusion by a
table of its own (LATENT_DIFFUSION_NAMES: its seven top-level names; a tree
with any other, such as EncoderDecoder8's bottlenecks, raises).
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


_SUFFIX_BACK = {"weight_orig": "w", "bias": "b", "weight": "scale",
                "inv_freq": "inv_freq", "ls_att": "ls_att",
                "ls_mlp": "ls_mlp", "weight_u": "u", "weight_v": "v"}


def _path_back(parts: list[str]) -> list[str]:
    """Undo `_rename_back` for the ViT's module names."""
    out: list[str] = []
    i = 0
    while i < len(parts):
        t, nxt = parts[i], parts[i + 1] if i + 1 < len(parts) else None
        if t in ("encoder_blocks", "decoder_blocks") and nxt is not None \
                and nxt.isdigit():
            out.append(f"{t[:7]}_{nxt}")
            i += 1
        elif t == "block_bottle_neck_1":
            out.append("bottleneck_1")
        elif t == "block_bottle_neck_2":
            out.append("bottleneck_2")
        elif t == "proj" and nxt in ("0", "2", "4"):
            out += ["proj", f"conv{int(nxt) // 2 + 1}"]
            i += 1
        elif t == "mlp" and nxt in ("0", "3"):
            out.append("mlp_fc1" if nxt == "0" else "mlp_fc2")
            i += 1
        elif t in ("0", "2") and out and out[-1] in ("linear_mask", "head"):
            out.append("fc1" if t == "0" else "fc2")
        else:
            out.append(t)
        i += 1
    return out


def jax_path(name: str) -> tuple[str, list[str]]:
    """The JAX tree ("params" or "sn_state") and path of the ViT's state_dict
    entry `name`; the inverse of `_param_name` and of the u/v naming of
    `state_dict_from_jax`."""
    parts = name.split(".")
    leaf = _SUFFIX_BACK.get(parts[-1])
    if leaf is None:
        raise KeyError(f"unmapped state_dict entry {name}")
    tree = "sn_state" if leaf in ("u", "v") else "params"
    if leaf in ("inv_freq", "ls_att", "ls_mlp"):
        return tree, _path_back(parts)
    return tree, _path_back(parts[:-1]) + [leaf]


def _put(tree: dict, path: list[str], value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def jax_trees(state_dict: dict) -> tuple[dict, dict]:
    """A ViT state_dict as the JAX package's (params, sn_state) trees of
    fp32 numpy arrays."""
    trees: dict = {"params": {}, "sn_state": {}}
    for name, value in state_dict.items():
        tree, path = jax_path(name)
        _put(trees[tree], path,
             value.detach().cpu().float().numpy().copy())
    return trees["params"], trees["sn_state"]


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


# CALMLatentDiffusion's top-level JAX names -> the port's module names.
LATENT_DIFFUSION_NAMES = {
    **{f"encoder_{i}": f"encoder_blocks.{i}" for i in range(3)},
    **{f"decoder_{i}": f"decoder_blocks.{i}" for i in range(3)},
    "ln_final": "ln_final",
}


def latent_diffusion_state_dict_from_jax(
        params: dict, sn_state: dict) -> dict[str, torch.Tensor]:
    """CALMLatentDiffusion's JAX (params, sn_state) -> the port's fp32
    state_dict: encoder_{i} -> encoder_blocks.{i}, decoder_{i} ->
    decoder_blocks.{i} (i = 0, 1, 2), ln_final -> ln_final; inside each
    block the shared names (proj.0/2/4, mlp.0/3, weight_orig, ...). Raises
    KeyError on any other top-level name."""
    if set(params) != set(LATENT_DIFFUSION_NAMES) or not set(sn_state) <= \
            set(LATENT_DIFFUSION_NAMES):
        raise KeyError(f"not a CALMLatentDiffusion tree: {sorted(params)}")
    sd = {}
    for jax_name, port_name in LATENT_DIFFUSION_NAMES.items():
        sub = state_dict_from_jax(params[jax_name],
                                  sn_state.get(jax_name, {}))
        sd.update({f"{port_name}.{k}": v for k, v in sub.items()})
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


def adamw_state_from_jax_tree(count, mu: dict, nu: dict,
                              model) -> AdamWState:
    """optax's ScaleByAdamState (the `tree` layout: count and per-leaf
    moments keyed like params) as the port's AdamWState for `model`."""
    by_name = {_param_name(path): leaf for path, leaf in _leaves(mu)}
    nu_by = {_param_name(path): leaf for path, leaf in _leaves(nu)}
    names = [name for name, _ in model.named_parameters()]
    if set(by_name) != set(names) or set(nu_by) != set(names):
        raise ValueError("the moments' leaves are not the model's "
                         "parameters")
    dev = next(model.parameters()).device
    return AdamWState(count=int(count), notfinite=0, gnorm=0.0,
                      mu=[_tensor(by_name[n]).to(dev) for n in names],
                      nu=[_tensor(nu_by[n]).to(dev) for n in names])


def adamw_state_to_jax(model, opt: AdamWState
                       ) -> tuple[np.ndarray, np.ndarray]:
    """The port's moments as the JAX package's flat fp32 mu and nu over
    `ravel_pytree(params)`: the inverse of `adamw_state_from_jax`."""
    named = dict(zip((n for n, _ in model.named_parameters()),
                     zip(opt.mu, opt.nu)))
    order = sorted(named, key=lambda n: jax_path(n)[1])
    mu = [named[n][0].detach().cpu().float().reshape(-1) for n in order]
    nu = [named[n][1].detach().cpu().float().reshape(-1) for n in order]
    return torch.cat(mu).numpy(), torch.cat(nu).numpy()


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
