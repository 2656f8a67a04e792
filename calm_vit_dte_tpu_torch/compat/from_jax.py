"""Weight carry: the JAX package's (params, sn_state) pytrees -> the port's
state_dict.

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


def state_dict_from_jax(params: dict,
                        sn_state: dict) -> dict[str, torch.Tensor]:
    """Flatten the JAX (params, sn_state) into the port's fp32 state_dict."""
    sd: dict[str, torch.Tensor] = {}

    def tensor(x) -> torch.Tensor:
        return torch.from_numpy(np.array(x, dtype=np.float32))

    def walk_params(node, path):
        if not isinstance(node, dict):
            name = path[-1]
            prefix = ".".join(_rename_back(path[:-1]))
            suffix = {"w": "weight_orig", "b": "bias", "scale": "weight",
                      "inv_freq": "inv_freq"}.get(name)
            if suffix is not None:
                sd[f"{prefix}.{suffix}"] = tensor(node)
            elif name in ("ls_att", "ls_mlp"):
                sd[".".join(_rename_back(path))] = tensor(node)
            else:
                raise KeyError(f"unmapped param leaf {'.'.join(path)}")
            return
        for k, v in node.items():
            walk_params(v, path + [k])

    def walk_state(node, path):
        if isinstance(node, dict) and "u" in node and "v" in node:
            prefix = ".".join(_rename_back(path))
            sd[f"{prefix}.weight_u"] = tensor(node["u"])
            sd[f"{prefix}.weight_v"] = tensor(node["v"])
            return
        for k, v in node.items():
            walk_state(v, path + [k])

    walk_params(params, [])
    walk_state(sn_state, [])
    return sd
