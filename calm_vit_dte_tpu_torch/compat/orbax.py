"""The JAX package's Orbax checkpoints, read and written without jax.

JAX counterpart: calm_vit_dte_tpu/train/checkpoint.py. A checkpoint
directory holds one directory per step (`<path>/<step>/`, the newest step
is the largest number, as `CheckpointManager.latest_step` finds it):
  format 2: `state/`, the TrainState (params, sn_state, opt_state, step,
            rng) as one array per leaf, and `meta/metadata`, JSON with
            format_version, opt_layout and step;
  format 1: the bare state, no meta (rounds 1-4), in `default/` (or, from
            older Orbax, in the step directory itself).
The state's `_METADATA` lists each leaf's key path and says how the arrays
are stored: `use_ocdbt` (one OCDBT key-value store of zarr arrays, what the
JAX package writes) or one zarr directory per leaf, zarr v2 or
`use_zarr3`. Both optimizer layouts are read, as `migrate_opt_state` maps
them: `fused-flat` (count, notfinite, gnorm and the flat fp32 mu and nu of
FusedAdamWState) and `tree` (optax's apply_if_finite(chain(clip, adamw)):
count and per-leaf moments from its ScaleByAdamState, notfinite from
`notfinite_count`, gnorm 0).

Reading goes through the `tensorstore` package (an Orbax dependency, which
imports no jax); it is imported inside `read_orbax` only, and a host without
it gets an ImportError that names it. The card's machine has no
tensorstore: convert there from a host that has it,

    python -m calm_vit_dte_tpu_torch.compat.orbax import SRC DST \\
        --config imagenet-cls-224

writes `DST/step_<n>.pt` in the port's format (train/checkpoint.py), and

    python -m calm_vit_dte_tpu_torch.compat.orbax export SRC DST \\
        --config imagenet-cls-224

turns the port's newest `SRC/step_<n>.pt` into `DST/<n>/`, a format-2,
`fused-flat` checkpoint (the layout the JAX trainer writes on its
data-parallel path) that the JAX package's `restore_checkpoint` restores,
into a tree-layout template too through its own migration. Writing needs
numpy only: each leaf is one uncompressed zarr v2 array (`use_ocdbt`
false), beside the JSON files Orbax reads.

The port's TrainState carries a seed where the JAX state carries a PRNG
key. An import keeps the key's data (`TrainState.jax_rng`, saved in the
`.pt`'s meta) and an export writes it back unchanged; a port state with
none exports the key `PRNGKey(seed)` would give, [0, seed]. The port's
seed comes from `--seed` (default: the config's init_seed + 1, the
trainer's). So a run resumed across the packages continues the weights,
moments and step exactly, but its dropout and variational noise from then
on are the resuming package's draws, not the ones the other package would
have made.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import shutil
import time

import numpy as np

from calm_vit_dte_tpu_torch.compat.from_jax import (
    adamw_state_from_jax,
    adamw_state_from_jax_tree,
    adamw_state_to_jax,
    jax_trees,
    state_dict_from_jax,
)

FORMAT_VERSION = 2
_HANDLERS = "orbax.checkpoint._src.handlers."
_ZARR_DTYPES = {np.dtype("float32"): "<f4", np.dtype("int32"): "<i4",
                np.dtype("uint32"): "<u4"}


def steps(path: str | os.PathLike) -> list[int]:
    """The Orbax step directories under `path`, oldest first."""
    if not os.path.isdir(path):
        return []
    return sorted(int(d) for d in os.listdir(path)
                  if d.isdigit() and os.path.isdir(os.path.join(path, d)))


def latest_step(path: str | os.PathLike) -> int | None:
    found = steps(path)
    return found[-1] if found else None


def _item_dir(step_dir: pathlib.Path) -> pathlib.Path:
    for item in (step_dir / "state", step_dir / "default", step_dir):
        if (item / "_METADATA").is_file():
            return item
    raise ValueError(f"{step_dir} is no Orbax checkpoint step: it holds no "
                     "state item with a _METADATA")


def checkpoint_meta(path: str | os.PathLike,
                    step: int | None = None) -> dict | None:
    """The checkpoint's meta dict, {'format_version': 1} for a checkpoint
    with no meta item, None if there is no checkpoint. Needs no
    tensorstore."""
    step = latest_step(path) if step is None else step
    if step is None:
        return None
    meta = pathlib.Path(path) / str(step) / "meta" / "metadata"
    if meta.is_file():
        return json.loads(meta.read_text())
    return {"format_version": 1}


def _tree_from_metadata(item: pathlib.Path) -> tuple[dict, list]:
    """The _METADATA's flags and the key paths of the leaves it stores."""
    meta = json.loads((item / "_METADATA").read_text())
    leaves = []
    for entry in meta["tree_metadata"].values():
        if entry["value_metadata"].get("skip_deserialize"):
            continue   # None leaves: optax's EmptyState and the like
        leaves.append([k["key"] for k in entry["key_metadata"]])
    return meta, leaves


def read_orbax(path: str | os.PathLike, step: int | None = None
               ) -> dict | None:
    """The newest (or the given) step's state as numpy: {"params",
    "sn_state" (nested dicts), "opt": {"layout", "count", "notfinite",
    "gnorm", "mu", "nu"} (mu and nu flat for fused-flat, trees keyed like
    params for tree), "step", "rng" (the key's uint32 data), "meta"}; None
    if `path` holds no step."""
    try:
        import tensorstore as ts
    except ImportError as e:
        raise ImportError(
            "reading an Orbax checkpoint needs the tensorstore package, "
            "which this host lacks; convert the checkpoint where it is "
            "installed: python -m calm_vit_dte_tpu_torch.compat.orbax "
            "import SRC DST --config NAME") from e
    step = latest_step(path) if step is None else step
    if step is None:
        return None
    item = _item_dir(pathlib.Path(path).resolve() / str(step))
    meta, leaves = _tree_from_metadata(item)
    driver = "zarr3" if meta.get("use_zarr3") else "zarr"
    context = ts.Context()
    futures = []
    for keys in leaves:
        name = ".".join(keys)
        if meta.get("use_ocdbt"):
            spec = {"driver": driver, "path": name,
                    "kvstore": {"driver": "ocdbt",
                                "base": f"file://{item}/"}}
        else:
            spec = {"driver": driver,
                    "kvstore": {"driver": "file",
                                "path": str(item / name)}}
        futures.append(ts.open(spec, open=True, read=True, context=context))
    # Every open, then every read, is issued before any is waited on.
    reads = [fut.result().read() for fut in futures]
    tree: dict = {}
    for keys, read in zip(leaves, reads):
        arr = np.asarray(read.result())
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = arr
    return {"params": tree["params"], "sn_state": tree.get("sn_state", {}),
            "opt": _opt_from_tree(tree["opt_state"]),
            "step": int(tree["step"]),
            "rng": [int(x) for x in np.asarray(tree["rng"]).ravel()],
            "meta": checkpoint_meta(path, step)}


def _find_adam(node) -> list[dict]:
    """The subtrees holding a ScaleByAdamState's count, mu and nu."""
    if not isinstance(node, dict):
        return []
    if {"count", "mu", "nu"} <= set(node) and isinstance(node["mu"], dict):
        return [node]
    return [found for v in node.values() for found in _find_adam(v)]


def _opt_from_tree(opt: dict) -> dict:
    if isinstance(opt.get("mu"), np.ndarray):   # FusedAdamWState
        return {"layout": "fused-flat", "count": int(opt["count"]),
                "notfinite": int(opt["notfinite"]),
                "gnorm": float(opt.get("gnorm", 0.0)),
                "mu": opt["mu"], "nu": opt["nu"]}
    adam = _find_adam(opt)
    if len(adam) != 1:
        raise ValueError(f"expected one ScaleByAdamState in the optimizer "
                         f"state, found {len(adam)}")
    return {"layout": "tree", "count": int(adam[0]["count"]),
            "notfinite": int(opt.get("notfinite_count", 0)), "gnorm": 0.0,
            "mu": adam[0]["mu"], "nu": adam[0]["nu"]}


def restore_state(path: str | os.PathLike, state, step: int | None = None):
    """Load the newest (or the given) Orbax step into the port's TrainState
    `state` in place, on its model's device; None if there is none."""
    import torch

    ck = read_orbax(path, step)
    if ck is None:
        return None
    model = state.model
    model.load_state_dict(state_dict_from_jax(ck["params"], ck["sn_state"]))
    opt = ck["opt"]
    if opt["layout"] == "fused-flat":
        new = adamw_state_from_jax(ck["params"], opt["count"], opt["mu"],
                                   opt["nu"], model)
    else:
        new = adamw_state_from_jax_tree(opt["count"], opt["mu"], opt["nu"],
                                        model)
    dst = state.opt_state
    with torch.no_grad():
        for d, s in zip(dst.mu + dst.nu, new.mu + new.nu):
            d.copy_(s)
    dst.count, dst.notfinite = opt["count"], opt["notfinite"]
    dst.gnorm = torch.tensor(opt["gnorm"], dtype=torch.float32,
                             device=state.device)
    state.step, state.jax_rng = ck["step"], ck["rng"]
    return state


# Writing: format 2, fused-flat, one uncompressed zarr v2 array a leaf.

def _flatten(tree: dict, prefix: tuple = ()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flatten(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


def _write_zarr(directory: pathlib.Path, arr: np.ndarray) -> None:
    dtype = _ZARR_DTYPES[arr.dtype]
    directory.mkdir(parents=True)
    shape = list(arr.shape)
    (directory / ".zarray").write_text(json.dumps({
        "chunks": shape, "compressor": None, "dimension_separator": ".",
        "dtype": dtype, "fill_value": None, "filters": None, "order": "C",
        "shape": shape, "zarr_format": 2}))
    chunk = ".".join("0" for _ in shape) or "0"
    (directory / chunk).write_bytes(
        np.ascontiguousarray(arr, dtype=dtype).tobytes())


def write_orbax(path: str | os.PathLike, step: int, params: dict,
                sn_state: dict, opt: dict, rng) -> pathlib.Path:
    """Write `<path>/<step>/` as the JAX package's `save_checkpoint` lays
    out a fused-flat TrainState: `opt` holds count, notfinite, gnorm and
    the flat fp32 mu and nu over `ravel_pytree(params)`. The step is
    written under a temporary name and renamed into place. Returns the
    step directory."""
    path = pathlib.Path(path).resolve()
    final = path / str(step)
    if final.exists():
        raise FileExistsError(f"{final} exists")
    tmp = path / f"{step}.port-tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    state = {"params": params, "sn_state": sn_state,
             "opt_state": {
                 "count": np.asarray(opt["count"], np.int32),
                 "notfinite": np.asarray(opt["notfinite"], np.int32),
                 "gnorm": np.asarray(opt["gnorm"], np.float32),
                 "mu": np.asarray(opt["mu"], np.float32),
                 "nu": np.asarray(opt["nu"], np.float32)},
             "step": np.asarray(step, np.int32),
             "rng": np.asarray(rng, np.uint32)}
    tree_metadata = {}
    for keys, leaf in _flatten(state):
        arr = np.asarray(leaf)
        if arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        _write_zarr(tmp / "state" / ".".join(keys), arr)
        tree_metadata[str(keys)] = {
            "key_metadata": [{"key": k, "key_type": 2} for k in keys],
            "value_metadata": {"value_type": "jax.Array",
                               "skip_deserialize": False,
                               "write_shape": list(arr.shape)}}
    (tmp / "state" / "_METADATA").write_text(json.dumps({
        "tree_metadata": tree_metadata, "use_ocdbt": False,
        "use_zarr3": False, "store_array_data_equal_to_fill_value": True,
        "custom_metadata": None}))
    (tmp / "meta").mkdir()
    (tmp / "meta" / "metadata").write_text(json.dumps({
        "format_version": FORMAT_VERSION, "opt_layout": "fused-flat",
        "step": step}))
    now = time.time_ns()
    (tmp / "_CHECKPOINT_METADATA").write_text(json.dumps({
        "item_handlers": {
            "meta": _HANDLERS + "json_checkpoint_handler."
                    "JsonCheckpointHandler",
            "state": _HANDLERS + "standard_checkpoint_handler."
                     "StandardCheckpointHandler"},
        "metrics": {}, "performance_metrics": {},
        "init_timestamp_nsecs": now, "commit_timestamp_nsecs": now,
        "custom_metadata": {}}))
    os.replace(tmp, final)
    return final


def export_state(path: str | os.PathLike, state,
                 step: int | None = None) -> pathlib.Path:
    """Write the port's TrainState `state` as `<path>/<step>/` (default:
    its step) for the JAX package."""
    params, sn_state = jax_trees(state.model.state_dict())
    mu, nu = adamw_state_to_jax(state.model, state.opt_state)
    opt = state.opt_state
    rng = state.jax_rng if state.jax_rng is not None else [0, state.seed]
    return write_orbax(path, state.step if step is None else step, params,
                       sn_state, {"count": opt.count,
                                  "notfinite": opt.notfinite,
                                  "gnorm": float(opt.gnorm),
                                  "mu": mu, "nu": nu}, rng)


def _cpu_state(config: str, seed: int | None):
    from calm_vit_dte_tpu_torch.models.factory import create_vit
    from calm_vit_dte_tpu_torch.train.optim import make_optimizer
    from calm_vit_dte_tpu_torch.train.state import create_train_state
    from calm_vit_dte_tpu_torch.utils.configs import get_config

    init_seed = get_config(config).init_seed
    _, model = create_vit(config, seed=init_seed, device="cpu")
    return create_train_state(
        model, make_optimizer(),
        seed=init_seed + 1 if seed is None else seed)


def import_checkpoint(src: str, dst: str, config: str,
                      seed: int | None = None,
                      step: int | None = None) -> str:
    """An Orbax checkpoint of the JAX package -> `dst/step_<n>.pt`."""
    from calm_vit_dte_tpu_torch.train.checkpoint import save_checkpoint

    state = _cpu_state(config, seed)
    if restore_state(src, state, step) is None:
        raise FileNotFoundError(f"no Orbax checkpoint under {src}")
    return save_checkpoint(dst, state)


def export_checkpoint(src: str, dst: str, config: str,
                      seed: int | None = None,
                      step: int | None = None) -> pathlib.Path:
    """The port's `src/step_<n>.pt` -> the Orbax step `dst/<n>/`."""
    from calm_vit_dte_tpu_torch.train.checkpoint import restore_checkpoint

    state = _cpu_state(config, seed)
    if restore_checkpoint(src, state, step) is None:
        raise FileNotFoundError(f"no checkpoint of the port under {src}")
    return export_state(dst, state)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(
        description="Convert checkpoints between the JAX package's Orbax "
                    "format and the port's step_<n>.pt.")
    ap.add_argument("direction", choices=["import", "export"])
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("--config", required=True)
    ap.add_argument("--seed", type=int, default=None,
                    help="the port's TrainState seed (default: the "
                         "config's init_seed + 1)")
    ap.add_argument("--step", type=int, default=None)
    args = ap.parse_args(argv)
    fn = import_checkpoint if args.direction == "import" \
        else export_checkpoint
    out = fn(args.src, args.dst, args.config, args.seed, args.step)
    print(f"{args.direction}: {args.src} -> {out}", flush=True)


if __name__ == "__main__":
    main()
