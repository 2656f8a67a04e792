"""Checkpoints of the full train state, and the warm start.

JAX counterpart: calm_vit_dte_tpu/train/checkpoint.py, which writes Orbax
checkpoints. The card's machine has no Orbax: here each save is one
`torch.save` file, `<path>/step_<step>.pt`, written under a temporary name
and renamed into place, so a reader sees a whole checkpoint or none. A
checkpoint holds what resume needs to continue the same run: the model's
state_dict (parameters, and the spectral-norm u/v buffers), the AdamW state
(count, skip counter, last gradient norm, moments) and the step. The seed is
saved too; `TrainState.generator` is a function of (seed, step, stream), so
a resumed run draws the noise the uninterrupted run would have drawn.

A directory that holds no `step_<n>.pt` but the JAX package's Orbax step
directories restores too (`restore_checkpoint`, `checkpoint_meta`), through
compat/orbax.py: both of its formats and both optimizer layouts, so the
trainers resume a JAX run's `checkpoint_dir`. Reading Orbax needs the
`tensorstore` package; where it is missing (the card's machine), restore
raises an ImportError that names it, and `python -m
calm_vit_dte_tpu_torch.compat.orbax import` converts on a host that has
it. The way back is `... compat.orbax export`. A state carried from Orbax
keeps the JAX key's data (`TrainState.jax_rng`) in the meta of the
checkpoints it saves.

A run over a mesh saves the same full file (global rank 0 writes it, the
tensor-parallel shards gathered first), so a checkpoint written at any
mesh restores at any other: every rank restores the full state, and the
trainer then keeps each rank's shard (`train.state.place_state`).
"""

from __future__ import annotations

import os
import re

import torch
import torch.distributed as dist

from calm_vit_dte_tpu_torch.train.state import TrainState, full_tensors

CKPT_FORMAT_VERSION = 1
_NAME = re.compile(r"^step_(\d+)\.pt$")


def _steps(path: str) -> list[int]:
    if not os.path.isdir(path):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match,
                                               os.listdir(path)) if m)


def _file(path: str, step: int) -> str:
    return os.path.join(path, f"step_{step}.pt")


def save_checkpoint(path: str, state: TrainState, step: int | None = None,
                    keep: int = 3) -> str:
    """Write `<path>/step_<step>.pt` atomically and keep the newest `keep`.
    Returns the file's path. On a mesh every rank calls it: the sharded
    weights and moments are gathered, global rank 0 writes the full state
    (the same file at any mesh), and all ranks leave together."""
    step = state.step if step is None else step
    model_sd, mu, nu = full_tensors(state)
    final = _file(path, step)
    if state.mesh is None or state.mesh.rank == 0:
        os.makedirs(path, exist_ok=True)
        opt = state.opt_state
        meta = {"format_version": CKPT_FORMAT_VERSION, "step": step}
        if state.jax_rng is not None:
            meta["jax_rng"] = [int(x) for x in state.jax_rng]
        payload = {
            "meta": meta,
            "seed": state.seed,
            "model": {k: v.detach().cpu() for k, v in model_sd.items()},
            "opt": {"count": opt.count, "notfinite": opt.notfinite,
                    "gnorm": torch.as_tensor(opt.gnorm).detach().cpu(),
                    "mu": [m.detach().cpu() for m in mu],
                    "nu": [n.detach().cpu() for n in nu]},
        }
        tmp = f"{final}.{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, final)
        for old in _steps(path)[:-keep]:
            os.remove(_file(path, old))
    if state.mesh is not None:
        dist.barrier()
    return final


def latest_step(path: str) -> int | None:
    steps = _steps(path)
    return steps[-1] if steps else None


def _load(path: str, step: int | None) -> dict | None:
    step = latest_step(path) if step is None else step
    if step is None:
        return None
    return torch.load(_file(path, step), map_location="cpu",
                      weights_only=True)


def _orbax_only(path: str) -> bool:
    """True if `path` holds Orbax step directories and no step_<n>.pt."""
    from calm_vit_dte_tpu_torch.compat import orbax

    return not _steps(path) and bool(orbax.steps(path))


def checkpoint_meta(path: str, step: int | None = None) -> dict | None:
    """The checkpoint's meta dict (format_version, step; jax_rng if the
    state came from Orbax); an Orbax checkpoint's own meta dict, with
    "orbax": True; None if there is no checkpoint."""
    if _orbax_only(path):
        from calm_vit_dte_tpu_torch.compat import orbax

        return dict(orbax.checkpoint_meta(path, step), orbax=True)
    ckpt = _load(path, step)
    return None if ckpt is None else dict(ckpt["meta"])


@torch.no_grad()
def restore_checkpoint(path: str, state: TrainState,
                       step: int | None = None) -> TrainState | None:
    """Load the newest (or the given) checkpoint into `state` in place, on
    the device its model is on, and return it; None if there is none. An
    Orbax directory keeps `state.seed`."""
    if state.sharded:
        raise ValueError("restore into the full state, then place it on the "
                         "mesh (train.state.place_state)")
    if _orbax_only(path):
        from calm_vit_dte_tpu_torch.compat import orbax

        return orbax.restore_state(path, state, step)
    ckpt = _load(path, step)
    if ckpt is None:
        return None
    state.model.load_state_dict(ckpt["model"])
    opt, saved = state.opt_state, ckpt["opt"]
    if len(saved["mu"]) != len(opt.mu):
        raise ValueError(f"checkpoint has {len(saved['mu'])} moment tensors,"
                         f" the state {len(opt.mu)}")
    for dst, src in zip(opt.mu + opt.nu, saved["mu"] + saved["nu"]):
        dst.copy_(src)
    opt.count, opt.notfinite = saved["count"], saved["notfinite"]
    opt.gnorm = saved["gnorm"].to(state.device)
    state.step, state.seed = ckpt["meta"]["step"], ckpt["seed"]
    state.jax_rng = ckpt["meta"].get("jax_rng")
    return state


def model_state_dict(path: str, step: int | None = None
                     ) -> dict[str, torch.Tensor] | None:
    """The model's state_dict (parameters and u/v) of the newest (or the
    given) checkpoint under `path`, of the port or of Orbax; None if there
    is none."""
    if _orbax_only(path):
        from calm_vit_dte_tpu_torch.compat import orbax
        from calm_vit_dte_tpu_torch.compat.from_jax import (
            state_dict_from_jax,
        )

        ck = orbax.read_orbax(path, step)
        return state_dict_from_jax(ck["params"], ck["sn_state"])
    ckpt = _load(path, step)
    return None if ckpt is None else ckpt["model"]


def warm_start_params(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """strict=False warm start from a reference .pth state_dict (reference
    distributed_trainer_cls.py:153-157). The port's parameter names are the
    original's, so the state_dict loads as it is; missing and unexpected
    keys are skipped with a note."""
    if not path.endswith(".pth"):
        raise ValueError(f"unsupported warm-start file: {path}")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    result = model.load_state_dict(sd, strict=False)
    if result.missing_keys or result.unexpected_keys:
        print(f"warm start: {len(result.missing_keys)} missing and "
              f"{len(result.unexpected_keys)} unexpected keys skipped",
              flush=True)
    return model
