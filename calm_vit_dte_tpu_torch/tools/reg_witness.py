"""Witness runs for the reg proof's loss mark: tools/train_proof.py's reg
protocol with one thing changed, so that a gap between the port's curve and
the JAX package's evidence can be put on a layer.

  --init-seed N    the weights' seed (the proof takes the config's, 0): the
                   spread of the protocol's result over initializations.
  --route plain    the rope attention's forward and backward run their
                   plain PyTorch versions on the card instead of the
                   kernels, and CALM_CONV_FUSED=0 puts the conv residual's
                   eval forward on its plain chain too (training takes the
                   plain chain on both routes): does the gap follow the
                   kernels?
  --dtype float32  the step and the probes in fp32, TF32 off: does it
                   follow bf16?
  --init jax       the JAX package's own initial weights at the seed
                   (compat/jax_init.py rebuilds them from the committed
                   table, every leaf's digest checked) instead of the
                   port's torch-drawn ones: does it follow the draw?

Every other argument is train_proof's. The JSON (train_proof_reg.json under
--out, by default docs/evidence/torch_h100/reg_witness/<route>_<dtype>_
seed<N>, or <route>_<dtype>_jaxinit_seed<N> under --init jax) holds
train_proof's keys, the route, the init (with the table's jax and numpy
versions under --init jax), and the kernels' launches over the whole run
(0 on the plain route).

    python -m calm_vit_dte_tpu_torch.tools.reg_witness --route plain \\
        --steps 400 --lr 1e-3 --eval-every 50
"""

from __future__ import annotations

import argparse
import contextlib
import os
import pathlib
import tempfile

import torch

from calm_vit_dte_tpu_torch.compat import jax_init
from calm_vit_dte_tpu_torch.kernels import axial_attention as ka
from calm_vit_dte_tpu_torch.kernels import conv_residual as kc
from calm_vit_dte_tpu_torch.tools import train_proof
from calm_vit_dte_tpu_torch.utils.configs import get_config
from calm_vit_dte_tpu_torch.utils.device import resolve_device

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@contextlib.contextmanager
def plain_route():
    """The rope attention's card launchers replaced by the plain versions
    (so no kernel launches and no launch is counted), and
    CALM_CONV_FUSED=0; both restored on exit."""
    saved = ka._launch, ka._launch_bwd
    conv_env = os.environ.get("CALM_CONV_FUSED")
    ka._launch = ka.fused_rope_attention_plain
    ka._launch_bwd = ka.fused_rope_attention_bwd_plain
    os.environ["CALM_CONV_FUSED"] = "0"
    try:
        yield
    finally:
        ka._launch, ka._launch_bwd = saved
        if conv_env is None:
            os.environ.pop("CALM_CONV_FUSED", None)
        else:
            os.environ["CALM_CONV_FUSED"] = conv_env


def _launches() -> dict:
    return {"attention_fwd": ka.fused_rope_attention.launches,
            "attention_bwd": ka.fused_rope_attention_bwd.launches,
            "conv_fwd": kc.fused_conv_residual.launches}


def _jax_weights(config: str, seed: int, tmp: str) -> tuple[str, dict]:
    """The JAX package's initial weights of `config` at `seed`, rebuilt
    from the committed table (compat/jax_init.py), as a reference-format
    .pth under `tmp`; and what the JSON records of the table."""
    path = jax_init.table_path(config, seed)
    if not path.is_file():
        raise FileNotFoundError(f"no JAX init table for {config} at seed "
                                f"{seed} ({path})")
    pth = os.path.join(tmp, "jax_init.pth")
    torch.save(jax_init.state_dict_from_jax_init(path), pth)
    table = jax_init.load_table(path)
    return pth, {"init": "jax", "jax_init_table": {
        "file": path.name,
        **{k: table[k] for k in ("jax_version", "jax_threefry_partitionable",
                                 "numpy_version", "draws")}}}


def run(argv: list[str] | None = None) -> dict:
    """One witness run; returns what it wrote to the JSON."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--init-seed", type=int, default=None)
    ap.add_argument("--route", choices=["kernels", "plain"],
                    default="kernels")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="bfloat16")
    ap.add_argument("--init", choices=["torch", "jax"], default="torch")
    ours, rest = ap.parse_known_args(argv)
    args = train_proof.parse_args(["reg", *rest])
    seed = (get_config(args.config).init_seed if ours.init_seed is None
            else ours.init_seed)
    jaxinit = "_jaxinit" if ours.init == "jax" else ""
    if "--out" not in rest:
        args.out = str(train_proof.OUT / "reg_witness"
                       / f"{ours.route}_{ours.dtype}{jaxinit}_seed{seed}")
    dev = resolve_device(args.device)
    dtype = DTYPES[ours.dtype]
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    if dtype == torch.float32:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    route = (plain_route() if ours.route == "plain"
             else contextlib.nullcontext())
    before = _launches()
    with tempfile.TemporaryDirectory() as tmp:
        weights, init = None, {"init": "torch"}
        if ours.init == "jax":
            weights, init = _jax_weights(args.config, seed, tmp)
        try:
            with route:
                out = train_proof._run_reg(args, dev, init_seed=seed,
                                           dtype=dtype, weights=weights)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = tf32
    after = _launches()
    out.update(init)
    out["route"] = ours.route
    out["kernel_launches_in_run"] = {k: after[k] - before[k] for k in after}
    train_proof._write(pathlib.Path(args.out), "reg", out)
    return out


if __name__ == "__main__":
    run()
