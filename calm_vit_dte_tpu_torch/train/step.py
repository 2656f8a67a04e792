"""Train and eval steps for the two reference workloads.

JAX counterpart: calm_vit_dte_tpu/train/step.py. Classification: forward in
the compute dtype, CE on CutMix/MixUp soft labels, global-norm clip 1.0,
AdamW; metrics loss, dominant-class accuracy, kl, grad_norm. Reconstruction:
Huber(recon, input) + 0.1 * KL.

The step functions take and return a TrainState, like the JAX ones, but
update the model and the optimizer state in place. As in the JAX step:
  * the spectral-norm pre-pass is hoisted: `normalize_tree` runs once per
    step (one power iteration, however many microbatches), the model runs on
    those weights inside `prenormalized_scope`, the microbatches' gradients
    accumulate on the normalized weights, and ONE backward through the
    pre-pass pulls the sum back to the raw weights (exact, by linearity);
  * `microbatches` > 1 accumulates the running mean of gradients and metrics
    over equal slices of the batch, each with its own noise stream, and
    applies one optimizer update;
  * `remat` checkpoints each Block and keeps the attention outputs
    (utils/remat.py), so the backward launches the fused attention forward
    no second time;
  * the compute dtype is explicit (`dtype`, bf16 by default), as everywhere
    in this package; parameters, LayerNorm, the variational math and the
    losses stay fp32.

On a mesh (`state.mesh`, parallel/mesh.py) the step is the JAX GSPMD
step's counterpart: each rank holds its data rank's rows of the global
batch, every draw has the global shape (`batch_shard`), and after the
pre-pass's pull-back the gradients and the metrics are averaged in one
all-reduce (data parallelism alone). Under tensor parallelism the pre-pass
runs on the weights gathered from their row shards, each rank keeps its
rows of the full gradient (averaged over the data ranks), and the
replicated gradients and metrics are averaged over every rank. `microbatches` > 1 splits each rank's rows, where the
JAX step splits the global batch: the same rows meet other noise rows
(ROADMAP, recorded divergences).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from calm_vit_dte_tpu_torch.models.vit import ViTConfig
from calm_vit_dte_tpu_torch.nn.spectral_norm import (
    normalize_tree,
    prenormalized_scope,
)
from calm_vit_dte_tpu_torch.parallel.mesh import (
    average_,
    batch_shard,
    shard_rows,
)
from calm_vit_dte_tpu_torch.train.losses import (
    dominant_class_accuracy,
    reconstruction_loss,
    softmax_cross_entropy,
)
from calm_vit_dte_tpu_torch.train.optim import FusedAdamW
from calm_vit_dte_tpu_torch.train.state import TrainState, full_weights


def _on_device(batch: dict[str, Any], device) -> dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _check(cfg: ViTConfig, task: str, state_cfg: ViTConfig | None = None):
    if task not in ("cls", "reg"):
        raise ValueError(task)
    if state_cfg is not None and state_cfg != cfg:
        raise ValueError("the state's model was built from another config")


def make_train_step(cfg: ViTConfig, tx: FusedAdamW, task: str,
                    dtype=torch.bfloat16, remat: bool = True,
                    preprocess: Callable | None = None,
                    microbatches: int = 1) -> Callable:
    """task: 'cls' (CE on soft labels) or 'reg' (Huber + 0.1*KL).

    `preprocess(generator, batch) -> batch` runs on the device at the start
    of the step, so host-to-device traffic is the raw batch. Returns
    train_step(state, batch) -> (state, metrics); metrics are 0-d tensors on
    the model's device, and the step's gradients stay in each parameter's
    `.grad` until the next step. The model runs where its parameters are:
    build it with device="cpu" for a CPU run.
    """
    _check(cfg, task)
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    k = microbatches

    def loss_fn(model, mb, generator):
        out, kl = model(mb["image"], dtype=dtype, generator=generator,
                        remat=remat)
        if task == "cls":
            loss = softmax_cross_entropy(out, mb["label"])
            metrics = {"loss": loss,
                       "accuracy": dominant_class_accuracy(out, mb["label"]),
                       "kl": kl}
        else:
            loss = reconstruction_loss(out, mb["image"], kl)
            metrics = {"loss": loss, "kl": kl}
        return loss, metrics

    def train_step(state: TrainState, batch: dict[str, Any]):
        model = state.model
        _check(cfg, task, model.cfg)
        model.train()
        mesh = state.mesh
        batch = _on_device(batch, state.device)
        params = list(model.parameters())
        for p in params:
            p.grad = None
        metrics: dict[str, torch.Tensor] = {}
        with batch_shard(mesh):
            if preprocess is not None:
                batch = preprocess(state.generator(1), batch)
            b = next(iter(batch.values())).shape[0]
            if b % k != 0:
                raise ValueError(
                    f"batch {b} not divisible by microbatches {k}")

            # The hoisted pre-pass: graph tensors w/sigma, u/v updated once.
            # Under tensor parallelism it runs on the gathered full weights.
            full = {m: w.requires_grad_()
                    for m, w in full_weights(state).items()}
            normed = normalize_tree(model, training=True, weights=full)
            leaves = {m: w.detach().requires_grad_()
                      for m, w in normed.items()}
            with prenormalized_scope(leaves):
                for i in range(k):
                    mb = {name: v[i * (b // k):(i + 1) * (b // k)]
                          for name, v in batch.items()}
                    loss, metrics_i = loss_fn(
                        model, mb, state.generator(0 if k == 1 else 2 + i))
                    (loss / k).backward()   # running mean of the gradients
                    for name, v in metrics_i.items():
                        metrics[name] = (metrics.get(name, 0.0)
                                         + v.detach() / k)
        # One pull-back through the pre-pass for the accumulated gradient.
        used = [m for m in normed if leaves[m].grad is not None]
        torch.autograd.backward([normed[m] for m in used],
                                [leaves[m].grad for m in used])

        named = list(model.named_parameters())
        shard = [name in state.sharded for name, _ in named]
        for (name, p), sharded in zip(named, shard):
            if sharded:   # this model rank's rows of the full gradient
                g = full[model.get_submodule(name.rsplit(".", 1)[0])].grad
                p.grad = None if g is None else shard_rows(g, mesh)
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        if mesh is None:
            tx.update(params, grads, state.opt_state)
        else:
            grads, metrics = _mean_over_ranks(grads, shard, metrics, mesh)
            for p, g in zip(params, grads):
                p.grad = g
            tx.update(params, grads, state.opt_state, sharded=shard,
                      mesh=mesh)
        metrics["grad_norm"] = state.opt_state.gnorm
        state.step += 1
        return state, metrics

    return train_step


def _mean_over_ranks(grads: list[torch.Tensor], shard: list[bool],
                     metrics: dict, mesh) -> tuple[list, dict]:
    """The replicated gradients and the metrics averaged over every rank
    (one all-reduce), each shard's rows over the data ranks (one more,
    under tensor parallelism)."""
    keys = list(metrics)
    repl = [g for g, s in zip(grads, shard) if not s]
    mean = average_(repl + [metrics[key] for key in keys], None, mesh.size)
    rows = [g for g, s in zip(grads, shard) if s]
    if rows and mesh.data > 1:
        rows = average_(rows, mesh.data_group, mesh.data)
    repl_it, rows_it = iter(mean[:len(repl)]), iter(rows)
    return ([next(rows_it) if s else next(repl_it) for s in shard],
            dict(zip(keys, mean[len(repl):])))


def make_eval_step(cfg: ViTConfig, task: str,
                   dtype=torch.bfloat16) -> Callable:
    _check(cfg, task)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict[str, Any]):
        model = state.model
        _check(cfg, task, model.cfg)
        model.eval()
        batch = _on_device(batch, state.device)
        with prenormalized_scope(normalize_tree(
                model, training=False, weights=full_weights(state))):
            out, kl = model(batch["image"], dtype=dtype)
        if task == "cls":
            correct = (out.argmax(dim=-1) == batch["label"]).sum()
            return {"correct": correct,
                    "total": torch.tensor(batch["label"].shape[0]),
                    "kl": kl}
        return {"loss": reconstruction_loss(out, batch["image"], kl),
                "kl": kl, "tokens": out}

    return eval_step
