"""Training proof: the port LEARNS, on a generated JPEG corpus.

Port of scripts/train_proof.py (the JAX package's evidence harness), with
the same arguments, defaults, corpora, protocols, step and batch order. All
three runs train the flagship 224px architectures through the production
step (train/step.py: bf16, remat off, as the script's `_build`) and the
on-disk JPEG data plane (data/corpus.py writes the corpus; with no network
a procedural corpus stands in for staged ImageNet; data/loader.py decodes
it through the native decoder):

  overfit     imagenet-cls-224 memorizes 512 fixed JPEG images with fixed
              random labels (seed 11, as many classes as the model's
              outputs) to >= 95% train top-1 (eval preprocessing, one-hot
              labels, no mixup: the standard overfit protocol).
  generalize  imagenet-cls-224 trains on 2048 class-conditional images (10
              classes, seed 12) through the full pipeline (augmentation +
              CutMix/MixUp) and is scored on 512 held-out images: val
              top-1 above chance (0.1) is end-to-end learning.
  reg         imagenet-reg-224 (Huber + 0.1*KL) trains on the learnable
              corpus's train split; 4x4 reconstruction grids of 16 probe
              images before (after 30 warm-up power iterations, on a copy
              of u/v) and after training, and their MSE to the inputs.

Each run prints a steps-vs-metric table and writes train_proof_<mode>.json
(+ reg_*.png) under --out (docs/evidence/torch_h100 by default; never the
JAX package's docs/evidence/train_proof_*.json). The JSON holds the
script's keys, plus the card (`nvidia-smi` name and power limit), the
decoder used, ms per step (mean after the first), peak device memory, the
rope attention kernels' launches per step and every step's loss.

    python -m calm_vit_dte_tpu_torch.tools.train_proof overfit \\
        --steps 3000 --lr 1.5e-3 --eval-every 250
    python -m calm_vit_dte_tpu_torch.tools.train_proof generalize \\
        --steps 1500 --lr 1e-3 --eval-every 150
    python -m calm_vit_dte_tpu_torch.tools.train_proof reg \\
        --steps 400 --lr 1e-3 --eval-every 50

It runs on the card (`--device cuda`, the default) or raises; `--device
cpu` runs the plain PyTorch versions (the tests, at the tiny configs).
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import subprocess
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from calm_vit_dte_tpu_torch.data import native
from calm_vit_dte_tpu_torch.data.corpus import make_corpus
from calm_vit_dte_tpu_torch.data.loader import ImageFolderDataset
from calm_vit_dte_tpu_torch.data.pipeline import (
    make_cls_preprocess,
    make_eval_preprocess,
    make_reg_preprocess,
)
from calm_vit_dte_tpu_torch.kernels import axial_attention as ka
from calm_vit_dte_tpu_torch.kernels import conv_residual as kc
from calm_vit_dte_tpu_torch.models.factory import create_vit
from calm_vit_dte_tpu_torch.nn.spectral_norm import normalize_tree
from calm_vit_dte_tpu_torch.serve import WARMUP_POWER_ITERATIONS
from calm_vit_dte_tpu_torch.train.optim import make_optimizer
from calm_vit_dte_tpu_torch.train.state import create_train_state
from calm_vit_dte_tpu_torch.train.step import make_eval_step, make_train_step
from calm_vit_dte_tpu_torch.utils.configs import get_config
from calm_vit_dte_tpu_torch.utils.device import resolve_device

OUT = pathlib.Path(__file__).resolve().parents[2] / "docs" / "evidence" \
    / "torch_h100"
_TMP = pathlib.Path(tempfile.gettempdir())   # the corpora's default home


def _load_split(root, split: str, size: int):
    """A whole ImageFolder split decoded into memory through the production
    data plane; returns (images, labels, the dataset that decoded them)."""
    ds = ImageFolderDataset(root, split=split, size=size)
    imgs, labels = ds.load_batch(np.arange(len(ds)))
    print(f"decoded {len(ds)} {split} images with {ds.decoder}"
          + (f" ({ds.decoder_reason})" if ds.decoder_reason else "")
          + f"; {ds.pillow_images} by Pillow", flush=True)
    return imgs, labels.astype(np.int64), ds


def _decoder_record(*datasets) -> dict:
    """What decoded the splits (one decision per process: the library and
    CALM_NATIVE_DECODE), and how many images Pillow took per image."""
    return {"decoder": datasets[0].decoder,
            "decoder_reason": datasets[0].decoder_reason,
            "native_libjpeg": native.libjpeg(),
            "pillow_images": sum(ds.pillow_images for ds in datasets)}


def _card(dev: torch.device) -> dict:
    if dev.type != "cuda":
        return {"name": None, "nvidia_smi": None}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    return {"name": torch.cuda.get_device_name(dev), "nvidia_smi": smi}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _rope_launches() -> tuple[int, int]:
    return (ka.fused_rope_attention.launches,
            ka.fused_rope_attention_bwd.launches)


def _build(args, task: str, preprocess, dev: torch.device, init_seed: int,
           dtype=torch.bfloat16):
    """The script's `_build`: weights from `init_seed` (the config's, in
    the script), the optimizer over one epoch of --steps, state seed 1, the
    step in `dtype` (bf16 in the script) with remat off."""
    cfg = get_config(args.config)
    _, model = create_vit(args.config, seed=init_seed, device=dev)
    tx = make_optimizer(args.lr, cfg.weight_decay, cfg.beta1, cfg.beta2,
                        epochs=1, steps_per_epoch=args.steps)
    state = create_train_state(model, tx, seed=1)
    step_fn = make_train_step(cfg.model, tx, task, dtype=dtype,
                              remat=False, preprocess=preprocess)
    return cfg, state, step_fn


def _top1(state, cfg, imgs: torch.Tensor, labels: torch.Tensor,
          batch: int = 128) -> tuple[float, dict]:
    """Top-1 over a split through the production eval step (eval
    preprocessing, the bf16 forward on eval-mode weights), the tail
    wrap-padded with labels -1 (which no argmax matches); also the kernels
    launched per forward."""
    eval_step = make_eval_step(cfg.model, "cls")
    pre = make_eval_preprocess(cfg.crop)
    n = len(imgs)
    batch = min(batch, n)
    correct = forwards = 0
    a0, c0 = ka.fused_rope_attention.launches, kc.fused_conv_residual.launches
    for i in range(0, n, batch):
        im, lb = imgs[i:i + batch], labels[i:i + batch]
        if len(im) < batch:
            pad = batch - len(im)
            im = torch.cat([im, imgs[:pad]])
            lb = torch.cat([lb, torch.full((pad,), -1, dtype=lb.dtype,
                                           device=lb.device)])
        correct += int(eval_step(state, pre({"image": im,
                                             "label": lb}))["correct"])
        forwards += 1
    launches = {
        "attention": (ka.fused_rope_attention.launches - a0) / forwards,
        "conv": (kc.fused_conv_residual.launches - c0) / forwards}
    return correct / n, launches


class _Steps:
    """Runs the train step and keeps what the JSON reports: every step's
    loss, ms per step (host clock around each synchronised step), peak
    device memory and the rope kernels' launches per step."""

    def __init__(self, step_fn, dev: torch.device):
        self.step_fn, self.dev = step_fn, dev
        self.losses: list[torch.Tensor] = []
        self.kls: list[torch.Tensor] = []
        self.ms: list[float] = []
        self.launches: list[tuple[int, int]] = []
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)

    def __call__(self, state, batch):
        f0, b0 = _rope_launches()
        _sync(self.dev)
        t0 = time.perf_counter()
        state, metrics = self.step_fn(state, batch)
        _sync(self.dev)
        self.ms.append((time.perf_counter() - t0) * 1e3)
        f1, b1 = _rope_launches()
        self.launches.append((f1 - f0, b1 - b0))
        self.losses.append(metrics["loss"].detach().float())
        self.kls.append(metrics["kl"].detach().float())
        return state

    def window_loss(self, since: int) -> float:
        return float(torch.stack(self.losses[since:]).mean())

    def record(self) -> dict:
        fwd = sorted({f for f, _ in self.launches})
        bwd = sorted({b for _, b in self.launches})
        card = self.dev.type == "cuda"   # no device figures from a CPU run
        return {"ms_per_step": (float(np.mean(self.ms[1:]))
                                if card and len(self.ms) > 1 else None),
                "first_step_ms": self.ms[0] if card else None,
                "peak_mem_gib": (torch.cuda.max_memory_allocated(self.dev)
                                 / 2**30 if card else None),
                "rope_launches_per_step": {"attention_fwd": fwd,
                                           "attention_bwd": bwd},
                "step_losses": torch.stack(self.losses).cpu().tolist(),
                "step_kls": torch.stack(self.kls).cpu().tolist()}


def _write(out_dir: pathlib.Path, mode: str, out: dict) -> pathlib.Path:
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"train_proof_{mode}.json"
    path.write_text(json.dumps(out, indent=1))
    print(f"wrote {path}", flush=True)
    return path


def _run_cls(args, mode: str, dev: torch.device) -> dict:
    t_start = time.time()
    tcfg = get_config(args.config)
    n_classes = tcfg.model.out_features
    if mode == "overfit":
        root = args.root or _TMP / f"calm_corpus_memorize_{n_classes}"
        make_corpus(root, n_train=args.n_train, n_val=0,
                    num_classes=n_classes, size=args.corpus_size,
                    mode="memorize", seed=11)
        eval_split = "train"
    else:
        root = args.root or _TMP / "calm_corpus_learnable"
        make_corpus(root, n_train=args.n_train, n_val=args.n_train // 4,
                    num_classes=10, size=args.corpus_size,
                    mode="learnable", seed=12)
        eval_split = "val"

    size = tcfg.image_size
    tr_imgs, tr_labels, tr_ds = _load_split(root, "train", size)
    datasets = [tr_ds]
    if eval_split == "train":
        ev_imgs, ev_labels = tr_imgs, tr_labels
    else:
        ev_imgs, ev_labels, ev_ds = _load_split(root, eval_split, size)
        datasets.append(ev_ds)
    print(f"corpus: {len(tr_imgs)} train / {len(ev_imgs)} {eval_split} "
          f"images from {root}", flush=True)

    if mode == "overfit":
        # The standard overfit protocol: deterministic preprocessing (center
        # crop + normalize) and hard one-hot labels; no mixup, no jitter.
        evpre = make_eval_preprocess(tcfg.crop)

        def preprocess(generator, batch):
            b = evpre(batch)
            return {"image": b["image"],
                    "label": F.one_hot(b["label"], n_classes).float()}
    else:
        # The full production pipeline: augmentation + CutMix/MixUp.
        preprocess = make_cls_preprocess(n_classes, tcfg.crop)

    init_seed = tcfg.init_seed
    cfg, state, step_fn = _build(args, "cls", preprocess, dev, init_seed)
    tr_dev = torch.from_numpy(tr_imgs).to(dev)
    lab_dev = torch.from_numpy(tr_labels).to(dev)
    ev_dev = torch.from_numpy(ev_imgs).to(dev)
    ev_lab_dev = torch.from_numpy(ev_labels).to(dev)
    steps = _Steps(step_fn, dev)
    rng = np.random.default_rng(0)
    history = []
    eval_launches = None
    since = 0
    order = None
    for step in range(args.steps):
        if step % max(len(tr_imgs) // args.batch, 1) == 0:
            order = rng.permutation(len(tr_imgs))
        off = (step * args.batch) % max(len(tr_imgs) - args.batch + 1, 1)
        idx = torch.from_numpy(order[off:off + args.batch]).to(dev)
        state = steps(state, {"image": tr_dev.index_select(0, idx),
                              "label": lab_dev.index_select(0, idx)})
        if (step + 1) % args.eval_every == 0 or step + 1 == args.steps:
            acc, launches = _top1(state, cfg, ev_dev, ev_lab_dev)
            eval_launches = eval_launches or launches
            loss = steps.window_loss(since)
            since = len(steps.losses)
            history.append({"step": step + 1, "loss": round(loss, 4),
                            f"{eval_split}_top1": round(acc, 4)})
            print(f"step {step+1:5d}  loss {loss:8.4f}  "
                  f"{eval_split} top-1 {acc*100:6.2f}%", flush=True)

    out = {"mode": mode, "config": args.config, "batch": args.batch,
           "lr": args.lr, "steps": args.steps,
           "n_train": len(tr_imgs), "n_eval": len(ev_imgs),
           "eval_split": eval_split, "chance_top1": round(
               1.0 / (n_classes if mode == "overfit" else 10), 4),
           "wall_s": time.time() - t_start, "backend": dev.type,
           "init_seed": init_seed,
           "card": _card(dev), "corpus_size": args.corpus_size,
           "remat": False, "dtype": "bfloat16",
           **_decoder_record(*datasets), **steps.record(),
           "eval_launches_per_forward": eval_launches, "history": history}
    _write(pathlib.Path(args.out), mode, out)
    return out


def _grid(arr_f01: np.ndarray, path: pathlib.Path) -> None:
    """4x4 grid of (S, S, 3) float [0, 1] images -> PNG."""
    from PIL import Image

    s = arr_f01.shape[1]
    g = np.zeros((4 * s, 4 * s, 3), np.float32)
    for i in range(16):
        r, c = divmod(i, 4)
        g[r * s:(r + 1) * s, c * s:(c + 1) * s] = arr_f01[i]
    Image.fromarray(
        np.clip(np.round(g * 255), 0, 255).astype(np.uint8)).save(path)


def _reconstruct(state, cfg, imgs_u8: torch.Tensor, dtype) -> np.ndarray:
    """Sigmoid'd reconstructions (B, S, S, 3) through the production eval
    step."""
    pre = make_eval_preprocess(cfg.crop)
    tokens = make_eval_step(cfg.model, "reg", dtype=dtype)(
        state, pre({"image": imgs_u8}))["tokens"]
    n, s, _ = tokens.shape
    return torch.sigmoid(tokens.float()).reshape(n, s, s, 3).cpu().numpy()


def _run_reg(args, dev: torch.device, init_seed: int | None = None,
             dtype=torch.bfloat16) -> dict:
    """The reg proof. `init_seed` (default: the config's) and `dtype`
    (default: bf16, the script's) are for tools/reg_witness.py."""
    t_start = time.time()
    root = args.root or _TMP / "calm_corpus_learnable"
    make_corpus(root, n_train=args.n_train, n_val=args.n_train // 4,
                num_classes=10, size=args.corpus_size, mode="learnable",
                seed=12)
    tcfg = get_config(args.config)
    size = tcfg.image_size
    tr_imgs, _, tr_ds = _load_split(root, "train", size)
    if init_seed is None:
        init_seed = tcfg.init_seed
    cfg, state, step_fn = _build(args, "reg", make_reg_preprocess(tcfg.crop),
                                 dev, init_seed, dtype)
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    probe = tr_imgs[:16]
    probe_dev = torch.from_numpy(probe).to(dev)
    crop = cfg.crop
    top = (size - crop) // 2
    tgt = probe[:, top:top + crop, top:top + crop].astype(np.float32) / 255.0
    _grid(tgt, out_dir / "reg_inputs.png")
    # The step-0 probe needs a converged power iteration (raw-init u/v
    # under-estimate sigma and the deep eval forward overflows; serve.py's
    # Predictor.fresh does the same). As in the script, the iterations run
    # on a copy: training starts from the raw u/v.
    model = state.model
    raw_uv = {k: v.clone() for k, v in model.state_dict().items()
              if k.endswith(("weight_u", "weight_v"))}
    with torch.no_grad():
        for _ in range(WARMUP_POWER_ITERATIONS):
            normalize_tree(model, training=True)
    before = _reconstruct(state, cfg, probe_dev, dtype)
    model.load_state_dict(raw_uv, strict=False)
    _grid(before, out_dir / "reg_samples_step0.png")

    tr_dev = torch.from_numpy(tr_imgs).to(dev)
    steps = _Steps(step_fn, dev)
    rng = np.random.default_rng(0)
    history = []
    since = 0
    for step in range(args.steps):
        idx = torch.from_numpy(rng.choice(len(tr_imgs), args.batch,
                                          replace=False)).to(dev)
        state = steps(state, {"image": tr_dev.index_select(0, idx)})
        if (step + 1) % args.eval_every == 0 or step + 1 == args.steps:
            loss = steps.window_loss(since)
            since = len(steps.losses)
            history.append({"step": step + 1, "loss": round(loss, 5)})
            print(f"step {step+1:5d}  recon loss {loss:8.5f}", flush=True)

    after = _reconstruct(state, cfg, probe_dev, dtype)
    _grid(after, out_dir / f"reg_samples_step{args.steps}.png")
    # Trained reconstructions must be closer to the inputs.
    mse0 = float(np.mean((before - tgt) ** 2))
    mse1 = float(np.mean((after - tgt) ** 2))
    out = {"mode": "reg", "config": args.config, "batch": args.batch,
           "lr": args.lr, "steps": args.steps,
           "probe_mse_step0": mse0, f"probe_mse_step{args.steps}": mse1,
           "probe_step0_finite": math.isfinite(mse0),
           "n_train": len(tr_imgs),
           "wall_s": time.time() - t_start, "backend": dev.type,
           "init_seed": init_seed,
           "card": _card(dev), "corpus_size": args.corpus_size,
           "remat": False, "dtype": str(dtype).removeprefix("torch."),
           **_decoder_record(tr_ds), **steps.record(), "history": history}
    _write(out_dir, "reg", out)
    print(f"probe MSE {mse0:.5f} -> {mse1:.5f}", flush=True)
    return out


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", choices=["overfit", "generalize", "reg"])
    ap.add_argument("--config", default=None)
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--eval-every", type=int, default=100)
    ap.add_argument("--n-train", type=int, default=None,
                    help="corpus train-split size (default: 512 for "
                         "overfit, 2048 otherwise)")
    ap.add_argument("--root", default=None,
                    help="corpus dir (generated if absent; default under "
                         "the temporary directory, as the script's /tmp)")
    ap.add_argument("--corpus-size", type=int, default=384,
                    help="the corpus images' side in pixels (make_corpus's "
                         "default)")
    ap.add_argument("--out", default=str(OUT),
                    help="directory of the JSON and PNGs")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.config is None:
        args.config = ("imagenet-reg-224" if args.mode == "reg"
                       else "imagenet-cls-224")
    if args.n_train is None:
        args.n_train = 512 if args.mode == "overfit" else 2048
    return args


def run(argv: list[str] | None = None) -> dict:
    """Runs one proof; returns what it wrote to the JSON."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    if args.mode == "reg":
        return _run_reg(args, dev)
    return _run_cls(args, args.mode, dev)


if __name__ == "__main__":
    run()
