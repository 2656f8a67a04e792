"""hires-cls-1024 serving on one card: bf16, int8 (w8a8) and int8-wo (w8a16).

Port of scripts/bench_hires_serve.py, with its arguments and fields. For
each mode and batch, `Predictor.fresh("hires-cls-1024", quantize=...)`
classifies resident uint8 1168x1168 images: images/s and p50 ms (the
median of 3 chains of 3 forwards after 2 warm-up forwards, the card
synchronised before each clock read), whether the logits are finite, the
peak device memory, and the kernels launched per forward. Where the JAX
script catches every error and exits 0, an error here is written into the
JSON and the tool exits non-zero.

Writes hires_serve.json under --out (docs/evidence/torch_h100 by
default) with the card's `nvidia-smi` name and power limit. Runs on the
card unless `--device cpu` (with --config tiny-cls, for the tests).

    python -m calm_vit_dte_tpu_torch.tools.bench_hires_serve \\
        [--batch 1,8] [--modes bf16,int8,int8-wo]
"""

from __future__ import annotations

import argparse
import gc
import json
import time

import numpy as np
import torch

from calm_vit_dte_tpu_torch.tools._common import OUT


def measure(p, batch: int, size: int, dev: torch.device, warmup: int = 2,
            chains: int = 3, chain: int = 3):
    """(images/s, p50 seconds a forward, logits finite, kernel launches per
    forward) of `p.predict` on a resident uint8 batch."""
    from calm_vit_dte_tpu_torch.tools._common import time_predict

    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.integers(0, 256, (batch, size, size, 3),
                                         dtype=np.uint8)).to(dev)
    p50, logits, per_forward = time_predict(p, imgs, dev, warmup, chains,
                                            chain)
    return batch / p50, p50, bool(torch.isfinite(logits.float()).all()), \
        per_forward


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", default="1,8",
                    help="batch sizes, comma-separated")
    ap.add_argument("--modes", default="bf16,int8,int8-wo")
    ap.add_argument("--config", default="hires-cls-1024")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--out", default=str(OUT))
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> dict:
    args = parse_args(argv)

    from calm_vit_dte_tpu_torch.serve import Predictor
    from calm_vit_dte_tpu_torch.tools._common import (
        card,
        peak_gib,
        reset_peak,
        write_json,
    )
    from calm_vit_dte_tpu_torch.utils.configs import get_config
    from calm_vit_dte_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    size = get_config(args.config).image_size
    rows, errors = [], []
    for mode in args.modes.split(","):
        q = None if mode == "bf16" else mode
        p = None
        try:
            p = Predictor.fresh(args.config, seed=0, quantize=q, device=dev)
            for b in [int(x) for x in args.batch.split(",")]:
                reset_peak(dev)   # the peak of the resident weights + b
                ips, p50, ok, launches = measure(p, b, size, dev)
                row = {"mode": mode, "batch": b,
                       "img_s_chip": round(ips, 3) if dev.type == "cuda"
                       else None,
                       "p50_ms": round(p50 * 1e3, 3) if dev.type == "cuda"
                       else None,
                       "finite": ok, "peak_mem_gib": peak_gib(dev),
                       "kernel_launches_per_forward": launches}
                rows.append(row)
                print(json.dumps(row), flush=True)
                if not ok:
                    errors.append(f"{mode} B={b}: non-finite logits")
        except Exception as e:  # noqa: BLE001 - recorded; exit 1 below
            errors.append(f"{mode}: {type(e).__name__}: {e}"[:2000])
            rows.append({"mode": mode, "error": errors[-1]})
        finally:
            del p
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    out = {"config": args.config, "card": card(dev), "device": dev.type,
           "torch": torch.__version__, "image_size": size, "rows": rows,
           "status": "failed" if errors else "served", "errors": errors,
           "ts": time.time()}
    write_json(args.out, "hires_serve.json", out)
    if errors:
        raise SystemExit("hires serving failed: " + "; ".join(errors))
    return out


if __name__ == "__main__":
    main()
