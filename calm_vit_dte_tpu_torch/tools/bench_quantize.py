"""On-card A/B of the bf16 and int8 serving paths across batch sizes.

Port of scripts/bench_quantize.py, with its arguments and output fields.
The flagship Predictor, fresh from seed 0, classifies resident uint8
256x256 images at each batch size in bf16 and in each int8 mode (`int8`:
w8a8, per-token activation scales and `torch._int_mm`; `int8-wo`: w8a16),
and one JSON row per (batch, mode) gives images/s and p50 ms of both
(warm-up 3, then the median of 4 chains of 5 forwards, the card
synchronised before each clock read), the speedup, and the int8 logits
against bf16: the relative error and the top-1 agreement, held to
tests/test_quantize.py:157-162's limits (relative error < 0.15, agreement
>= 0.75) at every config; a row beyond them, or a non-finite logit, makes
the tool exit non-zero.
The rows also carry the kernels launched per int8 forward.

Writes quantize.json under --out (docs/evidence/torch_h100 by default)
with the card's `nvidia-smi` name and power limit. Runs on the card unless
`--device cpu`.

    python -m calm_vit_dte_tpu_torch.tools.bench_quantize \\
        [--batches 8,32,128] [--quantize int8,int8-wo]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from calm_vit_dte_tpu_torch.tools._common import OUT

REL_ERR_LIMIT = 0.15      # tests/test_quantize.py:157
TOP1_AGREE_LIMIT = 0.75   # tests/test_quantize.py:158-162 (3 of 4)


def measure(p, batch: int, size: int, dev: torch.device, warmup: int = 3,
            iters: int = 20, chain: int = 5):
    """(images/s, p50 seconds a forward, fp32 logits as numpy, kernel
    launches per forward)."""
    from calm_vit_dte_tpu_torch.tools._common import time_predict

    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.integers(0, 256, (batch, size, size, 3),
                                         dtype=np.uint8)).to(dev)
    chain = min(chain, iters)
    p50, logits, per_forward = time_predict(p, imgs, dev, warmup,
                                            max(1, iters // chain), chain)
    logits = logits.float().cpu().numpy()
    if not np.all(np.isfinite(logits)):
        raise RuntimeError("non-finite logits")
    return batch / p50, p50, logits, per_forward


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="imagenet-cls-224")
    ap.add_argument("--batches", default="8,32,128")
    ap.add_argument("--quantize", default="int8,int8-wo",
                    help="quantized modes to A/B against bf16, "
                    "comma-separated (int8, int8-wo)")
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--iters", type=int, default=20,
                    help="timed forwards, in chains of 5")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--out", default=str(OUT))
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> dict:
    args = parse_args(argv)

    from calm_vit_dte_tpu_torch.serve import Predictor
    from calm_vit_dte_tpu_torch.tools._common import card, write_json
    from calm_vit_dte_tpu_torch.utils.configs import get_config
    from calm_vit_dte_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    modes = args.quantize.split(",")
    for m in modes:
        if m not in ("int8", "int8-wo"):
            raise ValueError(f"unknown quantize mode {m!r}")
    on_card = dev.type == "cuda"
    p_f = Predictor.fresh(args.config, seed=0, device=dev)
    p_q = {m: Predictor.fresh(args.config, seed=0, quantize=m, device=dev)
           for m in modes}
    size = get_config(args.config).image_size
    rows, failed = [], []
    for b in [int(x) for x in args.batches.split(",")]:
        ips_f, p50_f, out_f, _ = measure(p_f, b, size, dev, args.warmup,
                                         args.iters)
        for m in modes:
            ips_q, p50_q, out_q, launches = measure(p_q[m], b, size, dev,
                                                    args.warmup, args.iters)
            rel = float(np.linalg.norm(out_q - out_f)
                        / max(np.linalg.norm(out_f), 1e-9))
            agree = float((out_f.argmax(-1) == out_q.argmax(-1)).mean())
            row = {
                "batch": b, "mode": m,
                "bf16_img_s": round(ips_f, 1) if on_card else None,
                "bf16_p50_ms": round(p50_f * 1e3, 3) if on_card else None,
                "int8_img_s": round(ips_q, 1) if on_card else None,
                "int8_p50_ms": round(p50_q * 1e3, 3) if on_card else None,
                "speedup": round(ips_q / ips_f, 3) if on_card else None,
                "logit_rel_err": round(rel, 5), "top1_agree": round(agree, 4),
                "kernel_launches_per_forward": launches}
            rows.append(row)
            print(json.dumps(row), flush=True)
            if rel >= REL_ERR_LIMIT or agree < TOP1_AGREE_LIMIT:
                failed.append(f"B={b} {m}: rel {rel:.4f}, agree {agree:.3f}")
    out = {"config": args.config, "card": card(dev), "device": dev.type,
           "torch": torch.__version__, "rows": rows,
           "limits": {"logit_rel_err_below": REL_ERR_LIMIT,
                      "top1_agree_at_least": TOP1_AGREE_LIMIT},
           "failed": failed, "ts": time.time()}
    write_json(args.out, "quantize.json", out)
    if failed:
        raise SystemExit("int8 beyond tests/test_quantize.py's limits: "
                         + "; ".join(failed))
    return out


if __name__ == "__main__":
    main()
