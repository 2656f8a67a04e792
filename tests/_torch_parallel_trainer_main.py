"""Subprocess entry for tests/test_torch_parallel_trainer.py: one rank of
the port's trainer (and evaluation) over gloo on the CPU, with torchrun's
environment set and the process group initialized here (60 s timeout).

Usage: python tests/_torch_parallel_trainer_main.py <port> <rank> <world>
           <mode> <ckpt_dir> [key=value ...]
  mode train  train_cls.main for --max-steps N (steps=N in the overrides),
              then print this rank's sampler shard, the digest of the
              gathered final state and, with val_root=DIR, evaluate() of
              the checkpoint over DIR's val split;
  mode run    train_cls.main until SIGTERM (or the epoch's end).
"""

import datetime
import hashlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def state_digest(sd: dict, mu: list, nu: list, counters: tuple) -> str:
    """sha256 over a full state: state_dict in key order, moments, and
    (step, count, notfinite)."""
    h = hashlib.sha256()
    for key in sorted(sd):
        h.update(key.encode())
        h.update(sd[key].detach().cpu().contiguous().numpy().tobytes())
    for t in list(mu) + list(nu):
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    h.update(repr(tuple(int(c) for c in counters)).encode())
    return h.hexdigest()


def main() -> None:
    port, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    mode, ckpt = sys.argv[4], sys.argv[5]
    extra = dict(kv.split("=", 1) for kv in sys.argv[6:])
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=port)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))

    from calm_vit_dte_tpu_torch.data.sampler import ShardedSampler
    from calm_vit_dte_tpu_torch.train import train_cls
    from calm_vit_dte_tpu_torch.train.evaluate import evaluate
    from calm_vit_dte_tpu_torch.train.state import full_tensors
    from calm_vit_dte_tpu_torch.train.trainer import build_dataset
    from calm_vit_dte_tpu_torch.utils.configs import get_config

    steps = extra.pop("steps", None)
    val_root = extra.pop("val_root", None)
    overrides = [f"{k}={v}" for k, v in extra.items()]
    argv = ["--config", "tiny-cls", "--device", "cpu",
            f"checkpoint_dir={ckpt}", "dataset_root=synthetic",
            "num_workers=0", "epochs=1", *overrides]
    if mode == "run":
        state = train_cls.main(argv)
        print(f"RETURNED {rank}: step={state.step}", flush=True)
        dist.destroy_process_group()
        return

    cfg = get_config("tiny-cls", **train_cls._parse_overrides(overrides))
    model_axis = cfg.mesh_model
    sampler = ShardedSampler(len(build_dataset(cfg)), world // model_axis,
                             rank // model_axis, seed=cfg.sampler_seed)
    sampler.set_epoch(0)
    print(f"SHARD {rank}: {[int(i) for i in sampler.indices()]}",
          flush=True)
    state = train_cls.main(argv + ["--max-steps", steps])
    sd, mu, nu = full_tensors(state)
    opt = state.opt_state
    print(f"DIGEST {rank}: " + state_digest(
        sd, mu, nu, (state.step, opt.count, opt.notfinite)), flush=True)
    if val_root:
        stats = {}
        acc = evaluate(get_config("tiny-cls", dataset_root=val_root,
                                  checkpoint_dir=ckpt, num_workers=0,
                                  global_batch_size=4,
                                  mesh_model=model_axis),
                       stats_out=stats, device="cpu")
        print(f"TOP1 {rank}: {acc!r} over {stats['images']}", flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
