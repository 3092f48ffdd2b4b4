"""End-to-end training entry point (port of `repro.launch.train`).

Trains a config on one device with the fault-tolerance stack: atomic
checksummed checkpoints, `--resume auto`, deterministic resumable data and
straggler logging.  It runs on the card unless asked for the CPU.

Examples
--------
  # the card: full-width mesh-paper, the paper's own workload
  PYTHONPATH=src python -m repro_torch.launch.train --arch mesh-paper \\
      --steps 6 --batch 2 --seq 2048

  # the host: reduced mesh-paper with checkpointing + crash-resume
  PYTHONPATH=src python -m repro_torch.launch.train --arch mesh-paper \\
      --reduced --device cpu --steps 3 --ckpt-dir /tmp/ckpt --resume auto

  # the host: reduced RWKV-6 (the ssm family) or Zamba2 (hybrid)
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-1.6b \\
      --reduced --device cpu --steps 2

  # data-parallel ranks through torchrun (gloo on the host; on a machine
  # with a card per rank, NCCL and --device omitted)
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
      --arch mesh-paper --reduced --device cpu --mesh local-dp

`--async-ckpt` writes the checkpoints on a worker thread
(`AsyncCheckpointer`).  `--mesh local-dp` trains data-parallel over every
rank of the process group (`launch.mesh.init_distributed`: torchrun's
environment, or one rank without it) on a ("data", "model") mesh of
(world, 1), as the reference's `make_local_mesh((jax.device_count(), 1))`:
every rank draws the same global batch and takes its rows
(`train_step.make_train_step` with the mesh); rank 0 writes the checkpoints, every
rank restores.  `--mesh prod` (the production mesh) comes with the dry
runs and raises NotImplementedError; audio and vlm are refused, as in the
reference.
"""

from __future__ import annotations

import argparse
import io

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.checkpoint import AsyncCheckpointer, CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch.mesh import init_distributed, make_local_mesh
from repro_torch.models import get_model
from repro_torch.optim import AdamWConfig, warmup_cosine
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.metrics import MetricsLogger
from repro_torch.train.train_step import init_train_state, make_train_step

__all__ = ["main", "build_trainer"]


def build_trainer(
    cfg,
    *,
    batch: int,
    seq: int,
    mesh=None,
    lr: float = 3e-4,
    total_steps: int = 1000,
    grad_accum: int = 1,
    seed: int = 0,
    device=None,
):
    """Construct (train_step_fn, state, data_iter) for a config on `device`
    (cuda unless the caller names another).  Parameters are drawn from a
    torch generator seeded with `seed`; the data stream is the reference's
    `SyntheticLM` with the same seed.  With `mesh` (a ("data", "model")
    mesh: a DeviceMesh over the ranks, or a plain layout of one rank), the
    step is this rank's data-parallel step on the global batch; every rank
    draws the same parameters and the same batches."""
    dev = resolve_device(device)
    model = get_model(cfg)
    schedule = warmup_cosine(lr, min(100, total_steps // 10 + 1), total_steps)
    step_fn = make_train_step(model, schedule, AdamWConfig(), grad_accum=grad_accum, mesh=mesh)
    state = init_train_state(model, torch.Generator(device=dev).manual_seed(seed), dev)
    data = SyntheticLM(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch, seed=seed)
    )
    return step_fn, state, data


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", help="CPU-smoke dims")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--async-ckpt", action="store_true")
    ap.add_argument("--resume", default=None, choices=(None, "auto"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default="none", choices=("none", "local-dp", "prod"),
                    help="local-dp: data-parallel over the process group's ranks;"
                         " 'prod' raises NotImplementedError")
    ap.add_argument("--step-deadline-s", type=float, default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda (use 'cpu' to run on the host)")
    args = ap.parse_args(argv)

    if args.mesh == "prod":
        raise NotImplementedError("--mesh prod: the production mesh comes with the dry runs"
                                  " (ROADMAP A14)")
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.family in ("audio", "vlm"):
        raise SystemExit(f"{args.arch}: synthetic LM trainer covers token-LM families; "
                         "see tests/test_models_smoke.py for audio/vlm train steps")

    mesh, group, world, rank = None, None, 1, 0
    if args.mesh == "local-dp":
        world, rank = init_distributed(device)
        mesh = make_local_mesh((world, 1), ("data", "model"))
        group = dist.group.WORLD if world > 1 else None

    step_fn, state, data = build_trainer(
        cfg, batch=args.batch, seq=args.seq, mesh=mesh, lr=args.lr, total_steps=args.steps,
        grad_accum=args.grad_accum, seed=args.seed, device=device,
    )

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    writer = AsyncCheckpointer(ckpt) if (ckpt and args.async_ckpt and rank == 0) else None
    if ckpt and args.resume == "auto":
        latest = ckpt.latest_step()
        if latest is not None:
            print(f"[resume] restoring step {latest} from {args.ckpt_dir}")
            state = ckpt.restore(latest, state)
            data.restore(ckpt.meta(latest)["data_step"])

    loop_cfg = LoopConfig(
        total_steps=args.steps,
        ckpt_every=args.ckpt_every,
        step_deadline_s=args.step_deadline_s,
        log_every=args.log_every,
    )
    logger = MetricsLogger(stream=None if rank == 0 else io.StringIO())  # rank 0 logs
    state = train_loop(step_fn, state, data, loop_cfg, ckpt=ckpt, logger=logger,
                       checkpointer=writer, group=group)
    if writer is not None:
        writer.close()
    final_loss = logger.history[-1]["loss"] if logger.history else float("nan")
    print(f"[done] {args.arch} steps={args.steps} final_loss={final_loss:.4f} device={device}"
          + (f" mesh=local-dp rank={rank}/{world}" if mesh is not None else ""))


if __name__ == "__main__":
    main()
