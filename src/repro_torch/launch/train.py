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
(`train_step.make_train_step` with the mesh).  `--mesh prod` trains on the
reference's production mesh (`launch.mesh.make_production_mesh`: 16 x 16
ranks, 'model' 16), data- and tensor-parallel: it needs 256 ranks (a
smaller group raises ValueError naming the count).  Tensor-parallel
training on a local mesh goes through `build_trainer(cfg, mesh=)`, as the
reference's tests reach it:

  mesh = make_local_mesh((D, M), ("data", "model"))  # on D x M torchrun ranks
  step, state, data = build_trainer(cfg, batch=8, seq=128, mesh=mesh, device="cpu")

and from the CLI as `--mesh DxM` (D x M ranks).  `--sp` trains under the
reference's `TRAIN_RULES` (Megatron sequence parallelism: the layers'
carriers seq-sharded over 'model'), `--fsdp` with its `PARAM_RULES` as
the parameters' layout (FSDP: parameters and AdamW moments cut over
'data' too, each layer's weights gathered before use):

  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --arch mesh-paper --reduced --device cpu --mesh 2x2 --sp --fsdp

Under a mesh rank 0 writes the checkpoints (the global tree, gathered by
every rank under a 'model' axis) and every rank restores (the global tree,
then its blocks).  Audio and vlm are refused, as in the reference.
"""

from __future__ import annotations

import argparse
import io

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import AsyncCheckpointer, CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.interop import shard_params
from repro_torch.launch.mesh import init_distributed, make_local_mesh, make_production_mesh
from repro_torch.models import get_model
from repro_torch.models.layers import NO_SHARD, ShardCtx
from repro_torch.optim import AdamWConfig, warmup_cosine
from repro_torch.parallel.collectives import mesh_groups
from repro_torch.parallel.sharding import DEFAULT_RULES, PARAM_RULES, TRAIN_RULES
from repro_torch.train.loop import LoopConfig, restore_state, train_loop
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
    grad_accum=None,
    seed: int = 0,
    device=None,
    rules=None,
    param_rules=None,
):
    """Construct (train_step_fn, state, data_iter) for a config on `device`
    (cuda unless the caller names another).  Parameters are drawn from a
    torch generator seeded with `seed`; the data stream is the reference's
    `SyntheticLM` with the same seed.  `grad_accum` None takes the
    config's field.  With `mesh` (a ("data", "model")
    mesh: a DeviceMesh over the ranks, or a plain layout of one rank), the
    step trains under `ShardCtx(mesh, rules)` (`rules` by default
    DEFAULT_RULES; TRAIN_RULES for sequence parallelism), as the
    reference's does: data-parallel over 'data' on the global batch and,
    where 'model' has more than one rank, tensor-parallel over it;
    `param_rules` (PARAM_RULES: FSDP) lays the parameters and AdamW's
    moments out by their own rules.  Every rank draws the
    same global parameters and batches; under a 'model' axis it then keeps
    its blocks of the parameters and of their AdamW moments
    (`interop.shard_params`), and `train_step_fn.blocks` gathers and cuts
    them (checkpoints)."""
    dev = resolve_device(device)
    model = get_model(cfg)
    grad_accum = cfg.grad_accum if grad_accum is None else grad_accum
    schedule = warmup_cosine(lr, min(100, total_steps // 10 + 1), total_steps)
    ctx = (ShardCtx(mesh, rules or DEFAULT_RULES, param_rules=param_rules)
           if mesh is not None else NO_SHARD)
    step_fn = make_train_step(model, schedule, AdamWConfig(), ctx, grad_accum=grad_accum)
    state = init_train_state(model, torch.Generator(device=dev).manual_seed(seed), dev)
    if step_fn.blocks is not None:
        state = shard_params(state, model, ctx)
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
    ap.add_argument("--grad-accum", type=int, default=None,
                    help="microbatches a step (default: the config's grad_accum)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--async-ckpt", action="store_true")
    ap.add_argument("--resume", default=None, choices=(None, "auto"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default="none",
                    help="none; local-dp: data-parallel over the process group's ranks; DxM:"
                         " a (data, model) mesh of D x M ranks; prod: the 16x16 production"
                         " mesh (256 ranks)")
    ap.add_argument("--sp", action="store_true",
                    help="TRAIN_RULES: sequence-parallel layer carriers over 'model'")
    ap.add_argument("--fsdp", action="store_true",
                    help="PARAM_RULES: parameters and optimizer state cut over 'data' too")
    ap.add_argument("--step-deadline-s", type=float, default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda (use 'cpu' to run on the host)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.family in ("audio", "vlm"):
        raise SystemExit(f"{args.arch}: synthetic LM trainer covers token-LM families; "
                         "see tests/test_models_smoke.py for audio/vlm train steps")

    mesh, group, world, rank = None, None, 1, 0
    if args.mesh != "none":
        world, rank = init_distributed(device)
        if args.mesh == "local-dp":
            mesh = make_local_mesh((world, 1), ("data", "model"))
        elif args.mesh == "prod":
            mesh = make_production_mesh()
        else:
            dims = tuple(int(n) for n in args.mesh.lower().split("x"))
            if len(dims) != 2:
                raise SystemExit(f"--mesh {args.mesh!r}: want none, local-dp, prod or DxM")
            mesh = make_local_mesh(dims, ("data", "model"))
        group = mesh_groups(mesh) or None

    step_fn, state, data = build_trainer(
        cfg, batch=args.batch, seq=args.seq, mesh=mesh, lr=args.lr, total_steps=args.steps,
        grad_accum=args.grad_accum, seed=args.seed, device=device,
        rules=TRAIN_RULES if args.sp else None, param_rules=PARAM_RULES if args.fsdp else None,
    )

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    writer = AsyncCheckpointer(ckpt) if (ckpt and args.async_ckpt and rank == 0) else None
    if ckpt and args.resume == "auto":
        latest = ckpt.latest_step()
        if latest is not None:
            print(f"[resume] restoring step {latest} from {args.ckpt_dir}")
            state = restore_state(ckpt, latest, state, step_fn.blocks)
            data.restore(ckpt.meta(latest)["data_step"])

    loop_cfg = LoopConfig(
        total_steps=args.steps,
        ckpt_every=args.ckpt_every,
        step_deadline_s=args.step_deadline_s,
        log_every=args.log_every,
    )
    logger = MetricsLogger(stream=None if rank == 0 else io.StringIO())  # rank 0 logs
    state = train_loop(step_fn, state, data, loop_cfg, ckpt=ckpt, logger=logger,
                       checkpointer=writer, group=group, blocks=step_fn.blocks)
    if writer is not None:
        writer.close()
    final_loss = logger.history[-1]["loss"] if logger.history else float("nan")
    print(f"[done] {args.arch} steps={args.steps} final_loss={final_loss:.4f} device={device}"
          + (f" mesh={args.mesh} rank={rank}/{world}" if mesh is not None else ""))


if __name__ == "__main__":
    main()
