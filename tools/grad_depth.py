#!/usr/bin/env python3
"""How a model's gradient at random init responds to rounding, by depth, on
one GPU.

    python3 tools/grad_depth.py                       # RWKV-6 and Zamba2
    python3 tools/grad_depth.py --arch rwkv6-1.6b --layers 2,4,6,12,24

For each depth: the full-width model (`tuned()`, bf16, random weights from
seed 0) cut to its first L layers, one loss and gradient on a 2 x 2048-token
batch through three paths that compute the same function and round
differently: the `torch` backend (the reference of the comparison), the
kernel path (`use_mesh_kernel=True`: the mesh GEMM, K1) and the `torch`
backend with the `ref` forward (f32 products of the upcast operands, no
K1).  Each line gives the loss difference, the gradient norms and the
largest and median per-parameter ||g - g_torch|| / ||g_torch|| of the other
two paths.  Where the two plain paths differ as much as the kernel path
does, the gradient's sensitivity is the model's, not the kernel's.  TF32 is
off.  Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DEPTHS = {"rwkv6-1.6b": (2, 4, 6, 12, 24), "zamba2-1.2b": (6, 38)}


def _sweep(torch, arch: str, depth: int) -> None:
    from repro_torch.configs import get_config
    from repro_torch.kernels import api
    from repro_torch.models import get_model
    from repro_torch.tree import tree_leaves, tree_map, tree_paths

    cfg = dataclasses.replace(get_config(arch).tuned(), use_mesh_kernel=True, num_layers=depth)
    params = get_model(cfg).init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 2048), generator=g, device="cuda",
                         dtype=torch.int32)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    names = [p for p, _ in tree_paths(params)]

    def loss_and_grads(kernel: bool, forward: str = "torch"):
        model = get_model(dataclasses.replace(cfg, use_mesh_kernel=kernel))
        ps = tree_map(lambda t: t.detach().requires_grad_(True), params)
        keep = api._DENSE_FORWARD["torch"]
        api._DENSE_FORWARD["torch"] = api._DENSE_FORWARD[forward]
        try:
            with torch.enable_grad():
                loss, _ = model.loss(ps, batch)
                grads = torch.autograd.grad(loss, tree_leaves(ps), allow_unused=True,
                                            materialize_grads=True)
            return loss.item(), [x.float() for x in grads]
        finally:
            api._DENSE_FORWARD["torch"] = keep

    def norm(gs):
        return sum(x.square().sum().item() for x in gs) ** 0.5

    lt, gt = loss_and_grads(False)
    for label, (kernel, forward) in (("kernel", (True, "torch")), ("ref forward", (False, "ref"))):
        loss, grads = loss_and_grads(kernel, forward)
        rel = sorted(((x - y).norm().item() / y.norm().item(), n)
                     for n, x, y in zip(names, grads, gt) if y.norm().item() > 0)
        finite = all(bool(torch.isfinite(x).all()) for x in grads)
        print(f"[grad_depth] {arch} {depth} layers, {label} vs torch: loss |d| "
              f"{abs(loss - lt):.3e}, grad norm {norm(grads):.4f} vs {norm(gt):.4f}, finite"
              f" {finite}, per-parameter largest {rel[-1][0]:.4f} ({rel[-1][1]}), median"
              f" {rel[len(rel) // 2][0]:.4f}", flush=True)
        del grads
    del params, gt
    gc.collect()
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=sorted(DEPTHS), action="append")
    ap.add_argument("--layers", help="comma-separated depths (default: per arch)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("grad_depth: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"[grad_depth] {smi.stdout.strip()} | torch {torch.__version__}", flush=True)
    for arch in args.arch or sorted(DEPTHS, reverse=True):
        depths = (tuple(int(x) for x in args.layers.split(",")) if args.layers
                  else DEPTHS[arch])
        for depth in depths:
            _sweep(torch, arch, depth)
    return 0


if __name__ == "__main__":
    sys.exit(main())
