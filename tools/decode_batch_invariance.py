#!/usr/bin/env python3
"""Whether mesh-paper's decode gives the same values for a slot whatever
the number of slots in the call, on one GPU.

    python3 tools/decode_batch_invariance.py [--trials 3]

A data-parallel server (`serve --mesh 2x1`) runs each rank's slots as a
smaller batch than the single-process server, so the two agree bitwise
only where every op of the step computes a row the same way at any row
count.  Three readings, each against the same rows computed as two calls
of 2 rows:
  (a) `layers.rmsnorm` (kernel R1, whose order of summation is fixed per
      row) over d = 2048 on 4 rows, in bf16 and f32 (300 draws of random
      rows), beside its plain version (PyTorch's reduction);
  (b) the mesh GEMM (K1) at mesh-paper's four decode products on 4 rows,
      on the same blocks and, for scale, on other blocks;
  (c) mesh-paper at full width (random weights from seed 0, `[serve]`'s
      prompts): 4 prompts prefilled alone, then 8 paged decode steps of the
      4 slots against the slots [0, 2) and [2, 4) stepped apart (what the
      ranks of 2x1 run), with `transformer._layers` and with per-index
      layer views; each trial on freshly timed blocks and its own greedy
      feed, as `chip_smoke.py`'s `[serve_tp_families]` plans them.
Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STEPS = 8


def _rows_tf(torch, cs, model, params, prompts, lo, hi, feed):
    """`chip_smoke._slots_tf`'s steps on slot rows [lo, hi) alone, in one
    process: (1 + STEPS, hi - lo, V) f32 logits."""
    from repro_torch.models.layers import NO_SHARD

    n_pages = -(-(cs.PROMPT + STEPS) // cs.PAGE)
    pools = {k: torch.zeros(shape, dtype=dt, device="cuda") for k, (shape, dt)
             in model.paged_pool_specs(1 + cs.SLOTS * n_pages, cs.PAGE, NO_SHARD).items()}
    tables = torch.arange(1, 1 + cs.SLOTS * n_pages, dtype=torch.int32,
                          device="cuda").reshape(cs.SLOTS, n_pages)
    with torch.inference_mode():
        firsts = []
        for s in range(cs.SLOTS):
            prompt = torch.as_tensor(prompts[s], device="cuda")[None]
            lg, caches = model.prefill(params, {"tokens": prompt}, NO_SHARD)
            firsts.append(lg[0, -1].float())
            for name in ("k", "v"):
                kv = torch.nn.functional.pad(caches[name][:, 0],
                                             (0, 0, 0, 0, 0, n_pages * cs.PAGE - cs.PROMPT))
                pools[name][:, tables[s].long()] = kv.reshape(
                    kv.shape[0], n_pages, cs.PAGE, *kv.shape[2:]).to(pools[name].dtype)
        rows = [torch.stack(firsts)[lo:hi]]
        for i in range(STEPS):
            tok = torch.tensor(feed[i], dtype=torch.int32, device="cuda")[lo:hi]
            pos = torch.full((hi - lo,), cs.PROMPT + i, dtype=torch.int32, device="cuda")
            lg, pools = model.paged_decode(params, tok[:, None], pools, tables[lo:hi], pos,
                                           NO_SHARD)
            rows.append(lg[:, -1].float())
    return torch.stack(rows).cpu()


def _rmsnorm_rows(torch) -> None:
    from repro_torch.kernels.rmsnorm import rmsnorm_torch
    from repro_torch.models.layers import rmsnorm

    g = torch.Generator(device="cuda").manual_seed(1)
    draws = 300
    rows = {(fn, dt): 0 for fn in ("R1", "plain") for dt in ("bfloat16", "float32")}
    for _ in range(draws):
        x = torch.randn(4, 1, 2048, generator=g, device="cuda") * 3
        w = 1 + 0.1 * torch.randn(2048, generator=g, device="cuda")
        for dt in ("bfloat16", "float32"):
            xd, wd = x.to(getattr(torch, dt)), w.to(getattr(torch, dt))
            for name, fn in (("R1", rmsnorm), ("plain", rmsnorm_torch)):
                whole = fn(xd, wd, 1e-5)
                halves = torch.cat([fn(xd[:2], wd, 1e-5), fn(xd[2:], wd, 1e-5)])
                rows[name, dt] += int((whole != halves).any(dim=-1).sum())
    print(f"[batch] (a) rmsnorm over d=2048, 4 rows against 2 + 2 ({draws} draws, {4 * draws}"
          f" rows): rows that differ with `layers.rmsnorm` (R1) bf16 {rows['R1', 'bfloat16']},"
          f" f32 {rows['R1', 'float32']}; with the plain version (PyTorch's reduction, whose"
          f" order follows the row count) bf16 {rows['plain', 'bfloat16']}, f32"
          f" {rows['plain', 'float32']}", flush=True)


def _k1_rows(torch) -> None:
    from repro_torch.kernels.mesh_matmul import mesh_matmul

    g = torch.Generator(device="cuda").manual_seed(2)
    base = (128, 512, 128)
    for k, n in ((2048, 2048), (2048, 16384), (8192, 2048), (2048, 32768)):
        a = torch.randn(4, k, generator=g, device="cuda").to(torch.bfloat16)
        b = (torch.randn(k, n, generator=g, device="cuda") * 0.02).to(torch.bfloat16)
        ref = mesh_matmul(a, b, block_m=base[0], block_n=base[1], block_k=base[2])
        parts = []
        for blocks in (base, (128, 512, 256), (128, 128, 128)):
            kw = dict(block_m=blocks[0], block_n=blocks[1], block_k=blocks[2])
            whole = mesh_matmul(a, b, **kw)
            halves = torch.cat([mesh_matmul(a[:2], b, **kw), mesh_matmul(a[2:], b, **kw)])
            parts.append(f"{blocks} 4 vs 2 + 2 rows {int((whole != halves).sum())}, against"
                         f" {base} {int((whole != ref).sum())}")
        print(f"[batch] (b) K1 (4, {k}) x ({k}, {n}) bf16, elements that differ of"
              f" {4 * n}: " + "; ".join(parts), flush=True)


def _decode_trials(torch, trials: int, cache_dir: str) -> None:
    import numpy as np

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import api, autotune
    from repro_torch.models import transformer
    from repro_torch.models.layers import NO_SHARD

    cfg = get_config("mesh-paper")
    model, params = cs._init_full_width(torch, "batch", cfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, cs.PROMPT).astype(np.int32)
               for _ in range(cs.REQUESTS)]
    unbind = transformer._layers

    def per_index(tree, n):
        def one(t, i):
            return t[i] if isinstance(t, torch.Tensor) else {k: one(v, i) for k, v in t.items()}
        return [one(tree, i) for i in range(n)]

    def diffs(x, y):
        return (x[..., :cfg.vocab_size] - y[..., :cfg.vocab_size]).abs().amax(dim=(1, 2)).tolist()

    for trial in range(trials):
        os.environ["REPRO_AUTOTUNE_CACHE"] = os.path.join(cache_dir, f"autotune{trial}.json")
        api.clear_plan_cache()
        autotune.clear_resolve_memo()
        four, feed = cs._slots_tf(torch, model, params, prompts, STEPS, NO_SHARD)
        got = {}
        for name, split in (("_layers", unbind), ("per-index", per_index)):
            transformer._layers = split
            try:
                got[name] = torch.cat([_rows_tf(torch, cs, model, params, prompts, 0, 2, feed),
                                       _rows_tf(torch, cs, model, params, prompts, 2, 4, feed)],
                                      dim=1)
            finally:
                transformer._layers = unbind
        entries = json.loads(Path(os.environ["REPRO_AUTOTUNE_CACHE"]).read_text())["entries"]
        picks = {}
        for key, ent in entries.items():
            m, k, n = key.split("|")[0].split("x")
            if m in ("2", "4"):
                picks.setdefault(f"{k}x{n}", {})[m] = ent["blocks"]
        same = all(v.get("2") == v.get("4") for v in picks.values())
        print(f"[batch] (c) trial {trial}: 4 slots against 2 + 2, max |d| per row (prefill,"
              f" then {STEPS} steps): _layers {diffs(four, got['_layers'])}, per-index"
              f" {diffs(four, got['per-index'])}; the two splits' halves bitwise equal:"
              f" {torch.equal(got['_layers'], got['per-index'])}; M=2 blocks == M=4 blocks at"
              f" every product: {same} {picks}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trials", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("decode_batch_invariance: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(f"[batch] {smi.stdout.strip()} | torch {torch.__version__}", flush=True)
    with tempfile.TemporaryDirectory() as cache_dir:
        os.environ["REPRO_AUTOTUNE_CACHE"] = os.path.join(cache_dir, "autotune.json")
        os.environ["REPRO_COSTMODEL_CACHE"] = os.path.join(cache_dir, "costmodel.json")
        import chip_smoke

        chip_smoke.phase_build(torch)
        _rmsnorm_rows(torch)
        _k1_rows(torch)
        _decode_trials(torch, args.trials, cache_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
