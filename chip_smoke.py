#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py            # from the repository root; needs one card
    python3 chip_smoke.py --only k6,k6_bwd   # the build and the named phases only

Phases; any failure raises and the script exits non-zero:

  1. build    every CUDA kernel of the port from `src/repro_torch/csrc` with
              nvcc (sm_90a), all sources at once, printing ptxas'
              register/spill report;
  2. kernels  each kernel against its plain PyTorch version at the shapes the
              serving and training paths give it, with a stated tolerance,
              then its time, the plain version's time, one library call
              computing the same function (timed here only, never used by
              the port) and the least time the card could take (bytes at
              3.35 TB/s or operations at the peak rate of their type,
              whichever is larger): K1 (mesh GEMM, 2D and batched, on each
              of its tile families, every case checked to launch the tile
              `tile_config` names), K4 (split-context paged decode
              attention: split boundaries, empty splits, rep 1-8 and
              mistral-large's rep 12 in chunks of 8 and 4, f32, a 16k-token
              context; held by output-relative measures), K3 (block
              scramble), K1's backward (the `_mm` VJP) against the same
              backward run with the plain GEMM, K5 (grouped mesh GEMM) at
              OLMoE's decode and prefill shapes, every case checked to
              launch the tile its `tile_config` names (bf16 on the tensor
              cores), K5's backward (the `_gmm` VJP), K6 (flash attention)
              at Qwen2-7B's prefill and mesh-paper's training shapes in bf16
              (tensor cores) and f32 (SIMT), causal with Tq != Tk, held by
              output-relative measures, and K6 under `_FlashAttention`
              yielding gradients; K4 is also timed at Qwen2-7B's decode (GQA
              rep 7, 2-4k-token contexts), and K1's decode shapes, K4 and K6
              are timed by the profiler's device time beside CUDA events,
              which the host sets for short calls;
  3. serve    full-width mesh-paper (4 layers, d_model 2048, 16 heads, d_ff
              8192, vocab 32768, bf16, random weights from a seed) through
              `ContinuousBatchingServer`: 8 requests x 128-token prompts x 32
              new tokens on 4 slots, with every kernel's launch count read
              around the run (K1's per tile: no main-path call on a first
              SIMT tile), and the output checked against the dense-cache
              path (`generate`, plain `_sdpa` attention);
  4. train    the same model through `build_trainer` and `train_loop`: 6 AdamW
              steps at batch 2 x seq 2048 with the sigma scramble firing
              and the `dots` remat default, launch counts per step checked
              (K1 75, K3 4), losses finite and falling, one step and each
              parameter's gradient held against the `torch` backend's, one
              step profiled, and one step under `none` and `dots` (K1 75
              both, `dots` below `none` in peak memory);
  5. serve_moe  full-width OLMoE-1B-7B (16 layers, d_model 2048, 16 heads, 64
              experts top-8, expert d_ff 1024, vocab 50304, bf16, random
              weights from a seed) with `use_mesh_kernel=True` through the
              same server and requests: K1, K4 and K5 launch counts checked
              against the server's prefills and decode steps (K5's per tile:
              no main-path call on a SIMT tile), 0 host syncs, the output
              checked against the dense-cache path, one window profiled;
  6. serve_qwen2  full-width Qwen2-7B (28 layers, d_model 3584, 28 heads over
              4 KV heads, d_ff 18944, vocab 152064, QKV bias, bf16, random
              weights from a seed) with attn_chunk=1024: 4 requests with
              prompts of 2048-4096 tokens x 16 new tokens on 4 slots, every
              prefill through K6 and every decode step through K4 (launch
              counts checked against the server's counters), K6 prefill
              logits held against the plain chunked path's and plain
              `_sdpa`'s (bf16, and f32 weights for the tight check), paged
              decode against dense, one window profiled;
  7. train_flash  one mesh-paper training step at 2 x 2048 tokens with
              attn_chunk=1024 (K6 forward, again in the `dots` recompute;
              recomputed backward) against the same step with full
              attention;
  8. serve_qwen2_moe  full-width Qwen1.5-MoE-A2.7B (24 layers, d_model 2048,
              60 experts top-4, expert d_ff 1408, 4 shared experts fused to
              5632 behind an f32 sigmoid gate, vocab 151936, QKV bias, bf16,
              random weights from a seed; 14.316 B parameters) on the kernel
              path through the server with serve_moe's requests: launches
              against the server's counters, 0 host syncs under sync debug
              mode "error", paged vs dense logits, K5 per decode step
              against its byte bound, a 2-layer f32 witness of the kernel
              path against the `torch` backend, one window profiled;
  9. train_moe  OLMoE-1B-7B at full width and 4 of its 16 layers on the
              kernel path, 2 x 2048 tokens (capacity 640 rows per expert,
              pairs dropped): the kernel step against the `torch` step,
              `dots` against `none` (loss bitwise), 6 steps through
              `train_loop` with an `AsyncCheckpointer` every 2 steps (submit
              without a host sync, the step-4 checkpoint bitwise equal to a
              synchronous copy, a resume of steps 5-6), and one step per
              remat policy with its peak memory and K1/K5 launches;
  10. configs  Granite-3 8B, Phi-3-medium 14B and Mistral-Large 123B through
              `tuned()` at full width and 2 layers: a 2048-token prompt
              through K6, 8 decode steps through the server on K4 (GQA rep
              4, 4, 12), the padded and tied head, paged vs dense logits;
  11. paper    the paper's tables by simulation on the card (`core/`): 2n-1
              and 3n-2 steps for n up to 128 and at n = 1024, the outputs
              equal to a @ b bitwise, the symmetric readout within
              n+1+n/2 steps up to n = 256, the orders of S, and S^k with a
              key on the card (no host sync);
  12. planner  the GEMM planner at mesh-paper's width: the `ops.matmul`
              shim, the scoped default, `execute_async`, the degradation
              ladder under injected plan.execute/plan.build faults and the
              non-finite guard's three policies under a NaN-poisoned
              kernel.output;
  13. obs      observability and the cost model at mesh-paper's full width:
              (a) the blocks the autotuner picked on the card for every
              main-path product, each timed candidate's device ms, every
              one on a tensor-core tile; (b) the serve requests served
              untraced and traced (bridge installed) in turns: the same
              tokens, span counts by name, tokens/s both ways, no host sync
              in a traced decode step and prefill, the bridge's calibration
              records carrying the device time of CUDA events, the three
              exports written and parsed back; (c) `calibrate()` on the
              card, its fit beside the shipped coefficients, and each
              main-path product's predicted ms against its device ms; (d)
              the chooser's blocks against 128^3 (`mesh_block_*`): K1's
              device ms per product, serve tokens/s and train ms per step,
              in turns.

Every plan resolves its blocks through the cost model's chooser, which
times candidates on the card; the autotune and calibration caches live in
a fresh temporary directory for the run.

Every phase but `planner` arms no fault: each starts with an empty
resilience ledger and fails if it records a planner event (`plan.*`,
`guard.*`) or leaves a cached plan on another backend than its own.

The last lines are the card's `nvidia-smi` name and power limit, the
`{"kernels": [...]}` JSON, and `{"ok": true, "device": {...}}`.  It imports
nothing of JAX and nothing of the JAX package `repro`.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor / f32 SIMT
L2_BYTES = 50 * 2**20

# mesh-paper's GEMMs, (K, N): wq/wk/wv/wo, fused gate+up, mlp wo, lm_head.
MESH_PAPER_GEMMS = {
    "attn (wq|wk|wv|wo)": (2048, 2048),
    "mlp wi": (2048, 16384),
    "mlp wo": (8192, 2048),
    "lm_head": (2048, 32768),
}
# K1 launches per decode tick: 4 layers x (4 attn + wi + wo) + lm_head.
TICK_LAUNCHES = {"attn (wq|wk|wv|wo)": 16, "mlp wi": 4, "mlp wo": 4, "lm_head": 1}
SLOTS, PROMPT, NEW_TOKENS, REQUESTS, PAGE = 4, 128, 32, 8, 8
# Training: batch x seq tokens per step (seq = d_model, so the scramble's
# (T, D) block grid is square and fires), steps, and launches per step:
# K1 25 forward + 2 x 25 backward (dA, dB; no GEMM of mesh-paper fuses an
# activation, so none recomputes z); K3 scramble + unscramble, forward and
# backward.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 2, 2048, 6, 1e-3
STEP_LAUNCHES = {"mesh_matmul": 75, "scramble_blocks": 4}
# OLMoE-1B-7B served with use_mesh_kernel=True.  Its expert GEMMs, (K, N):
# the fused gate+up wi and wo, over 64 experts; each token picks 8.
OLMOE_EXPERTS, OLMOE_TOPK, OLMOE_LAYERS = 64, 8, 16
K5_GEMMS = {"wi": (2048, 2048), "wo": (1024, 2048)}
# K5's (rows per group, block_m) on the path: a decode step of SLOTS tokens
# routes exactly (capacity SLOTS, rounded up to 8 rows); a PROMPT-token
# prefill has capacity PROMPT.
K5_SHAPES = {"decode": (8, 8), "prefill": (PROMPT, PROMPT)}
# Launches per prefill and per decode step: K5 for wi and wo of 16 layers;
# K1 for 4 attention projections of 16 layers and lm_head; K4 16 per decode
# step.  The server's warmup adds two K1 launches (its canary plan).
MOE_STEP_LAUNCHES = {"grouped_mesh_matmul": 32, "mesh_matmul": 65}
# Teacher-forced paged (K4) vs dense (_sdpa) decode logits of OLMoE: the
# reading is 0.0806 on logits up to 4.28, with 9 of 112 (step, layer)
# routing sets flipped by the two paths' rounding; 0.25 is about 3x that,
# 8 bf16 ulps at |logit| in [4, 8).
MOE_LOGIT_TOL = 0.25
# Qwen2-7B served with attn_chunk=1024 (the reference's tuned() value): its
# prompts take the chunked prefill through K6, one launch per layer; decode
# runs K4 at GQA rep 7 over 2-4k-token contexts.
QWEN_LAYERS, QWEN_CHUNK, QWEN_NEW_TOKENS = 28, 1024, 16
QWEN_PROMPTS = (2048, 2048, 3072, 4096)
QWEN_HEADS = (28, 4, 128)  # query heads, KV heads, head dim
# K4's contexts in the middle of that run's decode: each prompt plus 8 tokens.
QWEN_LIVE = [t + 8 for t in QWEN_PROMPTS]
# K6 prefill logits against plain `_sdpa` ones (all 2048 positions): the
# first reading was 0.3655 on logits up to 7.28, the two attentions'
# bf16 roundings of p and of the output compounded over 28 layers; 1.1 is
# about 3x that.  Teacher-forced paged (K4) against dense (`_sdpa`) decode
# logits: the first reading was 0.2363 on logits up to 5.59; 0.7 is about
# 3x that.
QWEN_PREFILL_TOL = 1.1
QWEN_LOGIT_TOL = 0.7
# K6 prefill logits against the same chunked path through K6's plain
# version: in bf16 the first reading was 0.3516 (plain chunked vs `_sdpa`
# 0.3691: the formulations' one-ulp differences, amplified by 28 layers),
# 1.1 is about 3x that; in f32, where the two differ in summation order
# only, the first reading was 8.446e-05, and 2.5e-4 is about 3x that.
QWEN_K6_CHUNKED_TOL = 1.1
QWEN_F32_TOL = 2.5e-4
# K4 at mistral-large-123b's decode: (slots, query heads, KV heads, head
# dim), GQA rep 12, which the split kernel runs as chunks of 8 and 4 rows.
MISTRAL_DECODE = (SLOTS, 96, 8, 128)
# Qwen1.5-MoE-A2.7B served with use_mesh_kernel=True, the requests of
# serve_moe: 60 experts top-4 (expert d_ff 1408) and 4 shared experts fused
# to 5632.  Launches per prefill and per decode step: K5 for wi and wo of 24
# layers; K1 for 4 attention projections, the shared wi, wo and gate (f32,
# N = 1) of 24 layers, and lm_head; K4 24 per decode step.
QMOE_LAYERS, QMOE_EXPERTS, QMOE_TOPK = 24, 60, 4
QMOE_DENSE_GEMMS = {"lm_head": (2048, 151936), "shared wi": (2048, 2 * 5632),
                    "shared wo": (5632, 2048)}
# Its expert GEMMs (K, N) on K5, over 60 experts, at K5_SHAPES.
QMOE_K5_GEMMS = {"wi": (2048, 2 * 1408), "wo": (1408, 2048)}
QMOE_STEP_LAUNCHES = {"grouped_mesh_matmul": 2 * QMOE_LAYERS, "mesh_matmul": 7 * QMOE_LAYERS + 1}
# Teacher-forced paged (K4) vs dense (`_sdpa`) decode logits: the first
# reading was 0.3525 on req0's logits up to 4.281 (24 layers, 1-6 routing
# sets of 24 flipped a step by the two attentions' roundings; req1 and req2
# later read 0.1953 and 0.3438); 1.0 is about 3x that.  The f32
# prefill witness (2 layers, kernel path vs `torch` backend, summation
# order only): the first reading was 1.693e-05 on logits up to 5.22.
QMOE_LOGIT_TOL = 1.0
QMOE_F32_TOL = 5e-5
# The same teacher-forced decode with the paged step on the dense step's
# routing, where only the attentions' roundings differ: the first readings
# were 0.0781, 0.0774 and 0.0742 on req0-2 (logits up to 4.28-4.38), and
# 0.25 is about 3x the largest.  With 2 f32 layers (summation order only):
# the first reading was 1.192e-05, and 3.5e-5 is about 3x that.
QMOE_CHECKED = 3
QMOE_SAME_ROUTING_TOL = 0.25
QMOE_F32_DECODE_TOL = 3.5e-5
# OLMoE-1B-7B trained at full width and 4 of its 16 layers: AdamW's f32
# moments for the 6.919 B parameters alone take 55 GB, a full-depth step
# about 83 GB; 4 layers hold 1.88 B parameters, about 19 GB of state.
MOE_TRAIN_LAYERS = 4
# Its capacity: 1.25 x 4096 tokens x 8 choices / 64 experts, rows per expert.
MOE_TRAIN_CAP = 640
# (token, choice) pairs of one step that the `torch` backend routes to
# another expert than the kernel path, over the 4 layers' 131,072: the
# first reading was 917, and the limit is 3x that.
MOE_TRAIN_FLIP_TOL = 2750
# The dense configs through tuned(), at full width and 2 layers each
# (Mistral-Large's 123 B parameters do not fit one card; 2 layers hold about
# 3.6 B): (arch, GQA rep).  One prompt of CONFIGS_PROMPT tokens (K6 through
# attn_chunk=1024), then 8 decode steps through the server (K4).
CONFIGS_ARCHS = (("granite-3-8b", 4), ("phi3-medium-14b", 4), ("mistral-large-123b", 12))
CONFIGS_LAYERS, CONFIGS_PROMPT, CONFIGS_NEW_TOKENS = 2, 2048, 9
# Teacher-forced paged vs dense decode logits: the first readings were
# 0.0625, 0.0898 and 0.125 (logits up to 6.0, 6.6 and 9.5); the limits are
# 3x those.  The tied head against rmsnorm(x) @ embed.T in f32: the bf16
# rounding of logits below 8, 2 ulps (the first reading 0.0156).
CONFIGS_LOGIT_TOL = {"granite-3-8b": 0.1875, "phi3-medium-14b": 0.27,
                     "mistral-large-123b": 0.375}
CONFIGS_TIED_TOL = 0.0625


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, calls, iters: int, warmup: int = 3) -> float:
    """Mean device time of one call, CUDA events around `iters` calls that
    cycle through `calls` (distinct operands, so weights come from HBM)."""
    for i in range(warmup):
        calls[i % len(calls)]()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        calls[i % len(calls)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, calls, iters: int, rows=None) -> float:
    """Mean device time of one call: the kernels torch.profiler sees over
    `iters` calls that cycle through `calls`, summed, over `iters`.  For
    calls shorter than their own host-side launch cost, where CUDA events
    around a loop time the host.  A window in which the profiler saw no
    kernel is taken again (at most twice more), then fails.  `rows`, if
    given, receives (device us, count, name) per kernel."""
    from torch.profiler import ProfilerActivity, profile

    for c in calls:
        c()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                calls[i % len(calls)]()
            torch.cuda.synchronize()
        seen = kernel_rows(prof)
        if seen:
            break
    check(bool(seen), "torch.profiler saw no kernel in three windows")
    if rows is not None:
        rows.extend(seen)
    return sum(r[0] for r in seen) / iters / 1e3


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_build(torch):
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.monotonic()
    libs = _build.build_all()
    log(f"[build] {len(libs)} kernel libraries in {time.monotonic() - t0:.1f} s")
    for name, text in _build.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


# K1's tile families (kernels/mesh_matmul.py: tile_config): the tensor-core
# tiles for bf16, the f32 SIMT tile for f32; the first SIMT tiles only for
# logical blocks those cannot take, never on a main path.
OLD_TILES = ("simt64", "simt_decode")


# K1's and K5's launches per tile config on each main path, for the kernels
# line.
K1_TILES = {}
K5_TILES = {}
# The server's warmup canary, an 8x8 f32 GEMM on 8-wide blocks, checks the
# build, run twice (through `dispatch` and directly): only the first SIMT
# decode tile takes it.  It is no main-path product.
CANARY_TILES = {"simt_decode": 2}


def check_main_path_tiles(path, tiles, canary: bool) -> None:
    """No K1 launch of a main path takes a first SIMT tile (the warmup
    canary aside)."""
    K1_TILES[path] = tiles
    old = {c: n for c, n in tiles.items() if c in OLD_TILES}
    want = CANARY_TILES if canary else {}
    log(f"[{path}] K1 launches per tile: {tiles}")
    check(old == want, f"{path}: K1 launches on the first SIMT tiles {old}, want {want}")


def tile_counts(mesh_matmul):
    """K1's launches per tile config since its counters were last reset."""
    return dict(sorted(mesh_matmul.launches_by_config.items()))


def reset_k1(mesh_matmul):
    mesh_matmul.launches = 0
    mesh_matmul.launches_by_config = {}


def phase_k1(torch):
    """K1 (mesh_matmul) against mesh_matmul_torch on every tile family, then
    timings."""
    from repro_torch.kernels.mesh_matmul import (
        kernel_n,
        mesh_matmul,
        mesh_matmul_torch,
        tile_config,
    )

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(1)
    bf16, f32 = torch.bfloat16, torch.float32

    def rnd(*shape, dtype=bf16):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    def tol_of(ref, dtype):
        # f32: only the summation order differs (<< 1e-5 relative; TF32 would
        # show ~5e-4).  bf16 output: the two f32 sums may round to adjacent
        # bf16 values, 2^-7 relative at most.
        return (1e-5 if dtype == f32 else 2.0**-7) * ref.abs().max().item()

    # label, (M, K, N), dtype, options; every case on its tile of tile_config.
    epi = dict(activation="gelu", bias=True, residual=True)
    cases = []
    for label, (k, n) in MESH_PAPER_GEMMS.items():
        for m in (SLOTS, PROMPT):
            cases.append((f"{label} M={m}", (m, k, n), bf16, {}))
    cases += [
        ("f32 no-TF32", (PROMPT, 2048, 2048), f32, {}),
        ("bias+gelu+residual", (PROMPT, 2048, 2048), bf16, epi),
        ("stagger=False", (PROMPT, 2048, 2048), bf16, dict(stagger=False)),
        ("scramble_out 8x8 grid", (1024, 2048, 1024), bf16, dict(scramble_out=True)),
        ("batched B=4", (PROMPT, 1024, 512), bf16, dict(batch=4)),
        ("ragged M, N, K", (200, 2008, 200), bf16, {}),
        ("M=16, decode side", (16, 2048, 2048), bf16, {}),
        ("M=17, prompt side", (17, 2048, 2048), bf16, {}),
        ("decode ragged N, K", (SLOTS + 1, 2008, 1000), bf16, epi),
        ("decode N=32768", (SLOTS, 2048, 32768), bf16, {}),
        ("decode 16-wide blocks", (SLOTS, 512, 512), bf16, dict(block_n=16)),
        ("scramble_out+bias+gelu+residual", (1024, 2048, 1024), bf16,
         dict(scramble_out=True, **epi)),
        ("scramble_out+bias+gelu+residual", (1024, 2048, 1024), f32,
         dict(scramble_out=True, **epi)),
        ("f32 bias+silu+residual", (PROMPT, 2048, 2048), f32,
         dict(activation="silu", bias=True, residual=True)),
        ("f32 ragged M, N, K", (200, 2004, 196), f32, {}),
        ("f32 M=4", (SLOTS, 2048, 2048), f32, {}),
        ("16-deep k blocks", (PROMPT, 512, 512), bf16, dict(block_k=16)),
        ("16-deep k blocks M=4", (SLOTS, 512, 512), bf16, dict(block_k=16)),
        # Qwen1.5-MoE's shared-expert gate, an f32 product with N = 1, which
        # the wrapper pads to one 16-byte chunk (kernel_n): the f32 tile.
        ("shared gate N=1 M=4", (SLOTS, 2048, 1), f32, {}),
        ("shared gate N=1 M=128", (PROMPT, 2048, 1), f32, {}),
        ("N=1 bias+sigmoid+residual", (PROMPT, 2048, 1), f32,
         dict(activation="sigmoid", bias=True, residual=True)),
        ("bf16 N=3 M=4", (SLOTS, 2048, 3), bf16, {}),
    ]
    # Qwen1.5-MoE's dense GEMMs on [serve_qwen2_moe]'s path, at its decode
    # and prefill M: the 151,936-column unembed and the shared experts'
    # fused wi and wo.
    for label, (k, n) in QMOE_DENSE_GEMMS.items():
        for m in (SLOTS, PROMPT):
            cases.append((f"qwen2-moe {label} M={m}", (m, k, n), bf16, {}))
    max_err, failed = 0.0, []
    for label, (m, k, n), dtype, kw in cases:
        kw = dict(kw)
        lead = (kw.pop("batch"),) if "batch" in kw else ()
        a, b = rnd(*lead, m, k, dtype=dtype), rnd(*lead, k, n, dtype=dtype)
        if kw.pop("bias", False):
            kw["bias"] = rnd(n, dtype=dtype)
        if kw.pop("residual", False):
            kw["residual"] = rnd(*lead, m, n, dtype=dtype)
        blocks = [kw.get(f"block_{x}", 128) for x in "mnk"]
        tile = tile_config(m, kernel_n(n, blocks[1], dtype, kw.get("scramble_out", False)), k,
                           *blocks, dtype)
        reset_k1(mesh_matmul)
        out = mesh_matmul(a, b, **kw)
        ran = tile_counts(mesh_matmul)
        ref = mesh_matmul_torch(a, b, **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = tol_of(ref.float(), dtype)
        why = ("1e-5 max|ref|: summation order only, TF32 would show ~1e-4"
               if dtype == f32 else "2^-7 max|ref|: adjacent bf16 roundings")
        bad = []
        if not bool(torch.isfinite(out.float()).all()):
            bad.append("non-finite output")
        if not err <= tol:
            bad.append(f"err {err} > tol {tol}")
        if ran != {tile: 1}:
            bad.append(f"launched {ran}, want {tile}")
        log(f"[K1] {label:32s} {str(dtype)[6:]:8s} M={m} K={k} N={n} tile={tile:12s}"
            f" err={err:.3e} tol={tol:.3e} ({why}): " + ("FAIL " + "; ".join(bad) if bad else "ok"))
        if bad:
            failed.append(f"{label} {dtype}: {'; '.join(bad)}")
        max_err = max(max_err, err)
    check(not failed, f"K1 disagrees with its plain version: {failed}")

    # Timings at the decode tick's shapes (M = 4 slots) and the prefill's:
    # CUDA events over a loop (the wrapper's host cost sets the short ones)
    # and the profiler's device time, for the kernel and torch.matmul.
    per = {}
    for label, (k, n) in MESH_PAPER_GEMMS.items():
        for m in (SLOTS, PROMPT):
            copies = max(1, math.ceil(2 * L2_BYTES / (k * n * 2)))
            a = rnd(m, k)
            bs = [rnd(k, n) for _ in range(copies)]
            kernel_calls = [lambda b=b: mesh_matmul(a, b) for b in bs]
            lib_calls = [lambda b=b: torch.matmul(a, b) for b in bs]
            ms = time_ms(torch, kernel_calls, 30)
            plain = time_ms(torch, [lambda b=b: mesh_matmul_torch(a, b) for b in bs], 5)
            lib = time_ms(torch, lib_calls, 30)
            dev_ms = device_ms(torch, kernel_calls, 30)
            lib_dev = device_ms(torch, lib_calls, 30)
            bms, by = bound_ms(2 * (m * k + k * n + m * n), 2 * m * k * n, "bfloat16")
            per[(label, m)] = (ms, plain, lib, bms, by, dev_ms, lib_dev)
            log(
                f"[K1] time {label:20s} M={m:<4d} K={k:<5d} N={n:<6d}"
                f" tile={tile_config(m, n, k, 128, 128, 128, bf16)}: kernel={ms:.4f} ms"
                f" (device {dev_ms:.4f}) plain={plain:.4f} ms torch.matmul={lib:.4f} ms"
                f" (device {lib_dev:.4f}) bound={bms:.4f} ms ({by})"
            )
    keys = ("ms", "plain_ms", "library_ms", "bound_ms")
    tick = {key: sum(per[(lbl, SLOTS)][i] * TICK_LAUNCHES[lbl] for lbl in TICK_LAUNCHES)
            for i, key in enumerate(keys)}
    share = {"bytes": 0.0, "operations": 0.0}  # which limit most of the tick's bound is
    for lbl, count in TICK_LAUNCHES.items():
        share[per[(lbl, SLOTS)][4]] += per[(lbl, SLOTS)][3] * count
    tick["bound_by"] = max(share, key=share.get)
    for i, key in ((5, "device_ms"), (6, "library_device_ms")):
        tick[key] = sum(per[(lbl, SLOTS)][i] * c for lbl, c in TICK_LAUNCHES.items())
    log(f"[K1] one decode tick (25 launches, M={SLOTS}): " + json.dumps(tick))

    # K1b: the fully batched kernel (blockIdx.z) at the checked batched case.
    nb, m, k, n = 4, PROMPT, 1024, 512
    a3, b3 = rnd(nb, m, k), rnd(nb, k, n)
    ms = time_ms(torch, [lambda: mesh_matmul(a3, b3)], 30)
    dev_ms = device_ms(torch, [lambda: mesh_matmul(a3, b3)], 30)
    plain = time_ms(torch, [lambda: mesh_matmul_torch(a3, b3)], 5)
    lib = time_ms(torch, [lambda: torch.matmul(a3, b3)], 30)
    bms, by = bound_ms(2 * nb * (m * k + k * n + m * n), 2 * nb * m * k * n, "bfloat16")
    k1b = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by,
               device_ms=dev_ms)
    log(f"[K1b] time B={nb} M={m} K={k} N={n} bf16: kernel={ms:.4f} ms (device {dev_ms:.4f})"
        f" plain={plain:.4f} ms torch.matmul={lib:.4f} ms bound={bms:.5f} ms ({by})")
    return max_err, tick, k1b


def _paged_inputs(torch, g, s, h, kvh, hd, lengths, dtype, n_pages=None):
    n_pages = n_pages or max(-(-ln // PAGE) for ln in lengths) + 2
    pool_pages = 1 + s * n_pages
    rnd = lambda *shape: torch.randn(*shape, generator=g, device="cuda").to(dtype)  # noqa: E731
    q = rnd(s, h, hd)
    kp, vp = rnd(pool_pages, PAGE, kvh, hd), rnd(pool_pages, PAGE, kvh, hd)
    perm = torch.randperm(pool_pages - 1, generator=g, device="cuda") + 1
    bt = perm[: s * n_pages].reshape(s, n_pages).to(torch.int32)
    ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, kp, vp, bt, ln


# K4 against its plain version on K6's measures (see K6_LIMITS; rows are
# (slot, head) rows, and bf16 also gets "abs"), beside the max|v| limit.
# Each limit is 3-8x the largest reading over the cases on an NVIDIA H100
# 80GB HBM3 at 700 W: bf16 rel 2.80e-3, row 4.12e-3, elem 7.52e-3, abs
# 5.24e-3; f32 rel 4.79e-7, row 8.82e-7, elem 1.84e-6, abs 7.80e-7.  Faults
# planted in the kernel (a lane group's keys dropped, one key of each page
# dropped, bf16 halves swapped, one key past the length) fail every case
# they change by 3.6x or more, on each measure; the max|v| limit alone let
# the dropped keys pass at 2-4k tokens and the key past the length at 16k.
K4_LIMITS = {"bfloat16": dict(rel=2.0**-7, row=2.0**-6, elem=2.0**-5, abs=2.0**-6),
             "float32": dict(rel=2e-6, row=4e-6, elem=8e-6, abs=4e-6)}


def phase_k4(torch):
    """K4 (paged_attention_cuda) against paged_attention_torch, every case
    checked before a failure is raised, then timings."""
    from repro_torch.kernels.paged_attention import (
        paged_attention_cuda,
        paged_attention_torch,
        split_plan,
    )

    g = torch.Generator(device="cuda").manual_seed(2)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bf16, f32 = torch.bfloat16, torch.float32
    live = [PROMPT + NEW_TOKENS, PROMPT + 1, PROMPT + 21, PROMPT + 9]  # mid-page ends
    qwen = (SLOTS, *QWEN_HEADS)
    # Contexts ending on a split boundary and one token past it, at Qwen2-7B's
    # shape with a 130-page table: the split's tokens come from split_plan.
    edge_pages = 130
    run = split_plan(edge_pages, SLOTS * QWEN_HEADS[1], sms)[0] * PAGE
    edges = [5 * run, 5 * run + 1, 17 * run, 17 * run + 1]
    # label, (S, H, KV, hd), lengths, dtype, table width (None: from lengths)
    cases = [
        ("mesh-paper H=KV=16 rep=1", (SLOTS, 16, 16, 128), live, bf16, None),
        ("GQA rep=4", (SLOTS, 16, 4, 128), live, bf16, None),
        ("f32 rep=2, length 1", (3, 8, 4, 64), [1, 13, 40], f32, None),
        ("qwen2-7b rep=7, 2-4k tokens", qwen, QWEN_LIVE, bf16, None),
        ("qwen2-7b rep=7 f32", qwen, QWEN_LIVE, f32, None),
        ("split boundary / one past", qwen, edges, bf16, edge_pages),
        ("split boundary / one past f32", qwen, edges, f32, edge_pages),
        ("later splits empty, length 1", qwen, [1, 40, QWEN_LIVE[-1], 9], bf16, None),
        ("GQA rep=8", (SLOTS, 32, 4, 128), live, bf16, None),
        ("16k-token context", (2, *QWEN_HEADS), [16384 + 5, 700], bf16, None),
        ("16k-token context f32", (2, *QWEN_HEADS), [16384 + 5, 700], f32, None),
        ("mistral-large rep=12 (8 + 4)", MISTRAL_DECODE, QWEN_LIVE, bf16, None),
        ("mistral-large rep=12 (8 + 4) f32", MISTRAL_DECODE, QWEN_LIVE, f32, None),
    ]
    max_err, failed = 0.0, []
    for label, (s, h, kvh, hd), lengths, dtype, width in cases:
        q, kp, vp, bt, ln = _paged_inputs(torch, g, s, h, kvh, hd, lengths, dtype, width)
        split_pages, n_splits = split_plan(bt.shape[1], s * kvh, sms)
        before = paged_attention_cuda.launches
        out = paged_attention_cuda(q, kp, vp, bt, ln)
        launched = paged_attention_cuda.launches - before
        ref = paged_attention_torch(q, kp, vp, bt, ln)
        torch.cuda.synchronize()
        got = disagreement(torch, out, ref)
        err = got["err"]
        # bf16: probabilities round to bf16 before the p.v product at
        # different points (unnormalized per key group in the kernel,
        # normalized in the plain version), each term off by <= 2^-8
        # relative, plus the output rounding: 2^-6 of the largest |v|.  f32:
        # summation order only.  That bound does not scale with the output
        # (|out| is about sqrt(e / n) over n live keys), so the measures
        # relative to the output, K4_LIMITS, hold each case beside it.
        vmax = vp.float().abs().max().item()
        tol = (2.0**-6 if dtype == bf16 else 1e-5) * vmax
        why = ("2^-6 max|v|: p rounded to bf16 at different points, bf16 output"
               if dtype == bf16 else "1e-5 max|v|: summation order only")
        lim = K4_LIMITS[str(dtype).removeprefix("torch.")]
        bad = [f"{name} {got[name]:.3e} > {x:.3e}" for name, x in lim.items()
               if not got[name] <= x]
        if not bool(torch.isfinite(out.float()).all()):
            bad.append("non-finite output")
        if not err <= tol:
            bad.append(f"err {err} > tol {tol}")
        if launched != 1:
            bad.append(f"{launched} counted launches")
        log(f"[K4] {label:30s} {str(dtype)[6:]:8s} S={s} H={h} KV={kvh} hd={hd}"
            f" lengths={lengths} splits={n_splits}x{split_pages} pages"
            f" max|out|={ref.float().abs().max().item():.3e} "
            + " ".join(f"{name}={x:.3e}" for name, x in got.items())
            + f" tol={tol:.3e} ({why}) limits {lim}: "
            + ("FAIL " + "; ".join(bad) if bad else "ok"))
        if bad:
            failed.append(f"{label} {dtype}: {'; '.join(bad)}")
        max_err = max(max_err, err)
        del q, kp, vp, bt, ln, out, ref
    check(not failed, f"K4 disagrees with its plain version: {failed}")

    # Timings at the serving decode shapes (one launch per layer and tick):
    # mesh-paper's and Qwen2-7B's.
    mesh = _k4_time(torch, g, (SLOTS, 16, 16, 128), live)
    return max_err, mesh, _k4_time(torch, g, qwen, QWEN_LIVE)


def _k4_time(torch, g, shape, live):
    """K4's time at one decode shape: the kernel (CUDA events over a loop,
    which the wrapper's host cost sets at small sizes, and the profiler's
    device time, its combine included), the plain version, SDPA on the
    gathered context (timed here only, both ways) and the bound (each live
    K/V row, q and the output once; the tables and lengths)."""
    from repro_torch.kernels.paged_attention import (
        gather_pages,
        paged_attention_cuda,
        paged_attention_torch,
    )

    s, h, kvh, hd = shape
    q, kp, vp, bt, ln = _paged_inputs(torch, g, s, h, kvh, hd, live, torch.bfloat16)
    kernel = [lambda: paged_attention_cuda(q, kp, vp, bt, ln)]
    ms = time_ms(torch, kernel, 50)
    parts = []
    dev_ms = device_ms(torch, kernel, 50, rows=parts)
    split = ", ".join(f"{name.split('<')[0].split('::')[-1]} {us / 50e3:.5f} ms"
                      for us, _, name in parts)
    plain = time_ms(torch, [lambda: paged_attention_torch(q, kp, vp, bt, ln)], 20)
    kg, vg = gather_pages(kp, bt).transpose(1, 2), gather_pages(vp, bt).transpose(1, 2)
    mask = (torch.arange(kg.shape[2], device="cuda")[None, :] < ln[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    enable_gqa = dict(enable_gqa=True) if h != kvh else {}
    lib_call = [lambda: sdpa(q4, kg, vg, attn_mask=mask, **enable_gqa)]
    lib = time_ms(torch, lib_call, 50)
    lib_dev = device_ms(torch, lib_call, 50)
    tokens = sum(live)
    nbytes = 2 * (2 * q.numel() + 2 * tokens * kvh * hd) + 4 * (bt.numel() + ln.numel())
    bms, by = bound_ms(nbytes, 4 * h * hd * tokens, "bfloat16")
    log(
        f"[K4] time S={s} H={h} KV={kvh} hd={hd} lengths={live}: kernel={ms:.4f} ms"
        f" (device {dev_ms:.5f} ms: {split}) plain={plain:.4f} ms sdpa={lib:.4f} ms"
        f" (device {lib_dev:.5f} ms) bound={bms:.5f} ms ({by})"
    )
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by,
                device_ms=dev_ms, library_device_ms=lib_dev)


def phase_k3(torch):
    """K3 (scramble_blocks_cuda) against scramble_blocks_torch, bit for bit,
    then timings at the training activations' shape."""
    from repro_torch.kernels.scramble import scramble_blocks_cuda, scramble_blocks_torch

    g = torch.Generator(device="cuda").manual_seed(3)
    act = (TRAIN_BATCH, TRAIN_SEQ, 2048)  # mesh-paper's (B, T, D) activations
    cases = [
        ("mesh-paper activations k=1", act, 128, 128, 1, torch.bfloat16),
        ("mesh-paper activations k=-1", act, 128, 128, -1, torch.bfloat16),
        ("mesh-paper activations k=3", act, 128, 128, 3, torch.bfloat16),
        ("f32 8x8 grid k=1", (2, 1024, 1024), 128, 128, 1, torch.float32),
        ("g=5 k=2", (3, 640, 640), 128, 128, 2, torch.bfloat16),
        ("g=5, 40-byte rows k=-1", (3, 5 * 24, 5 * 20), 24, 20, -1, torch.bfloat16),
    ]
    max_err = 0.0
    for label, shape, bm, bn, k, dtype in cases:
        x = torch.randn(*shape, generator=g, device="cuda").to(dtype)
        out = scramble_blocks_cuda(x, block_m=bm, block_n=bn, k=k)
        ref = scramble_blocks_torch(x, block_m=bm, block_n=bn, k=k)
        torch.cuda.synchronize()
        equal = torch.equal(out, ref)
        err = (out.float() - ref.float()).abs().max().item()
        max_err = max(max_err, err)
        log(f"[K3] {label:28s} {tuple(shape)} {dtype} bitwise equal: {equal} max|d|={err}")
        check(equal, f"K3 {label}: kernel differs from its plain version")

    # Device time from the profiler: a launch of K3 is about as short as its
    # host-side cost, so CUDA events around a loop would time the host.  The
    # calls cycle through copies of x that exceed twice the L2, so each reads
    # its input from HBM, as the bound assumes.
    xs = [torch.randn(*act, generator=g, device="cuda").to(torch.bfloat16)]
    nbytes = xs[0].numel() * xs[0].element_size()
    xs += [xs[0].clone() for _ in range(math.ceil(2 * L2_BYTES / nbytes))]
    events = time_ms(torch, [lambda x=x: scramble_blocks_cuda(x) for x in xs], 50)
    ms = device_ms(torch, [lambda x=x: scramble_blocks_cuda(x) for x in xs], 50)
    plain = device_ms(torch, [lambda x=x: scramble_blocks_torch(x) for x in xs], 20)
    lib = device_ms(torch, [lambda x=x: x.clone() for x in xs], 50)
    bms, by = bound_ms(2 * nbytes, 0, "bfloat16")
    log(f"[K3] time {act} bf16 k=1 (device time): kernel={ms:.4f} ms plain={plain:.4f} ms"
        f" clone (same bytes, no permutation)={lib:.4f} ms bound={bms:.5f} ms ({by});"
        f" CUDA events over 50 back-to-back calls, host included: {events:.4f} ms;"
        f" {len(xs)} inputs cycled (cold L2)")
    return max_err, dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by)


def phase_k1_backward(torch):
    """K1's backward (api.mm_backward, the `_mm` VJP) run with the kernel
    against the same backward run with mesh_matmul_torch, then the f32 dA/dB
    GEMMs and the bf16 forward timed and checked at the training shapes
    (M = 4096).  Returns the largest error of K1 against its plain version."""
    from repro_torch.kernels import api
    from repro_torch.kernels.mesh_matmul import mesh_matmul, mesh_matmul_torch, tile_config

    g = torch.Generator(device="cuda").manual_seed(4)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    cases = [
        ("bias+gelu+residual", (PROMPT, 2048, 2048), False, "gelu"),
        ("scramble_out 8x8 grid", (1024, 2048, 1024), True, None),
    ]
    max_err = 0.0
    for label, (m, k, n), scramble, act in cases:
        # bf16 values; the backward's GEMMs run in f32 either way, so f32
        # operands hold dA, dB and dbias before their cast to the operands'
        # dtype, where the tolerance is stated.
        a, b, bias = rnd(m, k).float(), rnd(k, n).float(), rnd(n).float()
        ct = rnd(m, n)
        opts = api.MMOpts(128, 128, 128, True, scramble, torch.bfloat16, act)
        got = api.mm_backward(ct, a, b, bias, torch.bfloat16, opts, matmul=mesh_matmul)
        want = api.mm_backward(ct, a, b, bias, torch.bfloat16, opts, matmul=mesh_matmul_torch)
        torch.cuda.synchronize()
        for name, x, y in zip(("dA", "dB", "dbias"), got[:3], want[:3]):
            err = (x - y).abs().max().item()
            tol = 1e-5 * y.abs().max().item()
            max_err = max(max_err, err)
            log(f"[K1 bwd] {label:22s} {name:5s} err={err:.3e} tol={tol:.3e} (1e-5 max|ref|:"
                f" f32 outputs, summation order only)")
            check(bool(torch.isfinite(x).all()), f"K1 bwd {label} {name}: non-finite")
            check(err <= tol, f"K1 bwd {label} {name}: err {err} > tol {tol}")
        check(torch.equal(got[3], want[3]), f"K1 bwd {label}: dresidual differs")

    # Through autograd on the card: a bf16 GEMM's gradients come from K1.
    a = rnd(PROMPT, 2048).requires_grad_(True)
    b = rnd(2048, 2048).requires_grad_(True)
    spec = api.GemmSpec.from_operands(a, b, epilogue=api.Epilogue(activation="gelu"),
                                      out_dtype=torch.bfloat16)
    y = api.plan(spec, backend="cuda_mesh", device="cuda")(a, b)
    reset_k1(mesh_matmul)
    y.backward(rnd(PROMPT, 2048))
    torch.cuda.synchronize()
    launched, tiles = mesh_matmul.launches, tile_counts(mesh_matmul)
    log(f"[K1 bwd] autograd through a cuda_mesh plan: grad_fn={type(y.grad_fn).__name__},"
        f" {launched} K1 launches in backward (z remat, dA, dB), tiles {tiles}")
    check(launched == 3 and a.grad is not None and b.grad is not None,
          "cuda_mesh backward did not run on K1")
    check(tiles == {"f32_128": 3}, f"the _mm backward took tiles {tiles}, want f32_128")

    # Timings at the training shapes: 2 x 2048 tokens.  The last timed call
    # of the kernel and of the plain version are held against each other at
    # the tolerances of phase_k1: 1e-5·max|ref| for the f32 dA/dB GEMMs
    # (summation order only), 2^-7·max|ref| for the bf16 forward.
    m = TRAIN_BATCH * TRAIN_SEQ
    rows, failed = {}, []
    for label, (k, n) in MESH_PAPER_GEMMS.items():
        x, w = rnd(m, k), rnd(k, n)
        dz, w_t, x_t = rnd(m, n).float(), w.t().float().contiguous(), x.t().float().contiguous()
        work = {
            "fwd bf16": (x, w, dict(block_m=128, block_n=128, block_k=128), "bfloat16", 2),
            "dA f32": (dz, w_t, dict(block_m=128, block_n=128, block_k=128), "float32", 4),
            "dB f32": (x_t, dz, dict(block_m=128, block_n=128, block_k=128), "float32", 4),
        }
        for kind, (p, q, blocks, dt, size) in work.items():
            mm, kk, nn = p.shape[0], p.shape[1], q.shape[1]
            iters = 3 if dt == "float32" and mm * kk * nn > 2**34 else 10
            out = {}
            ms = time_ms(torch, [lambda: out.update(kernel=mesh_matmul(p, q, **blocks))],
                         iters, warmup=1)
            plain = time_ms(torch, [lambda: out.update(plain=mesh_matmul_torch(p, q, **blocks))],
                            1, warmup=1)
            lib = time_ms(torch, [lambda: torch.matmul(p, q)], iters, warmup=1)
            bms, by = bound_ms(size * (mm * kk + kk * nn + mm * nn), 2 * mm * kk * nn, dt)
            rows[(label, kind)] = (ms, plain, lib, bms, by)
            ref = out["plain"].float()
            err = (out["kernel"].float() - ref).abs().max().item()
            scale = ref.abs().max().item()
            tol = (1e-5 if dt == "float32" else 2.0**-7) * scale
            max_err = max(max_err, err)
            if not (err <= tol and bool(torch.isfinite(out["kernel"]).all())):
                failed.append(f"{label} {kind}: err {err} > tol {tol}")
            tile = tile_config(mm, nn, kk, 128, 128, 128, p.dtype)
            if tile in OLD_TILES:
                failed.append(f"{label} {kind}: takes the old tile {tile}")
            log(f"[K1 train] {label:20s} {kind:8s} {mm}x{kk}x{nn} {tile}: kernel={ms:.3f} ms"
                f" plain={plain:.3f} ms torch.matmul={lib:.3f} ms (TF32 off)"
                f" bound={bms:.3f} ms ({by}) {2 * mm * kk * nn / ms / 1e9:.2f} TFLOP/s;"
                f" err={err:.3e} tol={tol:.3e} (err/max|ref|={err / scale:.2e})")
            del out, ref
        del x, w, dz, w_t, x_t
    per_layer = {"attn (wq|wk|wv|wo)": 16, "mlp wi": 4, "mlp wo": 4, "lm_head": 1}
    step = {kind: sum(rows[(lbl, kind)][0] * c for lbl, c in per_layer.items())
            for kind in ("fwd bf16", "dA f32", "dB f32")}
    bound = {kind: sum(rows[(lbl, kind)][3] * c for lbl, c in per_layer.items())
             for kind in ("fwd bf16", "dA f32", "dB f32")}
    log(f"[K1 train] one step's 75 K1 launches at these times: "
        f"{sum(step.values()):.1f} ms (fwd {step['fwd bf16']:.1f}, dA {step['dA f32']:.1f},"
        f" dB {step['dB f32']:.1f}); bound {sum(bound.values()):.1f} ms")
    check(not failed, f"K1 at the training shapes differs from its plain version: {failed}")
    return max_err


def _routed_sizes(rng, tokens: int, experts: int = OLMOE_EXPERTS, topk: int = OLMOE_TOPK):
    """Rows per expert when each of `tokens` tokens picks `topk` distinct
    experts of `experts`, uniformly: the sizes a decode step or a prefill
    gives K5 under a router with no preference."""
    import numpy as np

    picks = [rng.choice(experts, topk, replace=False) for _ in range(tokens)]
    return np.bincount(np.concatenate(picks), minlength=experts).astype(np.int32)


def _train_moe_sizes(rng):
    """Rows per OLMoE expert in one [train_moe] step: TRAIN_BATCH x TRAIN_SEQ
    tokens routed top-8 with no preference, each expert capped at
    MOE_TRAIN_CAP (the pairs past it dropped)."""
    import numpy as np

    return np.minimum(_routed_sizes(rng, TRAIN_BATCH * TRAIN_SEQ), MOE_TRAIN_CAP)


def phase_k5(torch):
    """K5 (grouped_mesh_matmul) against grouped_mesh_matmul_torch at OLMoE's
    and Qwen1.5-MoE's decode and prefill shapes and at [train_moe]'s
    forward, then timings at OLMoE's: the kernel, the plain version,
    `torch.bmm` + segment mask (the reference's `xla` grouped impl, timed
    here only) and the bound, all as profiler device time."""
    import numpy as np

    from repro_torch.kernels import grouped as gr
    from repro_torch.kernels.grouped import grouped_mesh_matmul, grouped_mesh_matmul_torch

    g = torch.Generator(device="cuda").manual_seed(5)
    rng = np.random.default_rng(5)
    n_grp = OLMOE_EXPERTS

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    def valid_rows(sizes, rpg):
        return torch.arange(rpg, device="cuda")[None, :] < sizes[:, None]  # (G, rpg)

    routed = {"decode": _routed_sizes(rng, SLOTS), "prefill": _routed_sizes(rng, PROMPT)}
    cases = []
    for phase, (rpg, bm) in K5_SHAPES.items():
        edge = rng.integers(0, rpg + 1, n_grp).astype(np.int32)
        edge[:3] = (0, rpg, rpg // 2)  # empty, full, and in between
        for label, (k, n) in K5_GEMMS.items():
            for how, sizes in (("edge sizes", edge), ("routed", routed[phase])):
                cases.append((f"{phase} {label} {how}", n_grp, rpg, bm, k, n, sizes,
                              torch.bfloat16, {}))
    # Qwen1.5-MoE's expert GEMMs on [serve_qwen2_moe]'s path: 60 groups,
    # each token routed top-4, at the same decode and prefill rows.
    for phase, (rpg, bm) in K5_SHAPES.items():
        tokens = SLOTS if phase == "decode" else PROMPT
        edge = rng.integers(0, rpg + 1, QMOE_EXPERTS).astype(np.int32)
        edge[:3] = (0, rpg, rpg // 2)
        qrouted = _routed_sizes(rng, tokens, QMOE_EXPERTS, QMOE_TOPK)
        for label, (k, n) in QMOE_K5_GEMMS.items():
            for how, sizes in (("edge sizes", edge), ("routed", qrouted)):
                cases.append((f"qwen2-moe {phase} {label} {how}", QMOE_EXPERTS, rpg, bm, k, n,
                              sizes, torch.bfloat16, {}))
    # [train_moe]'s forward: OLMoE's experts at capacity MOE_TRAIN_CAP rows
    # (a step's tokens routed top-8, the excess dropped), block_m 128.
    edge = rng.integers(0, MOE_TRAIN_CAP + 1, n_grp).astype(np.int32)
    edge[:3] = (0, MOE_TRAIN_CAP, MOE_TRAIN_CAP // 2)
    for label, (k, n) in K5_GEMMS.items():
        for how, sizes in (("edge sizes", edge), ("routed", _train_moe_sizes(rng))):
            cases.append((f"train_moe {label} {how}", n_grp, MOE_TRAIN_CAP, 128, k, n, sizes,
                          torch.bfloat16, {}))
    epi_sizes = np.array([0, 128, 64, 1, 100, 128, 17, 0], np.int32)
    epi = dict(bias=True, residual=True, activation="silu")
    cases.append(("f32 bias+silu+residual", 8, PROMPT, PROMPT, 1024, 512, epi_sizes,
                  torch.float32, epi))
    cases.append(("bf16 bias+silu+residual", 8, PROMPT, PROMPT, 1024, 512, epi_sizes,
                  torch.bfloat16, epi))
    cases.append(("bf16 decode bias+gelu+residual", 8, 8, 8, 1024, 512,
                  np.array([0, 8, 3, 1, 8, 5, 2, 0], np.int32), torch.bfloat16,
                  dict(bias=True, residual=True, activation="gelu")))
    # Ragged N and K (masked, not padded), 24-row blocks (a row tile cut at
    # the block's end, sizes on both sides of it), and 16-row decode blocks.
    cases.append(("bf16 ragged N, K", 6, 48, 24, 1000, 360,
                  np.array([48, 0, 23, 24, 25, 7], np.int32), torch.bfloat16, {}))
    cases.append(("bf16 decode ragged N, K, bm=16", 6, 16, 16, 1000, 360,
                  np.array([16, 0, 15, 1, 9, 16], np.int32), torch.bfloat16, {}))
    max_err, failed = 0.0, []
    for label, grp, rpg, bm, k, n, sizes_np, dtype, kw in cases:
        kw = dict(kw)
        sizes = torch.as_tensor(sizes_np, device="cuda")
        tokens, w = rnd(grp * rpg, k, dtype=dtype), rnd(grp, k, n, dtype=dtype)
        if kw.pop("bias", False):
            kw["bias"] = rnd(grp, n, dtype=dtype)
        if kw.pop("residual", False):
            kw["residual"] = rnd(grp * rpg, n, dtype=dtype)
        blocks = dict(block_m=bm, block_n=128, block_k=128)
        want = gr.tile_config(n, k, bm, 128, 128, dtype)
        before = dict(grouped_mesh_matmul.launches_by_config)
        out = grouped_mesh_matmul(tokens, sizes, w, **blocks, **kw)
        ran = [c for c, x in grouped_mesh_matmul.launches_by_config.items()
               if x != before.get(c, 0)]
        ref = grouped_mesh_matmul_torch(tokens, sizes, w, **blocks, **kw)
        torch.cuda.synchronize()
        masked = out.reshape(grp, rpg, n)[~valid_rows(sizes, rpg)]
        nonzero = int(torch.count_nonzero(masked))
        err = (out.float() - ref.float()).abs().max().item()
        tol = (1e-5 if dtype == torch.float32 else 2.0**-7) * ref.float().abs().max().item()
        why = ("1e-5 max|ref|: summation order only" if dtype == torch.float32
               else "2^-7 max|ref|: adjacent bf16 roundings")
        bad = []
        if nonzero:
            bad.append(f"{nonzero} masked values are not exact zeros")
        if not bool(torch.isfinite(out.float()).all()):
            bad.append("non-finite output")
        if not err <= tol:
            bad.append(f"err {err} > tol {tol}")
        if ran != [want]:
            bad.append(f"ran on {ran}, tile_config names {want}")
        if dtype == torch.bfloat16 and not want.startswith("tc"):
            bad.append(f"a bf16 case on the SIMT tile {want}")
        log(f"[K5] {label:30s} {str(dtype)[6:]:8s} G={grp} rpg={rpg} bm={bm} K={k} N={n}"
            f" on {want}: non-empty={int((sizes > 0).sum())} masked rows nonzero={nonzero}"
            f" err={err:.3e} tol={tol:.3e} ({why}): " + ("FAIL " + "; ".join(bad) if bad else "ok"))
        if bad:
            failed.append(f"{label} {dtype}: {'; '.join(bad)}")
        max_err = max(max_err, err)
        del tokens, w, out, ref, kw
    failed += _k5_order_witness(torch, gr)
    check(not failed, f"K5 disagrees with its plain version: {failed}")

    # Timings with routed sizes.  Calls cycle through two weight sets (each
    # read over 2 x the L2 in every shape but decode wo, 106 MB), so weights
    # come from HBM, as the bound assumes.  Bound: the valid token rows,
    # the non-empty experts' weights and the whole output once, at 3.35
    # TB/s, or the FLOPs of the non-empty block_m-row blocks at 989 TFLOP/s.
    per = {}
    for phase, (rpg, bm) in K5_SHAPES.items():
        sizes_np = routed[phase]
        sizes = torch.as_tensor(sizes_np, device="cuda")
        valid = valid_rows(sizes, rpg)[..., None]
        live = int((sizes_np > 0).sum())
        for label, (k, n) in K5_GEMMS.items():
            tokens = torch.where(valid, rnd(n_grp, rpg, k), 0).reshape(n_grp * rpg, k)
            ws = [rnd(n_grp, k, n) for _ in range(2)]
            blocks = dict(block_m=bm, block_n=128, block_k=128)
            tile = gr.tile_config(n, k, bm, 128, 128, torch.bfloat16)
            ms = device_ms(torch, [lambda w=w: grouped_mesh_matmul(tokens, sizes, w, **blocks)
                                   for w in ws], 20)
            plain = device_ms(torch, [lambda w=w: grouped_mesh_matmul_torch(
                tokens, sizes, w, **blocks) for w in ws], 2)
            t3 = tokens.view(n_grp, rpg, k)
            lib = device_ms(torch, [lambda w=w: torch.where(valid, torch.bmm(t3, w), 0)
                                    for w in ws], 20)
            row_blocks = int(np.sum(-(-sizes_np // bm)))
            nbytes = 2 * (int(sizes_np.sum()) * k + live * k * n + n_grp * rpg * n)
            bms, by = bound_ms(nbytes, 2 * row_blocks * bm * k * n, "bfloat16")
            per[(phase, label)] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms,
                                       bound_by=by, tile=tile)
            log(f"[K5] time {phase:7s} {label} G={n_grp} rpg={rpg} K={k} N={n} non-empty={live}"
                f" rows={int(sizes_np.sum())} on {tile}: kernel={ms:.4f} ms plain={plain:.4f} ms"
                f" bmm+mask={lib:.4f} ms bound={bms:.4f} ms ({by}) (device time)")
            del tokens, ws, t3

    def per_layer_sum(phase):
        """wi + wo, times the 16 layers: one decode step's or prefill's K5."""
        rows = [per[(phase, label)] for label in K5_GEMMS]
        out = {key: OLMOE_LAYERS * sum(r[key] for r in rows)
               for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
        share = {"bytes": 0.0, "operations": 0.0}
        for r in rows:
            share[r["bound_by"]] += r["bound_ms"]
        out["bound_by"] = max(share, key=share.get)
        out["tile"] = sorted({r["tile"] for r in rows})
        return out

    tick, prefill = per_layer_sum("decode"), per_layer_sum("prefill")
    log(f"[K5] one decode step (32 launches, {SLOTS} tokens): " + json.dumps(tick))
    log(f"[K5] one {PROMPT}-token prefill (32 launches): " + json.dumps(prefill))
    return max_err, tick, prefill


def _k5_order_witness(torch, gr):
    """K5's k order, exactly, on every tile family: each cell's three k
    blocks of 32 carry one term each, 2^24, 1 and -2^24 (tokens one-hot at
    k = 0, 32, 64; weights those values), so its f32 sum reads 0 when the
    cell starts at block 0 ((2^24 + 1) rounds to 2^24) and 1 when it starts
    at block 1 or 2.  A cell that walks its blocks in another order than
    (g + i + j + s) mod 3 reads the other value.  The plain version sums in
    that order; the kernel must match it bit for bit.  (With 32-deep blocks
    the decode tile's warps take one block each and meet in warp order,
    which is the same order.)  Returns the failing cases."""
    grp, n, k = 6, 256, 96
    failed = []
    for rpg, bm, dtype in ((96, 32, torch.bfloat16), (16, 8, torch.bfloat16),
                           (96, 32, torch.float32), (16, 8, torch.float32)):
        tokens = torch.zeros(grp * rpg, k, dtype=dtype, device="cuda")
        tokens[:, [0, 32, 64]] = 1
        w = torch.zeros(grp, k, n, dtype=dtype, device="cuda")
        w[:, 0], w[:, 32], w[:, 64] = 2.0**24, 1.0, -(2.0**24)
        sizes = torch.full((grp,), rpg, dtype=torch.int32, device="cuda")
        blocks = dict(block_m=bm, block_n=128, block_k=32)
        tile = gr.tile_config(n, k, bm, 128, 32, dtype)
        out = gr.grouped_mesh_matmul(tokens, sizes, w, **blocks)
        ref = gr.grouped_mesh_matmul_torch(tokens, sizes, w, **blocks)
        torch.cuda.synchronize()
        ones = int((ref == 1).sum())
        ok = torch.equal(out, ref) and 0 < ones < ref.numel()
        log(f"[K5] k-order witness {str(dtype)[6:]:8s} G={grp} rpg={rpg} bm={bm} K={k} N={n}"
            f" blocks of 32 on {tile}: {ones} of {ref.numel()} outputs read 1 in the plain"
            f" version, {int((out != ref).sum())} differ: " + ("ok" if ok else "FAIL"))
        if not ok:
            failed.append(f"k-order witness {dtype} on {tile}: {int((out != ref).sum())} differ")
    return failed


def phase_k5_backward(torch):
    """K5's backward (api.gmm_backward, the `_gmm` VJP) run with the kernel
    against the same backward run with grouped_mesh_matmul_torch, then
    autograd through a cuda_mesh grouped plan."""
    from repro_torch.kernels import api
    from repro_torch.kernels.grouped import grouped_mesh_matmul, grouped_mesh_matmul_torch

    g = torch.Generator(device="cuda").manual_seed(6)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    grp, rpg, k, n = 8, PROMPT, 1024, 512
    sizes = torch.tensor([0, 128, 64, 1, 100, 128, 17, 0], dtype=torch.int32, device="cuda")
    # bf16 values in f32 operands: the backward's GEMMs run in f32 either way.
    tokens, w, bias = rnd(grp * rpg, k).float(), rnd(grp, k, n).float(), rnd(grp, n).float()
    ct = rnd(grp * rpg, n)
    opts = api.MMOpts(PROMPT, 128, 128, True, False, torch.bfloat16, "silu")
    got = api.gmm_backward(ct, tokens, sizes, w, bias, torch.bfloat16, opts,
                           matmul=grouped_mesh_matmul)
    want = api.gmm_backward(ct, tokens, sizes, w, bias, torch.bfloat16, opts,
                            matmul=grouped_mesh_matmul_torch)
    torch.cuda.synchronize()
    max_err = 0.0
    for name, x, y in zip(("dtokens", "dW", "dbias"), got[:3], want[:3]):
        err = (x - y).abs().max().item()
        tol = 1e-5 * y.abs().max().item()
        max_err = max(max_err, err)
        log(f"[K5 bwd] G={grp} rpg={rpg} K={k} N={n} bias+silu+residual {name:7s}"
            f" err={err:.3e} tol={tol:.3e} (1e-5 max|ref|: f32 outputs, summation order only)")
        check(bool(torch.isfinite(x).all()), f"K5 bwd {name}: non-finite")
        check(err <= tol, f"K5 bwd {name}: err {err} > tol {tol}")
    check(torch.equal(got[3], want[3]), "K5 bwd: dresidual differs")

    # [train_moe]'s backward of wi and wo (no activation): dtokens on K5's
    # f32 tiles at 64 groups of MOE_TRAIN_CAP rows, routed sizes.
    import numpy as np

    sizes_np = _train_moe_sizes(np.random.default_rng(6))
    tsizes = torch.as_tensor(sizes_np, device="cuda")
    rpg, topts = MOE_TRAIN_CAP, api.MMOpts(128, 128, 128, True, False, torch.bfloat16, None)
    for label, (k, n) in K5_GEMMS.items():
        tokens, w = rnd(OLMOE_EXPERTS * rpg, k).float(), rnd(OLMOE_EXPERTS, k, n).float()
        ct = rnd(OLMOE_EXPERTS * rpg, n)
        got = api.gmm_backward(ct, tokens, tsizes, w, None, None, topts,
                               matmul=grouped_mesh_matmul)
        want = api.gmm_backward(ct, tokens, tsizes, w, None, None, topts,
                                matmul=grouped_mesh_matmul_torch)
        torch.cuda.synchronize()
        for name, x, y in zip(("dtokens", "dW"), got[:2], want[:2]):
            err = (x - y).abs().max().item()
            tol = 1e-5 * y.abs().max().item()
            max_err = max(max_err, err)
            log(f"[K5 bwd] train_moe {label} G={OLMOE_EXPERTS} rpg={rpg} K={k} N={n} routed"
                f" rows={int(sizes_np.sum())} {name:7s} err={err:.3e} tol={tol:.3e}"
                f" (1e-5 max|ref|: f32 outputs, summation order only)")
            check(bool(torch.isfinite(x).all()), f"K5 bwd train_moe {label} {name}: non-finite")
            check(err <= tol, f"K5 bwd train_moe {label} {name}: err {err} > tol {tol}")
        del tokens, w, ct, got, want

    # Through autograd on the card: a bf16 grouped GEMM's gradients come from K5.
    off = torch.cat([torch.zeros(1, dtype=torch.int32, device="cuda"),
                     torch.cumsum(sizes, 0).to(torch.int32)])
    t = rnd(grp * rpg, k).requires_grad_(True)
    wb = rnd(grp, k, n).requires_grad_(True)
    spec = api.GemmSpec.for_groups(api.GroupSpec(grp, rpg), k, n, dtype_a=torch.bfloat16,
                                   dtype_b=torch.bfloat16, out_dtype=torch.bfloat16,
                                   epilogue=api.Epilogue(activation="silu"))
    y = api.plan(spec, backend="cuda_mesh", device="cuda")(t, off, wb)
    before = grouped_mesh_matmul.launches
    y.backward(rnd(grp * rpg, n))
    torch.cuda.synchronize()
    launched = grouped_mesh_matmul.launches - before
    log(f"[K5 bwd] autograd through a cuda_mesh grouped plan: grad_fn="
        f"{type(y.grad_fn).__name__}, {launched} K5 launches in backward (z remat, dtokens);"
        f" grads None: tokens {t.grad is None}, W {wb.grad is None}")
    check(launched == 2 and t.grad is not None and wb.grad is not None,
          "cuda_mesh grouped backward did not run on K5")
    return max_err


# K6 against its plain version, per input type, on measures scaled by the
# output (late causal rows average thousands of keys, so their outputs are
# far below max|v|): "rel" ||d|| / ||ref|| over the whole output; "row" the
# largest ||d|| / ||ref|| of one (token, head) row; "elem" the largest
# |d| / (|ref| + rms of the element's row of ref); f32 also "abs", max |d| /
# max |ref|.  bf16 (unit roundoff 2^-8): p rounds to bf16 against other
# running maxima (64-key tiles in the kernel, block_k chunks in the plain
# version), the plain version rounds each chunk's P.V to bf16, and both
# round the output: about 2^-8 / sqrt(3) relative noise from each, so 2^-6
# for the norms and 2^-5 for the largest of millions of elements.  f32:
# summation order only.
K6_LIMITS = {"bfloat16": dict(rel=2.0**-6, row=2.0**-6, elem=2.0**-5),
             "float32": dict(rel=1e-5, row=1e-5, elem=1e-4, abs=1e-5)}


def disagreement(torch, out, ref):
    """A kernel's output against its plain version's, rows on the last axis:
    {measure: value} for each measure of K6_LIMITS and K4_LIMITS, and max
    |d| as "err"."""
    d = (out.float() - ref.float()).abs()
    r = ref.float()
    row_norm = r.norm(dim=-1)
    rms = (row_norm / r.shape[-1] ** 0.5)[..., None]
    return dict(err=d.max().item(), rel=(d.norm() / r.norm()).item(),
                row=(d.norm(dim=-1) / row_norm.clamp_min(1e-30)).max().item(),
                elem=(d / (r.abs() + rms).clamp_min(1e-30)).max().item(),
                abs=(d.max() / r.abs().max()).item())


def _causal_flash_work(b, t, h, kvh, hd, size):
    """(bytes, FLOPs) causal K6 needs: Q, K, V read and O written once; two
    hd-long products per (query, key) pair the mask keeps, t (t + 1) / 2 a
    head."""
    pairs = t * (t + 1) // 2
    return size * (2 * b * t * h * hd + 2 * b * t * kvh * hd), 4 * b * h * hd * pairs


def phase_k6(torch):
    """K6 (flash_attention_cuda) against flash_attention_torch at the shapes
    the serving and training paths give it, in bf16 (as they run: the
    tensor-core kernel) and f32 (the SIMT kernel, where the two agree to
    summation order), and causal with Tq != Tk (the reference's top-left
    mask), then timings: the kernel (CUDA events and profiler device time),
    the plain version, SDPA (causal, GQA; timed here only) and the bound.
    Every case is checked before a failure is raised, so one run shows which
    cases a fault breaks."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_torch

    g = torch.Generator(device="cuda").manual_seed(7)
    h, kvh, hd = QWEN_HEADS
    bf16, f32 = torch.bfloat16, torch.float32
    blocks = (QWEN_CHUNK, QWEN_CHUNK)
    qwen, mesh = (1, 2048, h, kvh, hd), (TRAIN_BATCH, TRAIN_SEQ, 16, 16, 128)
    # label, (B, Tq, H, KV, hd), Tk (None: Tq), causal, dtype, (block_q, block_k)
    cases = [
        ("qwen2-7b prefill T=2048", qwen, None, True, bf16, blocks),
        ("qwen2-7b prefill T=2048", qwen, None, True, f32, blocks),
        ("qwen2-7b prefill T=4096", (1, 4096, h, kvh, hd), None, True, bf16, blocks),
        ("mesh-paper train", mesh, None, True, bf16, blocks),
        ("mesh-paper train", mesh, None, True, f32, blocks),
        ("f32 full MQA", (2, 192, 8, 1, 64), None, False, f32, (64, 64)),
        ("f32 rep=3 causal, ragged tiles", (1, 100, 6, 2, 32), None, True, f32, (150, 50)),
        ("bf16 rep=3 causal", (2, 320, 6, 2, 128), None, True, bf16, (64, 64)),
        ("bf16 full rep=7 hd=64, ragged", (1, 200, 14, 2, 64), 136, False, bf16, (56, 8)),
        ("causal Tq<Tk rep=1", (1, 256, 8, 8, 128), 640, True, bf16, (64, 64)),
        ("causal Tq<Tk rep=1", (1, 256, 8, 8, 128), 640, True, f32, (64, 64)),
        ("causal Tq>Tk rep=2", (2, 576, 8, 4, 128), 192, True, bf16, (64, 64)),
        ("causal Tq>Tk rep=2", (2, 576, 8, 4, 128), 192, True, f32, (64, 64)),
        ("causal Tq<Tk rep=2 hd=64", (1, 96, 8, 4, 64), 1024, True, bf16, (64, 64)),
    ]
    max_err, failed = 0.0, []
    for label, (b, t, hq, kv, d), tk, causal, dtype, (bq, bk) in cases:
        tk = t if tk is None else tk
        q = torch.randn(b, t, hq, d, generator=g, device="cuda").to(dtype)
        k, v = (torch.randn(b, tk, kv, d, generator=g, device="cuda").to(dtype) for _ in "kv")
        out = flash_attention_cuda(q, k, v, causal=causal)
        ref = flash_attention_torch(q, k, v, causal=causal, block_q=bq, block_k=bk)
        torch.cuda.synchronize()
        got = disagreement(torch, out, ref)
        lim = K6_LIMITS[str(dtype).removeprefix("torch.")]
        bad = [f"{name} {got[name]:.3e} > {x:.3e}" for name, x in lim.items()
               if not got[name] <= x]
        if not bool(torch.isfinite(out.float()).all()):
            bad.append("non-finite output")
        kernel = "mma.sync" if dtype == bf16 else "SIMT f32"
        log(f"[K6] {label:30s} {str(dtype)[6:]:8s} Tq={t} Tk={tk} causal={causal}"
            f" blocks=({bq},{bk}) on {kernel}: "
            + " ".join(f"{name}={x:.3e}" for name, x in got.items())
            + f" (max|v| {v.float().abs().max().item():.3f}) limits {lim}: "
            + ("FAIL " + "; ".join(bad) if bad else "ok"))
        if bad:
            failed.append(f"{label} {dtype}: {'; '.join(bad)}")
        max_err = max(max_err, got["err"])
        del q, k, v, out, ref
    failed += _k6_rounding_witness(torch, g)
    check(not failed, f"K6 disagrees with its plain version: {failed}")

    sdpa = torch.nn.functional.scaled_dot_product_attention
    per = {}
    timed = (("qwen2 T=2048", qwen), ("qwen2 T=4096", (1, 4096, h, kvh, hd)),
             ("mesh-paper train", mesh))
    for label, (b, t, hq, kv, d) in timed:
        q = torch.randn(b, t, hq, d, generator=g, device="cuda").to(bf16)
        k, v = (torch.randn(b, t, kv, d, generator=g, device="cuda").to(bf16) for _ in "kv")
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        gqa = dict(enable_gqa=True) if hq != kv else {}
        call = [lambda: flash_attention_cuda(q, k, v, causal=True)]
        ms = time_ms(torch, call, 10)
        dev = device_ms(torch, call, 10)
        plain = time_ms(torch, [lambda: flash_attention_torch(
            q, k, v, causal=True, block_q=QWEN_CHUNK, block_k=QWEN_CHUNK)], 3, warmup=1)
        lib_call = [lambda: sdpa(qt, kt, vt, is_causal=True, **gqa)]
        lib = time_ms(torch, lib_call, 20)
        lib_dev = device_ms(torch, lib_call, 20)
        nbytes, flops = _causal_flash_work(b, t, hq, kv, d, 2)
        bms, by = bound_ms(nbytes, flops, "bfloat16")
        per[label] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by,
                          device_ms=dev, library_device_ms=lib_dev,
                          shape=f"B={b} T={t} H={hq} KV={kv} hd={d} bf16 causal")
        log(f"[K6] time {label:16s} B={b} T={t} H={hq} KV={kv} hd={d} bf16 causal:"
            f" kernel={ms:.4f} ms ({flops / ms / 1e9:.2f} TFLOP/s) device={dev:.4f} ms"
            f" ({flops / dev / 1e9:.2f} TFLOP/s) plain={plain:.4f} ms sdpa={lib:.4f} ms"
            f" (device {lib_dev:.4f} ms) bound={bms:.4f} ms ({by})")
        del q, k, v, qt, kt, vt
    return max_err, per


def _k6_rounding_witness(torch, g):
    """Where K6 rounds p, exactly: query token 1 of a causal bf16 sequence
    sees keys 0 and 1 with scores 0.25 and 0.125 (q one-hot, k[:, 0] 2 and
    1, scale 1/8), so p = (1, e^-0.125) and bf16(e^-0.125) = 113/128, 0.0003
    from the f32 value and far from a rounding tie.  With v1 = +-2^e and v0
    = -113/128 v1, the reference's P.V (p rounded to v's type first) is 0
    exactly, and so is the output row; a kernel that multiplies V by the
    unrounded p, or rounds elsewhere, leaves (p - bf16(p)) v1 / l there.
    The row is held to be exactly 0 and the other rows by K6_LIMITS.
    Returns the failing cases."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_torch

    b, t, hd = 1, 64, 64
    q = torch.randn(b, t, 1, hd, generator=g, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn(b, t, 1, hd, generator=g, device="cuda").to(torch.bfloat16)
            for _ in "kv")
    q[0, 1, 0] = 0
    q[0, 1, 0, 0] = 1
    k[0, 0, 0, 0], k[0, 1, 0, 0] = 2, 1
    signs = torch.randint(0, 2, (hd,), generator=g, device="cuda") * 2 - 1
    v1 = (signs * 2.0 ** torch.randint(-2, 3, (hd,), generator=g, device="cuda")).float()
    v[0, 1, 0] = v1.to(torch.bfloat16)
    v[0, 0, 0] = (-113 / 128 * v1).to(torch.bfloat16)
    out = flash_attention_cuda(q, k, v, causal=True)
    ref = flash_attention_torch(q, k, v, causal=True, block_q=64, block_k=64)
    torch.cuda.synchronize()
    got = disagreement(torch, out, ref)
    lim = K6_LIMITS["bfloat16"]
    bad = [f"{name} {got[name]:.3e} > {x:.3e}" for name, x in lim.items() if not got[name] <= x]
    row = out[0, 1, 0].float().abs().max().item()
    if ref[0, 1, 0].abs().max().item() != 0 or row != 0:
        bad.append(f"token 1 reads max |out| {row:.3e} (plain version"
                   f" {ref[0, 1, 0].float().abs().max().item():.3e}), not 0")
    log(f"[K6] p-rounding witness, token 1 exactly 0 bfloat16 T={t} hd={hd} causal on mma.sync:"
        f" token 1 max |out| {row:.3e}; " + " ".join(f"{n}={x:.3e}" for n, x in got.items())
        + ": " + ("FAIL " + "; ".join(bad) if bad else "ok"))
    return [f"p-rounding witness: {'; '.join(bad)}"] if bad else []


def phase_k6_backward(torch):
    """`flash_attention` on the card runs K6 under `_FlashAttention` and
    yields gradients.  The backward recomputes the plain chunked recurrence
    and never reads K6's output, so its values are held against `jax.grad`
    by the CPU tests and through a training step by `[train_flash]`; here
    only the launch, the autograd node and real gradients are checked."""
    from repro_torch.kernels.flash_attention import flash_attention

    g = torch.Generator(device="cuda").manual_seed(8)
    shape = (TRAIN_BATCH, TRAIN_SEQ, 16, 128)
    qkv = [torch.randn(*shape, generator=g, device="cuda").to(torch.bfloat16).requires_grad_(True)
           for _ in range(3)]
    ct = torch.randn(*shape, generator=g, device="cuda").to(torch.bfloat16)
    before = flash_attention.launches
    out = flash_attention(*qkv, causal=True, block_q=QWEN_CHUNK, block_k=QWEN_CHUNK)
    launched = flash_attention.launches - before
    grads = torch.autograd.grad(out, qkv, ct)
    torch.cuda.synchronize()
    check(launched == 1 and type(out.grad_fn).__name__ == "_FlashAttentionBackward",
          f"flash_attention did not run K6 under _FlashAttention ({launched} launches,"
          f" grad_fn {type(out.grad_fn).__name__})")
    for name, x in zip(("dq", "dk", "dv"), grads):
        check(x is not None and x.shape == out.shape and x.dtype == out.dtype
              and bool(torch.isfinite(x.float()).all()) and bool(x.abs().max() > 0),
              f"K6 bwd {name}: {None if x is None else (x.shape, x.dtype)}")
    log(f"[K6 bwd] {TRAIN_BATCH}x{TRAIN_SEQ} H=KV=16 hd=128 bf16 causal: 1 K6 launch under"
        f" _FlashAttention; dq, dk, dv finite, non-zero, of q's shape and type")


def kernel_rows(prof):
    """(device us, count, name) of each kernel in a torch.profiler run, most
    time first.  Kernel events only: a CPU op's row repeats its kernels' time."""
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0.0)
        if str(getattr(ev, "device_type", "")).endswith("CUDA") and dev_us > 0:
            rows.append((dev_us, ev.count, ev.key))
    rows.sort(reverse=True)
    return rows


def phase_serve(torch):
    """Full-width mesh-paper through the continuous-batching server."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.mesh_matmul import mesh_matmul
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    from repro_torch.launch.scheduler import ContinuousBatchingServer, Request, ServeConfig
    from repro_torch.launch.serve import generate, serving_steps
    from repro_torch.models import get_model

    cfg = get_config("mesh-paper")
    check(
        (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.d_ff, cfg.vocab_size)
        == (4, 2048, 16, 8192, 32768) and cfg.param_dtype == "bfloat16",
        f"unexpected mesh-paper config {cfg}",
    )
    model = get_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, PROMPT).astype(np.int32) for _ in range(REQUESTS)]
    pages = -(-(PROMPT + NEW_TOKENS) // PAGE)
    scfg = ServeConfig(
        max_slots=SLOTS, page_size=PAGE, num_pages=1 + SLOTS * pages,
        max_pages_per_seq=pages, queue_capacity=REQUESTS, warmup_prompt_lens=(PROMPT,),
    )

    reset_k1(mesh_matmul)
    paged_attention_cuda.launches = 0
    server = ContinuousBatchingServer(model, params, scfg, device="cuda")
    server.warmup()
    reqs = [Request(rid=f"req{i}", prompt=p, max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    results = server.run(reqs)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {"mesh_matmul": mesh_matmul.launches,
                "paged_attention": paged_attention_cuda.launches}
    check_main_path_tiles("serve", tile_counts(mesh_matmul), canary=True)

    for r in reqs:
        res = results[r.rid]
        check(res.status == "ok" and len(res.tokens) == NEW_TOKENS,
              f"{r.rid}: {res.status} with {len(res.tokens)} tokens ({res.reason})")
    check(all(v > 0 for v in launches.values()), f"a kernel never launched: {launches}")
    generated = sum(len(results[r.rid].tokens) for r in reqs)
    log(f"[serve] {REQUESTS} requests x {NEW_TOKENS} tokens: wall={wall:.3f} s "
        f"tokens/s={generated / wall:.1f} ticks={server.counters['ticks']} "
        f"launches={launches} counters={server.counters}")

    # Output check against the dense-cache path (plain _sdpa attention).
    # Greedy tokens of a random bf16 model are full of near-ties, so beyond
    # the first token (same prefill on both paths, equal exactly) the check
    # is on logits: teacher-forced with the server's tokens, paged decode
    # (K1 + K4) and dense decode (K1 + _sdpa) must agree within LOGIT_TOL,
    # and each of the server's tokens must be within LOGIT_TOL of the dense
    # argmax.  LOGIT_TOL = 0.125: 8 bf16 ulps at |logit| in [4, 8), for two
    # attention implementations that round probabilities at different points,
    # compounded over 4 layers.
    logit_tol = 0.125
    served = results["req0"].tokens
    ref_tokens, _ = generate(model, params, torch.as_tensor(prompts[0], device="cuda")[None],
                             gen_len=8)
    ref_tokens = ref_tokens[0].tolist()
    check(served[0] == ref_tokens[0], f"first token {served[0]} != generate's {ref_tokens[0]}")
    prefill, serve = serving_steps(model)
    with torch.inference_mode():
        prompt = torch.as_tensor(prompts[0], device="cuda")[None]
        _, caches = prefill(params, {"tokens": prompt})
    worst_diff, worst_gap, _ = paged_vs_dense(torch, model, params, caches, served, PROMPT)
    exact = sum(a == b for a, b in zip(served[:8], ref_tokens))
    log(f"[serve] req0 first 8 tokens: server={served[:8]} generate={ref_tokens} "
        f"(equal: {exact}/8); teacher-forced paged-vs-dense max |dlogit|={worst_diff:.4f}, "
        f"worst server-token gap to dense argmax={worst_gap:.4f} (tol {logit_tol})")
    check(worst_diff <= logit_tol, f"paged vs dense logits differ by {worst_diff}")
    check(worst_gap <= logit_tol, f"server token {worst_gap} below the dense argmax")
    profile_window(torch, model, params, scfg, prompts[:SLOTS])
    return launches


def paged_vs_dense(torch, model, params, caches, served, t_prompt: int,
                   same_routing: bool = False):
    """Teacher-forced decode of the server's tokens `served[:7]` after a
    `t_prompt`-token prefill's `caches`: paged (K4) against dense (`_sdpa`).
    With `same_routing`, each paged step replays the dense step's MoE
    routing, so the two differ in the attentions' roundings only.  Returns
    the largest |dlogit|, the largest gap of a server token below the dense
    argmax, and the largest dense |logit|."""
    cfg = model.cfg
    kvh, hd = cfg.num_kv_heads, cfg.head_dim_
    with torch.inference_mode():
        dense = {k: torch.nn.functional.pad(c, (0, 0, 0, 0, 0, 8)) for k, c in caches.items()}
        n_pages = -(-(t_prompt + 8) // PAGE)
        pools = {k: torch.zeros((cfg.num_layers, 1 + n_pages, PAGE, kvh, hd),
                                dtype=cfg.adtype, device="cuda") for k in ("k", "v")}
        for k in ("k", "v"):
            c = torch.nn.functional.pad(caches[k][:, 0],
                                        (0, 0, 0, 0, 0, n_pages * PAGE - t_prompt))
            pools[k][:, 1:] = c.reshape(cfg.num_layers, n_pages, PAGE, kvh, hd)
        bt = torch.arange(1, 1 + n_pages, dtype=torch.int32, device="cuda")[None]
        worst_diff = worst_gap = scale = 0.0
        for i in range(7):
            tok = torch.tensor([[served[i]]], dtype=torch.int32, device="cuda")
            pos = t_prompt + i
            with routing() as routes:
                lg_d, dense = model.decode(params, tok, dense, pos)
            with routing(routes if same_routing else None):
                lg_p, pools = model.paged_decode(
                    params, tok, pools, bt, torch.tensor([pos], dtype=torch.int32, device="cuda"))
            # Padded vocab rows (-1e30 on both paths) are left out.
            lg_d = lg_d[0, -1, :cfg.vocab_size].float()
            lg_p = lg_p[0, -1, :cfg.vocab_size].float()
            worst_diff = max(worst_diff, (lg_d - lg_p).abs().max().item())
            worst_gap = max(worst_gap, (lg_d.max() - lg_d[served[i + 1]]).item())
            scale = max(scale, lg_d.abs().max().item())
    return worst_diff, worst_gap, scale


def profile_window(torch, model, params, scfg, prompts, tag: str = "profile",
                   new_tokens: int = NEW_TOKENS) -> None:
    """Where the serving time goes: one more run (4 requests, one wave of
    prefills then decode ticks) under torch.profiler, reporting device time
    by kernel and the device-busy share of the window's wall time.  The
    profiler's own host cost makes the busy share a lower bound."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.scheduler import ContinuousBatchingServer, Request

    server = ContinuousBatchingServer(model, params, scfg, device="cuda")
    reqs = [Request(rid=f"prof{i}", prompt=p, max_new_tokens=new_tokens)
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        server.run(reqs)
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    rows = kernel_rows(prof)
    busy_us = sum(r[0] for r in rows)
    log(f"[{tag}] {len(reqs)} requests x {new_tokens} tokens, {server.counters['ticks']} "
        f"ticks: wall={wall_us / 1e3:.1f} ms device busy={busy_us / 1e3:.1f} ms "
        f"({100 * busy_us / wall_us:.1f}% of wall; device time not seen = 'not measured')")
    for dev_us, count, key in rows[:10]:
        log(f"[{tag}]   {dev_us / 1e3:9.3f} ms {count:6d}x {key[:90]}")
    classes = {}
    for dev_us, count, key in rows:
        ms, n = classes.get(kernel_class(key), (0.0, 0))
        classes[kernel_class(key)] = (ms + dev_us / 1e3, n + count)
    log(f"[{tag}] by class: " + "; ".join(
        f"{name} {ms:.1f} ms ({n} launches)" for name, (ms, n) in
        sorted(classes.items(), key=lambda kv: -kv[1][0])))


# Profiler kernel names by class: the port's own kernels, library GEMMs
# (cuBLAS/CUTLASS), dtype and layout copies, everything else.
PORT_KERNELS = ("mesh_", "grouped_", "paged_", "flash_", "scramble_")
LIBRARY_GEMMS = ("nvjet", "gemm", "gemv", "xmma", "cutlass")


def kernel_class(key: str) -> str:
    name = key.replace("(anonymous namespace)::", "").split("(")[0]
    if any(k in name for k in PORT_KERNELS):
        return "port kernels"
    if any(k in name.lower() for k in LIBRARY_GEMMS):
        return "library GEMMs"
    if "copy" in name:
        return "copies"
    return "other"


def grads_of(torch, model, params, batch):
    """Gradients of model.loss at `params` on a host batch, in tree order."""
    from repro_torch.tree import tree_leaves, tree_map

    ps = tree_map(lambda t: t.detach().requires_grad_(True), params)
    dev = tree_leaves(ps)[0].device
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    with torch.enable_grad():
        loss, _ = model.loss(ps, batch)
        return torch.autograd.grad(loss, tree_leaves(ps))


def phase_train(torch):
    """Full-width mesh-paper training through the port's entry points."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels.mesh_matmul import mesh_matmul
    from repro_torch.kernels.scramble import scramble_blocks_cuda
    from repro_torch.launch.train import build_trainer
    from repro_torch.models import get_model
    from repro_torch.train.loop import LoopConfig, train_loop
    from repro_torch.train.metrics import MetricsLogger
    from repro_torch.tree import tree_map, tree_paths

    cfg = get_config("mesh-paper")
    check(cfg.scramble_privacy and cfg.use_mesh_kernel and TRAIN_SEQ == cfg.d_model,
          f"mesh-paper must scramble at seq {TRAIN_SEQ}: {cfg}")
    step_fn, state, data = build_trainer(
        cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=TRAIN_LR, total_steps=TRAIN_STEPS,
        seed=0, device="cuda",
    )
    tokens = TRAIN_BATCH * TRAIN_SEQ

    # One step from the same state and batch on the kernel path and on the
    # `torch` backend (bf16 cuBLAS GEMMs with f32 outputs forward, f32
    # cuBLAS GEMMs backward, TF32 off).  Every operand of mesh-paper's GEMMs, forward and backward,
    # holds bf16 values (bf16 activations and weights, bf16 cotangents, no
    # fused activation and so no f32 dz), whose products f32 holds exactly,
    # and every dA/dB is cast to bf16: the two steps differ only in
    # summation order.  So does the same torch step with TF32 on, whose
    # 10-bit mantissas hold bf16 values exactly too; it is printed as a
    # reading beside the checked pair.  Limits, an order above the readings
    # of sound runs (loss 0.00013, grad norm 0.0033 %): loss within 1e-3,
    # grad norm within 0.1 %.  The global norm barely sees a wrong gradient
    # of the right size, so each parameter's gradient is held too:
    # ||g_kernel - g_torch|| within 0.05·||g_torch||, where a sound run reads
    # up to 0.0155 (rounding differences of bf16 activations, compounded
    # over 4 layers).  The torch gradient of the next batch (the right
    # scale and structure, but wrong) read 0.89 at least, and must exceed
    # the limit.
    def with_tf32(fn):
        def run(*args):
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                return fn(*args)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
        return run

    plain_step, _, _ = build_trainer(
        dataclasses.replace(cfg, use_mesh_kernel=False), batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        lr=TRAIN_LR, total_steps=TRAIN_STEPS, seed=0, device="cuda",
    )
    stream = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                    global_batch=TRAIN_BATCH, seed=0))
    batch, next_batch = stream._host_batch(0), stream._host_batch(1)
    compare = {}
    for name, fn in (("kernel", step_fn), ("torch", plain_step),
                     ("torch TF32", with_tf32(plain_step))):
        copy = tree_map(lambda t: t.detach().clone(), state)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        _, met = fn(copy, batch)
        torch.cuda.synchronize()
        compare[name] = (float(met["loss"]), float(met["grad_norm"]), time.monotonic() - t0)
        del copy, met
    lt, gt, tt = compare["torch"]
    for name in ("kernel", "torch TF32"):
        lk, gk, tk = compare[name]
        log(f"[train] one step, {name} vs torch backend: loss {lk:.5f} vs {lt:.5f}"
            f" (|d|={abs(lk - lt):.5f}, tol 0.001), grad_norm {gk:.5f} vs {gt:.5f}"
            f" ({100 * abs(gk - gt) / gt:.4f} %, tol 0.1 %), wall {tk:.3f} s vs {tt:.3f} s")
    lk, gk, _ = compare["kernel"]
    check(abs(lk - lt) <= 1e-3, f"kernel step loss {lk} vs torch step {lt}")
    check(abs(gk - gt) <= 1e-3 * gt, f"kernel step grad norm {gk} vs torch step {gt}")

    names = [path for path, _ in tree_paths(state["params"])]
    params = state["params"]
    plain_model = get_model(dataclasses.replace(cfg, use_mesh_kernel=False))
    g_ref = grads_of(torch, plain_model, params, batch)

    def rel(grads):
        """[(||g - g_torch|| / ||g_torch||, name)] over the parameters, sorted."""
        return sorted(((x - y).float().norm().item() / max(y.float().norm().item(), 1e-30), n)
                      for n, x, y in zip(names, grads, g_ref))

    readings = {
        "kernel": rel(grads_of(torch, get_model(cfg), params, batch)),
        "torch TF32": rel(with_tf32(grads_of)(torch, plain_model, params, batch)),
        "next batch": rel(grads_of(torch, plain_model, params, next_batch)),
    }
    del g_ref
    tol = 0.05
    for name in ("kernel", "torch TF32"):
        top = ", ".join(f"{n} {r:.3e}" for r, n in reversed(readings[name][-4:]))
        log(f"[train] per-parameter gradient, {name} vs torch backend,"
            f" ||d||/||g|| largest: {top} (tol {tol})")
    (same_hi, same_at), (next_lo, next_at) = readings["kernel"][-1], readings["next batch"][0]
    log(f"[train] per-parameter gradient, the next batch's torch gradient vs this batch's,"
        f" smallest ||d||/||g||: {next_lo:.3e} ({next_at}), which must exceed tol")
    check(same_hi <= tol, f"kernel gradient of {same_at} differs from torch's by {same_hi}")
    check(next_lo > tol, f"a wrong gradient of {next_at} passes the check ({next_lo})")

    per_step = []

    def timed(st, b):
        k1, k3 = mesh_matmul.launches, scramble_blocks_cuda.launches
        t0 = time.monotonic()
        st, met = step_fn(st, b)
        torch.cuda.synchronize()
        per_step.append((time.monotonic() - t0, mesh_matmul.launches - k1,
                         scramble_blocks_cuda.launches - k3))
        return st, met

    logger = MetricsLogger()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_k1(mesh_matmul)
    scramble_blocks_cuda.launches = 0
    t0 = time.monotonic()
    state = train_loop(timed, state, data, LoopConfig(total_steps=TRAIN_STEPS, log_every=1),
                       logger=logger)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {"mesh_matmul": mesh_matmul.launches,
                "scramble_blocks": scramble_blocks_cuda.launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check_main_path_tiles("train", tile_counts(mesh_matmul), canary=False)

    losses = [h["loss"] for h in logger.history]
    for i, (h, (dt, k1, k3)) in enumerate(zip(logger.history, per_step)):
        log(f"[train] step {i + 1}: loss={h['loss']:.5f} grad_norm={h['grad_norm']:.5f}"
            f" lr={h['lr']:.3e} wall={dt * 1e3:.1f} ms tokens/s={tokens / dt:.1f}"
            f" launches K1={k1} K3={k3}")
    log(f"[train] {TRAIN_STEPS} steps x {TRAIN_BATCH}x{TRAIN_SEQ} tokens: wall={wall:.3f} s,"
        f" {TRAIN_STEPS * tokens / wall:.1f} tokens/s, peak device memory {peak_gib:.2f} GiB,"
        f" launches={launches}")
    check(len(losses) == TRAIN_STEPS and all(math.isfinite(x) for x in losses),
          f"non-finite or missing losses: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    for name, per in STEP_LAUNCHES.items():
        check(launches[name] == per * TRAIN_STEPS,
              f"{name}: {launches[name]} launches in {TRAIN_STEPS} steps, want {per} per step")
    check(all((k1, k3) == (75, 4) for _, k1, k3 in per_step), f"per-step launches {per_step}")

    profile_train_step(torch, step_fn, state, data)
    # The remat default (`dots`) against none: the same K1 launches (no
    # projection recomputed), less peak memory (the attention scores and
    # the rest of each layer are recomputed, not kept).
    del state, step_fn
    steps = policy_steps(torch, cfg, "train", ("none", "dots"), batch)
    check(steps["dots"]["k1"] == steps["none"]["k1"] == 75,
          f"K1 launches per step under none / dots: {steps['none']['k1']} / {steps['dots']['k1']}")
    check(steps["dots"]["peak_gib"] < steps["none"]["peak_gib"],
          f"dots peak {steps['dots']['peak_gib']} GiB not below none's {steps['none']['peak_gib']}")
    return launches


def policy_steps(torch, cfg, tag, policies, batch, seq=TRAIN_SEQ):
    """One step of `cfg`'s trainer under each remat policy, each from the
    same seed-0 state after one warm step on `batch`: wall ms, tokens/s,
    peak device memory (the train state included), and the K1 and K5
    launches of the step."""
    import dataclasses
    import gc

    from repro_torch.kernels.grouped import grouped_mesh_matmul
    from repro_torch.kernels.mesh_matmul import mesh_matmul
    from repro_torch.launch.train import build_trainer

    out = {}
    for policy in policies:
        gc.collect()
        torch.cuda.empty_cache()
        step_fn, state, _ = build_trainer(
            dataclasses.replace(cfg, remat_policy=policy), batch=TRAIN_BATCH, seq=seq,
            lr=TRAIN_LR, total_steps=TRAIN_STEPS, seed=0, device="cuda")
        state, _ = step_fn(state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k1, k5 = mesh_matmul.launches, grouped_mesh_matmul.launches
        t0 = time.monotonic()
        state, met = step_fn(state, batch)
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        out[policy] = dict(ms=dt * 1e3, tokens_s=TRAIN_BATCH * seq / dt,
                           peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                           k1=mesh_matmul.launches - k1, k5=grouped_mesh_matmul.launches - k5,
                           loss=float(met["loss"]))
        log(f"[{tag}] remat_policy={policy}: one step {out[policy]['ms']:.1f} ms,"
            f" {out[policy]['tokens_s']:.1f} tokens/s, peak device memory"
            f" {out[policy]['peak_gib']:.2f} GiB, launches K1={out[policy]['k1']}"
            f" K5={out[policy]['k5']}")
        del step_fn, state, met
    gc.collect()
    torch.cuda.empty_cache()
    return out


def profile_train_step(torch, step_fn, state, data, tag: str = "profile train") -> None:
    """Where a training step's time goes: one more step under torch.profiler,
    device time by kernel and the device-busy share of its wall time."""
    from torch.profiler import ProfilerActivity, profile

    batch = next(data)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        step_fn(state, batch)
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    rows = kernel_rows(prof)
    busy_us = sum(r[0] for r in rows)
    log(f"[{tag}] one step: wall={wall_us / 1e3:.1f} ms device busy="
        f"{busy_us / 1e3:.1f} ms ({100 * busy_us / wall_us:.1f}% of wall)")
    for dev_us, count, key in rows[:10]:
        log(f"[{tag}]   {dev_us / 1e3:9.3f} ms {count:6d}x"
            f" {100 * dev_us / busy_us:5.1f}% {key[:80]}")


def phase_serve_moe(torch):
    """Full-width OLMoE-1B-7B on the kernel path through the
    continuous-batching server."""
    import dataclasses
    import gc

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.grouped import grouped_mesh_matmul
    from repro_torch.kernels.mesh_matmul import mesh_matmul
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    from repro_torch.launch.scheduler import ContinuousBatchingServer, Request, ServeConfig
    from repro_torch.launch.serve import generate, serving_steps
    from repro_torch.models import get_model
    from repro_torch.tree import tree_leaves

    cfg = dataclasses.replace(get_config("olmoe-1b-7b"), use_mesh_kernel=True)
    check(
        (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_experts, cfg.num_experts_per_tok,
         cfg.moe_d_ff, cfg.vocab_size, cfg.num_shared_experts)
        == (OLMOE_LAYERS, 2048, 16, OLMOE_EXPERTS, OLMOE_TOPK, 1024, 50304, 0)
        and cfg.param_dtype == "bfloat16",
        f"unexpected OLMoE config {cfg}",
    )
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log(f"[serve_moe] device memory before init: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    model = get_model(cfg)
    t0 = time.monotonic()
    params = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"[serve_moe] OLMoE-1B-7B init: {n_params / 1e9:.3f} B parameters,"
        f" {torch.cuda.memory_allocated() / 2**30:.2f} GiB, peak"
        f" {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, {time.monotonic() - t0:.1f} s")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, PROMPT).astype(np.int32) for _ in range(REQUESTS)]
    pages = -(-(PROMPT + NEW_TOKENS) // PAGE)
    scfg = ServeConfig(
        max_slots=SLOTS, page_size=PAGE, num_pages=1 + SLOTS * pages,
        max_pages_per_seq=pages, queue_capacity=REQUESTS, warmup_prompt_lens=(PROMPT,),
    )

    reset_k1(mesh_matmul)
    paged_attention_cuda.launches = 0
    grouped_mesh_matmul.launches = 0
    grouped_mesh_matmul.launches_by_config = {}
    server = ContinuousBatchingServer(model, params, scfg, device="cuda")
    server.warmup()
    reqs = [Request(rid=f"req{i}", prompt=p, max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    results = server.run(reqs)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {"mesh_matmul": mesh_matmul.launches,
                "paged_attention": paged_attention_cuda.launches,
                "grouped_mesh_matmul": grouped_mesh_matmul.launches}
    check_main_path_tiles("serve_moe", tile_counts(mesh_matmul), canary=True)
    k5_tiles = dict(grouped_mesh_matmul.launches_by_config)
    K5_TILES["serve_moe"] = k5_tiles
    log(f"[serve_moe] K5 launches per tile: {k5_tiles}")
    check(all(c.startswith("tc") for c in k5_tiles),
          f"a main-path K5 call took a SIMT tile: {k5_tiles}")

    for r in reqs:
        res = results[r.rid]
        check(res.status == "ok" and len(res.tokens) == NEW_TOKENS,
              f"{r.rid}: {res.status} with {len(res.tokens)} tokens ({res.reason})")
    check(all(v > 0 for v in launches.values()), f"a kernel never launched: {launches}")
    c = server.counters
    steps = c["prefills"] + c["decode_steps"]
    want = {"grouped_mesh_matmul": MOE_STEP_LAUNCHES["grouped_mesh_matmul"] * steps,
            "mesh_matmul": MOE_STEP_LAUNCHES["mesh_matmul"] * steps + 2,
            "paged_attention": OLMOE_LAYERS * c["decode_steps"]}
    generated = sum(len(results[r.rid].tokens) for r in reqs)
    log(f"[serve_moe] {REQUESTS} requests x {NEW_TOKENS} tokens: wall={wall:.3f} s "
        f"tokens/s={generated / wall:.1f} ticks={c['ticks']} prefills={c['prefills']} "
        f"decode steps={c['decode_steps']} (warmup included) launches={launches} "
        f"expected={want} peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(launches == want, f"launches {launches} != {want} from the server's counters")

    # No host sync on the model's path: one paged decode step (all-zero
    # tables, the scratch page) and one prefill under CUDA's sync debug
    # mode, which warns on every op that waits for the device.
    import warnings

    prefill, _ = serving_steps(model)
    zeros = {name: torch.zeros(shape, dtype=torch.int32, device="cuda")
             for name, shape in (("tokens", (SLOTS, 1)), ("tables", (SLOTS, pages)),
                                 ("positions", (SLOTS,)))}
    prompt = torch.as_tensor(prompts[0], device="cuda")[None]
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught, torch.inference_mode():
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            model.paged_decode(params, zeros["tokens"], server.pools, zeros["tables"],
                               zeros["positions"])
            prefill(params, {"tokens": prompt})
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # Every warning counts (c10 warns "called a synchronizing CUDA
    # operation") except the mode's own notice that it is a prototype.
    syncs = [str(w.message).splitlines()[0] for w in caught
             if "is a prototype feature" not in str(w.message)]
    log(f"[serve_moe] host syncs in one paged decode step and one prefill: {len(syncs)}"
        f" {syncs[:3]} ({len(caught)} warnings caught)")
    check(not syncs, f"the OLMoE serving path waits for the device: {syncs[:3]}")

    # Output check against the dense-cache path (plain _sdpa attention), as
    # in phase_serve.  Routing is discrete: where the two attention paths
    # round differently, a near-tie can flip one of a token's 8 experts, so
    # the routing sets of the tracked token are compared layer by layer.
    served = results["req0"].tokens
    ref_tokens, _ = generate(model, params, torch.as_tensor(prompts[0], device="cuda")[None],
                             gen_len=8)
    ref_tokens = ref_tokens[0].tolist()
    check(served[0] == ref_tokens[0], f"first token {served[0]} != generate's {ref_tokens[0]}")
    with torch.inference_mode():
        _, caches = prefill(params, {"tokens": prompt})
    with routing() as routes:
        worst_diff, worst_gap, scale = paged_vs_dense(torch, model, params, caches, served,
                                                      PROMPT)
    del caches
    flips = routing_flips(torch, routes, cfg.num_layers)
    exact = sum(a == b for a, b in zip(served[:8], ref_tokens))
    log(f"[serve_moe] req0 first 8 tokens: server={served[:8]} generate={ref_tokens} "
        f"(equal: {exact}/8); teacher-forced paged-vs-dense max |dlogit|={worst_diff:.4f} "
        f"(max |logit| {scale:.3f}), worst server-token gap to dense argmax={worst_gap:.4f} "
        f"(tol {MOE_LOGIT_TOL}); (step, layer) routing sets that differ: {flips} of "
        f"{cfg.num_layers} per step")
    check(worst_diff <= MOE_LOGIT_TOL, f"paged vs dense logits differ by {worst_diff}")
    check(worst_gap <= MOE_LOGIT_TOL, f"server token {worst_gap} below the dense argmax")
    profile_window(torch, model, params, scfg, prompts[:SLOTS], tag="profile serve_moe")
    return launches


def phase_serve_qwen2(torch):
    """Full-width Qwen2-7B with a chunked prefill (K6) through the
    continuous-batching server; decode on K4 at GQA rep 7."""
    import dataclasses
    import gc

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    from repro_torch.launch.scheduler import ContinuousBatchingServer, Request, ServeConfig
    from repro_torch.launch.serve import generate
    from repro_torch.models import get_model
    from repro_torch.tree import tree_leaves, tree_map

    base = get_config("qwen2-7b")
    cfg = dataclasses.replace(base, attn_chunk=QWEN_CHUNK)
    h, kvh, hd = QWEN_HEADS
    check(
        (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_, cfg.d_ff,
         cfg.vocab_size, cfg.qkv_bias, cfg.rope_theta, cfg.use_mesh_kernel)
        == (QWEN_LAYERS, 3584, h, kvh, hd, 18944, 152064, True, 1e6, False)
        and cfg.param_dtype == "bfloat16",
        f"unexpected Qwen2-7B config {cfg}",
    )
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log(f"[serve_qwen2] device memory before init: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    model = get_model(cfg)
    t0 = time.monotonic()
    params = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"[serve_qwen2] Qwen2-7B init: {n_params / 1e9:.3f} B parameters,"
        f" {torch.cuda.memory_allocated() / 2**30:.2f} GiB, peak"
        f" {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, {time.monotonic() - t0:.1f} s")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, t).astype(np.int32) for t in QWEN_PROMPTS]
    pages = [-(-(t + QWEN_NEW_TOKENS) // PAGE) for t in QWEN_PROMPTS]
    scfg = ServeConfig(
        max_slots=SLOTS, page_size=PAGE, num_pages=1 + sum(pages), max_pages_per_seq=max(pages),
        queue_capacity=len(prompts), warmup_prompt_lens=(QWEN_PROMPTS[0],),
    )

    flash_attention.launches = 0
    paged_attention_cuda.launches = 0
    server = ContinuousBatchingServer(model, params, scfg, device="cuda")
    server.warmup()
    reqs = [Request(rid=f"req{i}", prompt=p, max_new_tokens=QWEN_NEW_TOKENS)
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    results = server.run(reqs)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {"flash_attention": flash_attention.launches,
                "paged_attention": paged_attention_cuda.launches}

    for r in reqs:
        res = results[r.rid]
        check(res.status == "ok" and len(res.tokens) == QWEN_NEW_TOKENS,
              f"{r.rid}: {res.status} with {len(res.tokens)} tokens ({res.reason})")
    c = server.counters
    # Every prefill (the warmup's too) is a multiple of the chunk and longer
    # than one, so each takes the flash path: one K6 launch per layer.
    chunked = sum(1 for t in (*scfg.warmup_prompt_lens, *QWEN_PROMPTS)
                  if t > QWEN_CHUNK and t % QWEN_CHUNK == 0)
    check(chunked == c["prefills"], f"{c['prefills']} prefills, {chunked} chunked lengths")
    want = {"flash_attention": QWEN_LAYERS * chunked,
            "paged_attention": QWEN_LAYERS * c["decode_steps"]}
    generated = sum(len(results[r.rid].tokens) for r in reqs)
    log(f"[serve_qwen2] {len(reqs)} requests (prompts {list(QWEN_PROMPTS)}) x {QWEN_NEW_TOKENS}"
        f" tokens: wall={wall:.3f} s tokens/s={generated / wall:.1f} ticks={c['ticks']}"
        f" prefills={c['prefills']} decode steps={c['decode_steps']} (warmup included)"
        f" launches={launches} expected={want} peak device memory"
        f" {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(launches == want, f"launches {launches} != {want} from the server's counters")

    # Prefill logits of the first prompt three ways on the same weights: K6
    # (attn_chunk=1024), its plain version on the same chunked path, and
    # attn_chunk=0 (plain `_sdpa`).  K6 vs the plain chunked path is the
    # kernel's end-to-end check; plain chunked vs `_sdpa` shows what the
    # chunked formulation alone moves.
    plain_model = get_model(base)
    prompt = torch.as_tensor(prompts[0], device="cuda")[None]
    with torch.inference_mode():
        before = flash_attention.launches
        lg_k6, caches = model.prefill(params, {"tokens": prompt})
        k6_calls = flash_attention.launches - before
        with plain_flash():
            lg_chunked = model.prefill(params, {"tokens": prompt})[0]
        lg_full, _ = plain_model.prefill(params, {"tokens": prompt})
        check(flash_attention.launches - before == k6_calls == QWEN_LAYERS,
              f"K6 prefill launched {k6_calls}, the plain ones {flash_attention.launches - before}")
        check(bool(torch.isfinite(lg_k6.float()).all()), "non-finite K6 prefill logits")
        pairs = logit_gaps(torch, lg_k6, lg_chunked, lg_full)
        del lg_chunked, lg_full
    prefill_scale = pairs.pop("scale")
    log(f"[serve_qwen2] bf16 prefill logits, T={QWEN_PROMPTS[0]} (max |logit| {prefill_scale:.3f}):"
        + "".join(f" {name}: max |d|={d:.4f}, argmax equal at {100 * same:.2f} %;"
                  for name, (d, same) in pairs.items())
        + f" tol K6 vs chunked {QWEN_K6_CHUNKED_TOL}, K6 vs _sdpa {QWEN_PREFILL_TOL}")
    check(pairs["K6 vs chunked"][0] <= QWEN_K6_CHUNKED_TOL,
          f"K6 vs plain chunked prefill logits differ by {pairs['K6 vs chunked'][0]}")
    check(pairs["K6 vs _sdpa"][0] <= QWEN_PREFILL_TOL,
          f"K6 vs _sdpa prefill logits differ by {pairs['K6 vs _sdpa'][0]}")

    # First token against generate() (the same K6 prefill, dense decode),
    # then teacher-forced paged decode (K4, rep 7) against dense (`_sdpa`).
    served = results["req0"].tokens
    ref_tokens, _ = generate(model, params, prompt, gen_len=8)
    ref_tokens = ref_tokens[0].tolist()
    check(served[0] == ref_tokens[0], f"first token {served[0]} != generate's {ref_tokens[0]}")
    del lg_k6
    worst_diff, worst_gap, scale = paged_vs_dense(torch, model, params, caches, served,
                                                  QWEN_PROMPTS[0])
    exact = sum(a == b for a, b in zip(served[:8], ref_tokens))
    log(f"[serve_qwen2] req0 first 8 tokens: server={served[:8]} generate={ref_tokens} "
        f"(equal: {exact}/8); teacher-forced paged-vs-dense max |dlogit|={worst_diff:.4f} "
        f"(max |logit| {scale:.3f}), worst server-token gap to dense argmax={worst_gap:.4f} "
        f"(tol {QWEN_LOGIT_TOL})")
    check(worst_diff <= QWEN_LOGIT_TOL, f"paged vs dense logits differ by {worst_diff}")
    check(worst_gap <= QWEN_LOGIT_TOL, f"server token {worst_gap} below the dense argmax")
    del caches, server
    profile_window(torch, model, params, scfg, prompts, tag="profile serve_qwen2",
                   new_tokens=QWEN_NEW_TOKENS)

    # The same three prefills with f32 weights and activations, where K6 and
    # its plain version differ in summation order only: the tight check.
    cfg32 = dataclasses.replace(cfg, param_dtype="float32", activation_dtype="float32")
    params = tree_map(lambda t: t.float(), params)
    gc.collect()
    torch.cuda.empty_cache()
    model32 = get_model(cfg32)
    with torch.inference_mode():
        before = flash_attention.launches
        lg_k6 = model32.prefill(params, {"tokens": prompt})[0]
        check(flash_attention.launches - before == QWEN_LAYERS, "f32 prefill skipped K6")
        with plain_flash():
            lg_chunked = model32.prefill(params, {"tokens": prompt})[0]
        lg_full = get_model(dataclasses.replace(cfg32, attn_chunk=0)).prefill(
            params, {"tokens": prompt})[0]
        pairs = logit_gaps(torch, lg_k6, lg_chunked, lg_full)
    scale = pairs.pop("scale")
    log(f"[serve_qwen2] f32 prefill logits, T={QWEN_PROMPTS[0]} (max |logit| {scale:.3f}):"
        + "".join(f" {name}: max |d|={d:.3e}, argmax equal at {100 * same:.2f} %;"
                  for name, (d, same) in pairs.items())
        + f" tol K6 vs chunked {QWEN_F32_TOL}")
    check(pairs["K6 vs chunked"][0] <= QWEN_F32_TOL,
          f"f32 K6 vs plain chunked prefill logits differ by {pairs['K6 vs chunked'][0]}")
    return launches


@contextlib.contextmanager
def plain_flash():
    """Within the block, the model's chunked attention calls K6's plain
    version (`flash_attention_torch`, torch ops on the card) instead of the
    kernel: the witness K6's end-to-end logits are held against."""
    from repro_torch.kernels.flash_attention import flash_attention_torch
    from repro_torch.models import attention

    kernel = attention.flash_attention
    attention.flash_attention = flash_attention_torch
    try:
        yield
    finally:
        attention.flash_attention = kernel


def logit_gaps(torch, k6, chunked, full):
    """{pair: (max |d|, share of positions with equal argmax)} of three
    prefills' logits, and the largest |logit| of the plain `_sdpa` one."""
    out = {"scale": full.float().abs().max().item()}
    for name, x, y in (("K6 vs chunked", k6, chunked), ("chunked vs _sdpa", chunked, full),
                       ("K6 vs _sdpa", k6, full)):
        out[name] = ((x.float() - y.float()).abs().max().item(),
                     (x.argmax(-1) == y.argmax(-1)).float().mean().item())
    return out


def phase_train_flash(torch):
    """One full-width mesh-paper training step at 2 x 2048 tokens with
    attn_chunk=1024 (K6 forward, run again by the `dots` recompute; the
    chunked backward recomputed in plain ops) against the same step with
    full attention (attn_chunk=0)."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.train import build_trainer
    from repro_torch.models import get_model
    from repro_torch.tree import tree_map, tree_paths

    gc.collect()
    torch.cuda.empty_cache()
    base = get_config("mesh-paper")
    cfg = dataclasses.replace(base, attn_chunk=QWEN_CHUNK)
    kw = dict(batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=TRAIN_LR, total_steps=TRAIN_STEPS, seed=0,
              device="cuda")
    step_flash, state, _ = build_trainer(cfg, **kw)
    step_full, _, _ = build_trainer(base, **kw)
    stream = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                    global_batch=TRAIN_BATCH, seed=0))
    batch = stream._host_batch(0)
    compare = {}
    for name, fn in (("full", step_full), ("flash", step_flash)):
        copy = tree_map(lambda t: t.detach().clone(), state)
        torch.cuda.synchronize()
        flash_attention.launches = 0
        t0 = time.monotonic()
        _, met = fn(copy, batch)
        torch.cuda.synchronize()
        compare[name] = (float(met["loss"]), float(met["grad_norm"]), time.monotonic() - t0,
                         flash_attention.launches)
        del copy, met
    (lf, gf, tf, kf), (lk, gk, tk, launches) = compare["full"], compare["flash"]
    # K6 runs once a layer forward, and again where the remat policy
    # recomputes attention in the backward (`dots` and `full` do).
    want = base.num_layers * (1 if cfg.remat_policy == "none" else 2)
    log(f"[train_flash] one step, attn_chunk={QWEN_CHUNK} vs 0: loss {lk:.5f} vs {lf:.5f}"
        f" (|d|={abs(lk - lf):.5f}, tol 0.001), grad_norm {gk:.5f} vs {gf:.5f}"
        f" ({100 * abs(gk - gf) / gf:.4f} %, tol 0.1 %), wall {tk:.3f} s vs {tf:.3f} s,"
        f" K6 launches {launches} vs {kf} (want {want} vs 0)")
    check(launches == want and kf == 0,
          f"K6 launched {launches} times in the flash step and {kf} in the full one")
    check(abs(lk - lf) <= 1e-3, f"flash step loss {lk} vs full step {lf}")
    check(abs(gk - gf) <= 1e-3 * gf, f"flash step grad norm {gk} vs full step {gf}")

    # Each parameter's gradient, as in phase_train: within 0.05 relative.
    names = [path for path, _ in tree_paths(state["params"])]
    g_full = grads_of(torch, get_model(base), state["params"], batch)
    g_flash = grads_of(torch, get_model(cfg), state["params"], batch)
    rel = sorted(((x - y).float().norm().item() / max(y.float().norm().item(), 1e-30), n)
                 for n, x, y in zip(names, g_flash, g_full))
    top = ", ".join(f"{n} {r:.3e}" for r, n in reversed(rel[-4:]))
    log(f"[train_flash] per-parameter gradient, flash vs full attention, ||d||/||g|| largest:"
        f" {top} (tol 0.05)")
    check(all(x is not None and bool(torch.isfinite(x.float()).all()) for x in g_flash),
          "flash gradients missing or non-finite")
    check(rel[-1][0] <= 0.05, f"flash gradient of {rel[-1][1]} differs by {rel[-1][0]}")
    return {"flash_attention": launches}


def _free(torch):
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def no_host_sync(torch, fn):
    """Run `fn` with CUDA's sync debug mode set to raise: any op that waits
    for the device fails it."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


@contextlib.contextmanager
def routing(replay=None):
    """Within the block, every MoE routing decision (`moe._top_k`, the
    (n, k) expert indices) is appended to the yielded list; with `replay`,
    the i-th decision is replay[i] instead of the router's own."""
    from repro_torch.models import moe

    original = moe._top_k
    seen = []

    def hooked(probs, k):
        top = original(probs, k) if replay is None else replay[len(seen)]
        seen.append(top)
        return top

    moe._top_k = hooked
    try:
        yield seen
    finally:
        moe._top_k = original


def routing_flips(torch, routes, layers):
    """Per teacher-forced step of `paged_vs_dense` (the dense decode's
    routing decisions of every layer, then the paged decode's): how many
    layers routed the token to another expert set."""
    per = [routes[i:i + 2 * layers] for i in range(0, len(routes), 2 * layers)]
    return [sum(not torch.equal(a.sort(-1).values, b.sort(-1).values)
                for a, b in zip(st[:layers], st[layers:])) for st in per]


def phase_serve_qwen2_moe(torch):
    """Full-width Qwen1.5-MoE-A2.7B (shared experts) on the kernel path
    through the continuous-batching server."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.grouped import grouped_mesh_matmul
    from repro_torch.kernels.mesh_matmul import mesh_matmul
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    from repro_torch.launch.scheduler import ContinuousBatchingServer, Request, ServeConfig
    from repro_torch.launch.serve import generate, serving_steps
    from repro_torch.models import get_model
    from repro_torch.tree import tree_leaves, tree_map

    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b"), use_mesh_kernel=True)
    check(
        (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_,
         cfg.num_experts, cfg.num_experts_per_tok, cfg.moe_d_ff, cfg.num_shared_experts,
         cfg.vocab_size, cfg.qkv_bias, cfg.rope_theta)
        == (QMOE_LAYERS, 2048, 16, 16, 128, QMOE_EXPERTS, QMOE_TOPK, 1408, 4, 151936, True, 1e6)
        and cfg.param_dtype == "bfloat16",
        f"unexpected Qwen1.5-MoE config {cfg}",
    )
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    log(f"[serve_qwen2_moe] device memory before init: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    model = get_model(cfg)
    t0 = time.monotonic()
    params = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"[serve_qwen2_moe] Qwen1.5-MoE-A2.7B init: {n_params / 1e9:.3f} B parameters (from"
        f" the tree; n_params_dense_blocks() says {cfg.n_params_dense_blocks() / 1e9:.3f} B),"
        f" {torch.cuda.memory_allocated() / 2**30:.2f} GiB, init peak"
        f" {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, {time.monotonic() - t0:.1f} s")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, PROMPT).astype(np.int32) for _ in range(REQUESTS)]
    pages = -(-(PROMPT + NEW_TOKENS) // PAGE)
    scfg = ServeConfig(
        max_slots=SLOTS, page_size=PAGE, num_pages=1 + SLOTS * pages,
        max_pages_per_seq=pages, queue_capacity=REQUESTS, warmup_prompt_lens=(PROMPT,),
    )

    torch.cuda.reset_peak_memory_stats()
    reset_k1(mesh_matmul)
    paged_attention_cuda.launches = 0
    grouped_mesh_matmul.launches = 0
    grouped_mesh_matmul.launches_by_config = {}
    server = ContinuousBatchingServer(model, params, scfg, device="cuda")
    server.warmup()
    reqs = [Request(rid=f"req{i}", prompt=p, max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    results = server.run(reqs)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {"mesh_matmul": mesh_matmul.launches,
                "paged_attention": paged_attention_cuda.launches,
                "grouped_mesh_matmul": grouped_mesh_matmul.launches}
    check_main_path_tiles("serve_qwen2_moe", tile_counts(mesh_matmul), canary=True)
    k5_tiles = dict(grouped_mesh_matmul.launches_by_config)
    K5_TILES["serve_qwen2_moe"] = k5_tiles
    log(f"[serve_qwen2_moe] K5 launches per tile: {k5_tiles}")
    check(all(c.startswith("tc") for c in k5_tiles),
          f"a main-path K5 call took a SIMT tile: {k5_tiles}")
    for r in reqs:
        res = results[r.rid]
        check(res.status == "ok" and len(res.tokens) == NEW_TOKENS,
              f"{r.rid}: {res.status} with {len(res.tokens)} tokens ({res.reason})")
    c = server.counters
    steps = c["prefills"] + c["decode_steps"]
    want = {"grouped_mesh_matmul": QMOE_STEP_LAUNCHES["grouped_mesh_matmul"] * steps,
            "mesh_matmul": QMOE_STEP_LAUNCHES["mesh_matmul"] * steps + 2,
            "paged_attention": QMOE_LAYERS * c["decode_steps"]}
    generated = sum(len(results[r.rid].tokens) for r in reqs)
    log(f"[serve_qwen2_moe] {REQUESTS} requests x {NEW_TOKENS} tokens: wall={wall:.3f} s "
        f"tokens/s={generated / wall:.1f} ticks={c['ticks']} prefills={c['prefills']} "
        f"decode steps={c['decode_steps']} (warmup included) launches={launches} "
        f"expected={want} peak device memory while serving "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(launches == want, f"launches {launches} != {want} from the server's counters")

    # No host sync on the model's path: one paged decode step (all-zero
    # tables, the scratch page) and one prefill under the sync debug mode.
    prefill, _ = serving_steps(model)
    zeros = {name: torch.zeros(shape, dtype=torch.int32, device="cuda")
             for name, shape in (("tokens", (SLOTS, 1)), ("tables", (SLOTS, pages)),
                                 ("positions", (SLOTS,)))}
    prompt = torch.as_tensor(prompts[0], device="cuda")[None]

    def one_step_and_prefill():
        with torch.inference_mode():
            model.paged_decode(params, zeros["tokens"], server.pools, zeros["tables"],
                               zeros["positions"])
            prefill(params, {"tokens": prompt})

    no_host_sync(torch, one_step_and_prefill)
    log("[serve_qwen2_moe] one paged decode step and one prefill ran under"
        " set_sync_debug_mode('error'): 0 host syncs")

    # Output: first token against generate(), then teacher-forced paged (K4)
    # against dense (`_sdpa`) decode logits, as in phase_serve_moe.
    served = results["req0"].tokens
    ref_tokens, _ = generate(model, params, prompt, gen_len=8)
    ref_tokens = ref_tokens[0].tolist()
    check(served[0] == ref_tokens[0], f"first token {served[0]} != generate's {ref_tokens[0]}")
    exact = sum(a == b for a, b in zip(served[:8], ref_tokens))
    log(f"[serve_qwen2_moe] req0 first 8 tokens: server={served[:8]} generate={ref_tokens} "
        f"(equal: {exact}/8)")
    # Teacher-forced paged vs dense decode logits of the first QMOE_CHECKED
    # requests, free-running (each path routes for itself, so a routing set
    # flipped by the attentions' roundings moves the logits) and on the
    # dense step's routing (the attentions' roundings only).
    worst = {"free": 0.0, "gap": 0.0, "same": 0.0}
    for i in range(QMOE_CHECKED):
        tokens_i = results[f"req{i}"].tokens
        with torch.inference_mode():
            prompt_i = torch.as_tensor(prompts[i], device="cuda")[None]
            _, caches = prefill(params, {"tokens": prompt_i})
        with routing() as routes:
            free, gap, scale = paged_vs_dense(torch, model, params, caches, tokens_i, PROMPT)
        flips = routing_flips(torch, routes, QMOE_LAYERS)
        same, _, _ = paged_vs_dense(torch, model, params, caches, tokens_i, PROMPT,
                                    same_routing=True)
        del caches
        worst = {"free": max(worst["free"], free), "gap": max(worst["gap"], gap),
                 "same": max(worst["same"], same)}
        log(f"[serve_qwen2_moe] req{i} teacher-forced paged-vs-dense max |dlogit|: free-running"
            f" {free:.4f} (tol {QMOE_LOGIT_TOL}; (step, layer) routing sets that differ: {flips}"
            f" of {QMOE_LAYERS} per step), on the dense routing {same:.4f} (tol"
            f" {QMOE_SAME_ROUTING_TOL}); max |logit| {scale:.3f}, so {free / scale:.4f} and"
            f" {same / scale:.4f} of it; worst server-token gap to the dense argmax {gap:.4f}"
            f" (tol {QMOE_LOGIT_TOL})")
    check(worst["free"] <= QMOE_LOGIT_TOL, f"paged vs dense logits differ by {worst['free']}")
    check(worst["gap"] <= QMOE_LOGIT_TOL, f"server token {worst['gap']} below the dense argmax")
    check(worst["same"] <= QMOE_SAME_ROUTING_TOL,
          f"paged vs dense logits on the same routing differ by {worst['same']}")
    del server
    _free(torch)
    profile_window(torch, model, params, scfg, prompts[:SLOTS], tag="profile serve_qwen2_moe")
    k5_step = qmoe_k5_decode_step(torch, params)

    # The tight witness: 2 of 24 layers at full width with f32 weights, the
    # kernel path's prefill logits (K1 f32 tiles, K5 f32 SIMT tiles) against
    # the `torch` backend's (f32 cuBLAS, TF32 off): summation order only.
    cut = {k: v for k, v in params.items() if k != "blocks"}
    cut["blocks"] = tree_map(lambda t: t[:2], params["blocks"])
    params32 = tree_map(lambda t: t.float(), cut)
    del params, cut
    _free(torch)
    cfg32 = dataclasses.replace(cfg, num_layers=2, param_dtype="float32",
                                activation_dtype="float32")
    with torch.inference_mode():
        lg_kernel = get_model(cfg32).prefill(params32, {"tokens": prompt})[0]
        lg_torch = get_model(dataclasses.replace(cfg32, use_mesh_kernel=False)).prefill(
            params32, {"tokens": prompt})[0]
    diff = (lg_kernel - lg_torch).abs().max().item()
    log(f"[serve_qwen2_moe] f32 weights, 2 layers: kernel-path prefill logits vs the torch"
        f" backend's, T={PROMPT}: max |d|={diff:.3e} (max |logit|"
        f" {lg_torch.abs().max().item():.3f}, argmax equal at"
        f" {100 * (lg_kernel.argmax(-1) == lg_torch.argmax(-1)).float().mean().item():.2f} %;"
        f" tol {QMOE_F32_TOL})")
    check(diff <= QMOE_F32_TOL, f"f32 kernel-path prefill logits differ by {diff}")
    # The same 2 f32 layers decoding req0's tokens: paged (K4, K1, K5) vs
    # dense on the dense step's routing, summation order only.
    with torch.inference_mode():
        _, caches32 = get_model(cfg32).prefill(params32, {"tokens": prompt})
    diff32, _, scale32 = paged_vs_dense(torch, get_model(cfg32), params32, caches32, served,
                                        PROMPT, same_routing=True)
    log(f"[serve_qwen2_moe] f32 weights, 2 layers: teacher-forced paged-vs-dense decode"
        f" logits on the same routing: max |d|={diff32:.3e} (max |logit| {scale32:.3f};"
        f" tol {QMOE_F32_DECODE_TOL})")
    check(diff32 <= QMOE_F32_DECODE_TOL, f"f32 paged vs dense decode logits differ by {diff32}")
    del params32, lg_kernel, lg_torch, caches32
    _free(torch)
    return {**launches, "k5_decode_step": k5_step}


def qmoe_k5_decode_step(torch, params):
    """K5's device time for one Qwen1.5-MoE decode step (48 launches: wi and
    wo of 24 layers, SLOTS tokens routed top-4 of 60 with no preference,
    `_routed_sizes`) against the bound: the weight bytes of the experts the
    step hits, read once, and its rows read and written once."""
    import numpy as np

    from repro_torch.kernels.grouped import grouped_mesh_matmul

    rng = np.random.default_rng(7)
    rpg = 8  # SLOTS tokens: cap = n, rounded up to 8 rows
    moe = params["blocks"]["moe"]
    calls, nbytes = [], 0.0
    for layer in range(QMOE_LAYERS):
        sizes_np = _routed_sizes(rng, SLOTS, QMOE_EXPERTS, QMOE_TOPK)
        sizes = torch.as_tensor(sizes_np, device="cuda")
        hit = int((sizes_np > 0).sum())
        for name in ("wi", "wo"):
            w = moe[name][layer]
            k, n = w.shape[-2:]
            x = torch.randn(QMOE_EXPERTS * rpg, k, device="cuda").to(w.dtype)
            calls.append(lambda x=x, s=sizes, w=w: grouped_mesh_matmul(x, s, w, block_m=rpg))
            nbytes += 2 * (hit * k * n + int(sizes_np.sum()) * (k + n))
    ms = device_ms(torch, [lambda: [c() for c in calls]], 5)
    bms, by = bound_ms(nbytes, 0.0, "bfloat16")
    log(f"[serve_qwen2_moe] K5, one decode step (48 launches, {SLOTS} tokens top-{QMOE_TOPK}"
        f" of {QMOE_EXPERTS}): device {ms:.3f} ms, bound {bms:.3f} ms ({by}:"
        f" {nbytes / 1e9:.3f} GB of hit experts' weights and rows)")
    return dict(ms=ms, bound_ms=bms, bound_by=by)


def phase_train_moe(torch):
    """OLMoE-1B-7B at full width and 4 of its 16 layers on the kernel path:
    the capacity path, the remat policies and the asynchronous checkpoint
    writer, through `build_trainer` and `train_loop`."""
    import dataclasses
    import tempfile

    from repro_torch.checkpoint import AsyncCheckpointer, CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels.grouped import grouped_mesh_matmul
    from repro_torch.kernels.mesh_matmul import mesh_matmul
    from repro_torch.launch.train import build_trainer
    from repro_torch.models import get_model, moe
    from repro_torch.train.loop import LoopConfig, train_loop
    from repro_torch.train.metrics import MetricsLogger
    from repro_torch.tree import tree_leaves, tree_map, tree_paths

    _free(torch)
    full = get_config("olmoe-1b-7b")
    cfg = dataclasses.replace(full, num_layers=MOE_TRAIN_LAYERS, use_mesh_kernel=True)
    check(cfg.remat_policy == "dots" and (cfg.d_model, cfg.num_experts, cfg.moe_d_ff)
          == (2048, OLMOE_EXPERTS, 1024), f"unexpected OLMoE config {cfg}")
    kw = dict(batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=TRAIN_LR, total_steps=TRAIN_STEPS, seed=0,
              device="cuda")
    step_fn, state, data = build_trainer(cfg, **kw)
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    state_gib = sum(t.numel() * t.element_size() for t in tree_leaves(state)) / 2**30
    tokens = TRAIN_BATCH * TRAIN_SEQ
    cap = moe._capacity(tokens, TRAIN_SEQ, cfg.num_experts, cfg.num_experts_per_tok, 1.25)
    log(f"[train_moe] OLMoE-1B-7B, {cfg.num_layers} of {full.num_layers} layers at full width:"
        f" {n_params / 1e9:.3f} B parameters, train state {state_gib:.2f} GiB; {tokens} tokens"
        f" a step, capacity {cap} rows per expert ({cfg.num_experts * cap} rows)")
    check(cap == MOE_TRAIN_CAP and cap < tokens,
          f"capacity {cap}: the capacity path must be live")

    # One step from the same state and batch on the kernel path and on the
    # `torch` backend, with [train]'s limits; the routing of both forwards
    # recorded, and the pairs each drops.
    plain_cfg = dataclasses.replace(cfg, use_mesh_kernel=False)
    stream = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                    global_batch=TRAIN_BATCH, seed=0))
    batch = stream._host_batch(0)
    names = [path for path, _ in tree_paths(state["params"])]
    routes = {}
    grads = {}
    for name, c, replay in (("kernel", cfg, None), ("torch", plain_cfg, None),
                            ("torch, kernel's routing", plain_cfg, "kernel")):
        with routing(replay and routes[replay]) as seen:
            grads[name] = loss_and_grads(torch, get_model(c), state["params"], batch)
        routes[name] = seen  # the forward's L decisions, then the dots recompute's
    (lk, gk), (lt, gt), (_, gr) = (grads[n] for n in grads)
    routes = {n: r[:cfg.num_layers] for n, r in routes.items()}
    dropped = []
    for top in routes["kernel"]:
        counts = torch.bincount(top.reshape(-1), minlength=cfg.num_experts)
        dropped.append(int((counts - cap).clamp_min(0).sum()))
    def onehot(top):
        return torch.zeros(top.shape[0], cfg.num_experts, device=top.device).scatter_(1, top, 1)

    flipped = sum(int((onehot(a) - onehot(b)).clamp_min(0).sum())
                  for a, b in zip(routes["kernel"], routes["torch"]))
    norm = lambda gs: math.sqrt(sum(g.float().square().sum().item() for g in gs))  # noqa: E731
    nk, nt = norm(gk), norm(gt)

    def rel_to(ref):
        return sorted(((x - y).float().norm().item() / max(y.float().norm().item(), 1e-30), n)
                      for n, x, y in zip(names, gk, ref))

    rel, rel_same = rel_to(gt), rel_to(gr)
    top = ", ".join(f"{n} {r:.3e}" for r, n in reversed(rel[-4:]))
    top_same = ", ".join(f"{n} {r:.3e}" for r, n in reversed(rel_same[-4:]))
    log(f"[train_moe] pairs dropped by capacity per layer: {dropped} of {tokens * 8};"
        f" (token, choice) pairs routed to another expert by the torch backend: {flipped}"
        f" (over {len(routes['kernel'])} layers)")
    log(f"[train_moe] one step, kernel vs torch backend: loss {float(lk):.5f} vs {float(lt):.5f}"
        f" (|d|={abs(float(lk) - float(lt)):.5f}, tol 0.001), grad norm {nk:.5f} vs {nt:.5f}"
        f" ({100 * abs(nk - nt) / nt:.4f} %, tol 0.1 %); per-parameter ||d||/||g|| largest:"
        f" {top}")
    # A pair routed elsewhere moves every later pair's rank in two experts,
    # so which pairs the capacity drops changes too: the per-parameter
    # gradients are held with the torch step replaying the kernel step's
    # routing, where only the GEMMs' roundings differ.
    log(f"[train_moe] the same, the torch step on the kernel step's routing: per-parameter"
        f" ||d||/||g|| largest: {top_same} (tol 0.05)")
    check(sum(dropped) > 0, "no pair was dropped: the capacity path did not run")
    check(abs(float(lk) - float(lt)) <= 1e-3, f"kernel loss {float(lk)} vs torch {float(lt)}")
    check(abs(nk - nt) <= 1e-3 * nt, f"kernel grad norm {nk} vs torch {nt}")
    check(rel_same[-1][0] <= 0.05,
          f"kernel gradient of {rel_same[-1][1]} differs by {rel_same[-1][0]}")
    # Free-running, a flipped pair reaches every leaf through the backward
    # (the leaves before the first routing decision too: the embedding,
    # layer 0's ln1 and attention read up to 0.0575, PERF.md), so the
    # per-parameter limit holds on the replayed routing and the
    # free-running routing is held by how many pairs it flips.
    early = []
    for name, x, y in zip(names, gk, gt):
        if name.startswith(("blocks/ln1", "blocks/attn/")):
            name, x, y = f"{name}[0]", x[0], y[0]
        elif name != "embed":
            continue
        early.append(((x - y).float().norm().item() / max(y.float().norm().item(), 1e-30), name))
    early.sort()
    log(f"[train_moe] free-running, the leaves before the first routing: per-parameter"
        f" ||d||/||g|| " + ", ".join(f"{n} {r:.3e}" for r, n in reversed(early))
        + f" (not held: the flipped pairs reach them; flipped pairs {flipped}, tol"
        f" {MOE_TRAIN_FLIP_TOL})")
    check(flipped <= MOE_TRAIN_FLIP_TOL,
          f"the torch step routes {flipped} pairs elsewhere (tol {MOE_TRAIN_FLIP_TOL})")
    del grads, gt, gr, routes

    # Remat: the `dots` step and the `none` step give the same loss bit for
    # bit; their gradients agree within 1e-6 relative (the routing gathers'
    # backward accumulates with atomics on CUDA, in no fixed order).
    ln, gn = loss_and_grads(torch, get_model(dataclasses.replace(cfg, remat_policy="none")),
                            state["params"], batch)
    remat_rel = max((x - y).float().norm().item() / max(y.float().norm().item(), 1e-30)
                    for x, y in zip(gk, gn))
    log(f"[train_moe] remat dots vs none: loss {float(lk):.7f} vs {float(ln):.7f}"
        f" (bitwise equal: {bool(torch.equal(lk, ln))}), largest per-parameter"
        f" ||d||/||g|| {remat_rel:.3e} (tol 1e-6)")
    check(torch.equal(lk, ln), f"dots loss {float(lk)} != none loss {float(ln)}")
    check(remat_rel <= 1e-6, f"dots vs none gradients differ by {remat_rel}")
    del gk, gn

    # Six steps through train_loop with the asynchronous writer every 2
    # steps.  Each submit runs under the sync debug mode and is timed, with
    # the part it waited for the previous write (`waited_s`); just before
    # the step-4 submit a synchronous .cpu() copy of the state is taken.
    # Before step 6 (whose save lets the manager drop step 4: keep_n=1
    # bounds the disk), the phase waits for the step-4 write and restores it.
    per_step, sync_copy, restored, submits = [], {}, {}, []

    def submit(step, tree, meta=None):
        if step == 4:
            sync_copy.update(tree_map(lambda t: t.detach().to("cpu", copy=True), tree))
        t0 = time.monotonic()
        no_host_sync(torch, lambda: shipped_submit(step, tree, meta))
        submits.append((step, time.monotonic() - t0, writer.waited_s))

    def timed(st, b):
        if len(per_step) == 5:
            writer.wait()
            restored.update(ckpt.restore(4, sync_copy))
            restored["data_step"] = ckpt.meta(4)["data_step"]
        k1, k5 = mesh_matmul.launches, grouped_mesh_matmul.launches
        t0 = time.monotonic()
        st, met = step_fn(st, b)
        torch.cuda.synchronize()
        per_step.append((time.monotonic() - t0, mesh_matmul.launches - k1,
                         grouped_mesh_matmul.launches - k5))
        return st, met

    logger = MetricsLogger()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = CheckpointManager(tmp, keep_n=1)
        writer = AsyncCheckpointer(ckpt)
        shipped_submit, writer.submit = writer.submit, submit
        reset_k1(mesh_matmul)
        grouped_mesh_matmul.launches = 0
        t0 = time.monotonic()
        state = train_loop(timed, state, data, LoopConfig(total_steps=TRAIN_STEPS,
                                                          ckpt_every=2, log_every=1),
                           ckpt=ckpt, logger=logger, checkpointer=writer)
        t_close = time.monotonic()
        writer.close()
        wall = time.monotonic() - t0
        launches = {"mesh_matmul": mesh_matmul.launches,
                    "grouped_mesh_matmul": grouped_mesh_matmul.launches}
        check_main_path_tiles("train_moe", tile_counts(mesh_matmul), canary=False)
        losses = [h["loss"] for h in logger.history]
        for i, (h, (dt, k1, k5)) in enumerate(zip(logger.history, per_step)):
            log(f"[train_moe] step {i + 1}: loss={h['loss']:.5f} grad_norm={h['grad_norm']:.5f}"
                f" wall={dt * 1e3:.1f} ms tokens/s={tokens / dt:.1f} launches K1={k1} K5={k5}")
        log(f"[train_moe] {TRAIN_STEPS} steps: wall={wall:.3f} s with the writes (the last"
            f" write's wait {time.monotonic() - t_close:.1f} s); checkpoints kept"
            f" {ckpt.all_steps()}")
        for step, dt, waited in submits:
            log(f"[train_moe] submit at step {step} under set_sync_debug_mode('error'), 0 host"
                f" syncs: {1e3 * dt:.1f} ms, of which {1e3 * waited:.1f} ms waiting for the"
                f" previous write, {1e3 * (dt - waited):.1f} ms the snapshot"
                + (" (the first: pinned buffers allocated)" if step == 2 else ""))
        check(len(losses) == TRAIN_STEPS and all(math.isfinite(x) for x in losses),
              f"non-finite or missing losses: {losses}")
        check(losses[-1] < losses[0], f"loss did not fall: {losses}")
        want_k1 = 3 * (4 * cfg.num_layers + 1)
        want_k5 = 3 * 2 * cfg.num_layers
        check(all((k1, k5) == (want_k1, want_k5) for _, k1, k5 in per_step),
              f"per-step launches {per_step}, want K1 {want_k1} K5 {want_k5} under dots")

    # The step-4 checkpoint restores equal, bit for bit, to the copy taken
    # at its submit; resuming from it gives steps 5-6's losses.
    del state
    _free(torch)
    data_step = restored.pop("data_step")
    unequal = [p for (p, a), (_, b) in zip(tree_paths(restored), tree_paths(sync_copy))
               if not (a.dtype == b.dtype and torch.equal(a, b))]
    check(not unequal, f"step-4 checkpoint differs from the state at its submit: {unequal}")
    sync_copy.clear()
    resumed = tree_map(lambda t: t.to("cuda"), restored)
    restored.clear()
    data.restore(data_step)
    relog = MetricsLogger()
    train_loop(step_fn, resumed, data, LoopConfig(total_steps=TRAIN_STEPS, log_every=1),
               logger=relog)
    again = [h["loss"] for h in relog.history]
    gaps = [abs(a - b) for a, b in zip(again, losses[4:])]
    log(f"[train_moe] step-4 checkpoint restores bit for bit; resumed steps 5-6 losses"
        f" {[round(x, 6) for x in again]} vs {[round(x, 6) for x in losses[4:]]}"
        f" (|d| {gaps}, tol 1e-3)")
    check(len(again) == 2 and max(gaps) <= 1e-3, f"resumed losses {again} vs {losses[4:]}")
    profile_train_step(torch, step_fn, resumed, data, tag="profile train_moe")
    del resumed, step_fn
    _free(torch)

    # Each policy's step: time, peak memory and launches.
    steps = policy_steps(torch, cfg, "train_moe", ("none", "dots", "full"), batch)
    f_d, f_g = 4 * cfg.num_layers + 1, 2 * cfg.num_layers
    want = {"none": (3 * f_d, 2 * f_g), "dots": (3 * f_d, 3 * f_g),
            "full": (3 * f_d + f_d - 1, 3 * f_g)}
    got = {p: (steps[p]["k1"], steps[p]["k5"]) for p in steps}
    check(got == want, f"K1/K5 launches per step by policy {got}, want {want}")
    check(steps["dots"]["peak_gib"] < steps["none"]["peak_gib"],
          f"dots peak {steps['dots']['peak_gib']} GiB not below none's {steps['none']['peak_gib']}")
    return {**launches, "policies": steps}


def loss_and_grads(torch, model, params, batch):
    """(loss, gradients in tree order) of model.loss at `params` on a host batch."""
    from repro_torch.tree import tree_leaves, tree_map

    ps = tree_map(lambda t: t.detach().requires_grad_(True), params)
    dev = tree_leaves(ps)[0].device
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    with torch.enable_grad():
        loss, _ = model.loss(ps, batch)
        return loss.detach(), torch.autograd.grad(loss, tree_leaves(ps))


def phase_configs(torch):
    """Granite-3 8B, Phi-3-medium 14B and Mistral-Large 123B through
    `tuned()`, at full width and CONFIGS_LAYERS layers: one 2048-token prompt
    prefilled through K6, then decode ticks through the server on K4 (GQA
    rep 4, 4 and 12), GEMMs on the `torch` backend as published."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    from repro_torch.launch.scheduler import ContinuousBatchingServer, Request, ServeConfig
    from repro_torch.launch.serve import generate
    from repro_torch.models import get_model, transformer
    from repro_torch.models.layers import padded_vocab, rmsnorm
    from repro_torch.tree import tree_leaves

    launches = {"flash_attention": 0, "paged_attention": 0}
    for arch, rep in CONFIGS_ARCHS:
        _free(torch)
        published = get_config(arch)
        cfg = dataclasses.replace(published.tuned(), num_layers=CONFIGS_LAYERS)
        check(cfg.attn_chunk == 1024 and cfg.num_heads // cfg.num_kv_heads == rep
              and not cfg.use_mesh_kernel, f"unexpected {arch} config {cfg}")
        model = get_model(cfg)
        t0 = time.monotonic()
        torch.cuda.reset_peak_memory_stats()
        params = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in tree_leaves(params))
        log(f"[configs] {arch} tuned(), {cfg.num_layers} of {published.num_layers} layers:"
            f" {n_params / 1e9:.3f} B parameters ({published.n_params_dense_blocks() / 1e9:.1f} B"
            f" at full depth), vocab {cfg.vocab_size} padded to {padded_vocab(cfg)},"
            f" init {time.monotonic() - t0:.1f} s, peak"
            f" {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        prompt_np = np.random.default_rng(0).integers(0, cfg.vocab_size, CONFIGS_PROMPT)
        prompt_np = prompt_np.astype(np.int32)
        pages = -(-(CONFIGS_PROMPT + CONFIGS_NEW_TOKENS) // PAGE)
        scfg = ServeConfig(max_slots=SLOTS, page_size=PAGE, num_pages=1 + pages,
                           max_pages_per_seq=pages, queue_capacity=1,
                           warmup_prompt_lens=(CONFIGS_PROMPT,))
        flash_attention.launches = 0
        paged_attention_cuda.launches = 0
        server = ContinuousBatchingServer(model, params, scfg, device="cuda")
        server.warmup()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        results = server.run([Request(rid="req0", prompt=prompt_np,
                                      max_new_tokens=CONFIGS_NEW_TOKENS)])
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        res = results["req0"]
        check(res.status == "ok" and len(res.tokens) == CONFIGS_NEW_TOKENS,
              f"{arch}: {res.status} with {len(res.tokens)} tokens ({res.reason})")
        c = server.counters
        got = {"flash_attention": flash_attention.launches,
               "paged_attention": paged_attention_cuda.launches}
        want = {"flash_attention": cfg.num_layers * c["prefills"],
                "paged_attention": cfg.num_layers * c["decode_steps"]}
        log(f"[configs] {arch}: {CONFIGS_PROMPT}-token prompt x {CONFIGS_NEW_TOKENS} tokens:"
            f" wall={wall:.3f} s, prefills={c['prefills']} decode steps={c['decode_steps']}"
            f" (warmup included), launches={got} expected={want}")
        check(got == want, f"{arch}: launches {got} != {want}")
        for k in launches:
            launches[k] += got[k]

        # The head: padded rows never win, and a tied head reads embed.T.
        prompt = torch.as_tensor(prompt_np, device="cuda")[None]
        seen = []
        original = transformer.unembed

        def capture(p, x, cfg_):
            seen.append(x)
            return original(p, x, cfg_)

        transformer.unembed = capture
        try:
            with torch.inference_mode():
                logits, caches = model.prefill(params, {"tokens": prompt})
        finally:
            transformer.unembed = original
        vpad = padded_vocab(cfg)
        check(bool((logits.argmax(-1) < cfg.vocab_size).all()), f"{arch}: a padded row won")
        if vpad != cfg.vocab_size:
            masked = torch.tensor(-1e30, dtype=logits.dtype)
            check(bool((logits[..., cfg.vocab_size:].cpu() == masked).all()),
                  f"{arch}: padded logit rows are not masked")
        if cfg.tie_embeddings:
            check("lm_head" not in params, f"{arch}: a tied config has an lm_head")
            with torch.inference_mode():
                h = rmsnorm(seen[0][0, -8:], params["final_norm"], cfg.norm_eps)
                want_lg = torch.matmul(h.float(), params["embed"].float().T)[:, :cfg.vocab_size]
            d = (logits[0, -8:, :cfg.vocab_size].float() - want_lg).abs().max().item()
            log(f"[configs] {arch}: tied head vs rmsnorm(x) @ embed.T (f32), last 8 positions:"
                f" max |d|={d:.4f} (tol {CONFIGS_TIED_TOL}: the bf16 output rounding)")
            check(d <= CONFIGS_TIED_TOL, f"{arch}: tied head differs from embed.T by {d}")
        del logits, seen

        served = res.tokens
        ref_tokens, _ = generate(model, params, prompt, gen_len=CONFIGS_NEW_TOKENS)
        ref_tokens = ref_tokens[0].tolist()
        check(served[0] == ref_tokens[0], f"{arch}: first token {served[0]} != {ref_tokens[0]}")
        worst_diff, worst_gap, scale = paged_vs_dense(torch, model, params, caches, served,
                                                      CONFIGS_PROMPT)
        tol = CONFIGS_LOGIT_TOL[arch]
        log(f"[configs] {arch}: first token {served[0]} (generate {ref_tokens[0]});"
            f" teacher-forced paged-vs-dense max |dlogit|={worst_diff:.4f} (max |logit|"
            f" {scale:.3f}), worst server-token gap {worst_gap:.4f} (tol {tol})")
        check(worst_diff <= tol, f"{arch}: paged vs dense logits differ by {worst_diff}")
        check(worst_gap <= tol, f"{arch}: server token {worst_gap} below the dense argmax")
        del server, params, caches, model
    _free(torch)
    return launches


# The paper's sizes (`benchmarks/bench_stepcounts.py`) and one at full scale.
PAPER_SIZES = (2, 3, 4, 8, 16, 32, 64, 128, 1024)
PAPER_SYMMETRIC_SIZES = (8, 16, 32, 64, 256)
PAPER_KEY_SHAPE, PAPER_KEY = (8, 1024, 1024), 5


def phase_paper(torch, smi: str):
    """The paper's tables measured by simulation on the card, TF32 off.
    Inputs are f32 holding integers in [-8, 8], so every partial sum is an
    integer below 2^24 and every comparison is bitwise in any summation
    order."""
    import numpy as np

    from repro_torch.core import mesh_array as ma
    from repro_torch.core import scramble as scr
    from repro_torch.core import symmetries as sym

    check(not torch.backends.cuda.matmul.allow_tf32, "[paper] needs TF32 off")
    rng = np.random.default_rng(0)

    def ints(*shape):
        return torch.from_numpy(rng.integers(-8, 9, size=shape).astype(np.float32)).cuda()

    for n in PAPER_SIZES:
        a, b = ints(n, n), ints(n, n)
        c = a @ b
        walls = []
        for sim in (ma.simulate_mesh, ma.simulate_standard):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            res = sim(a, b)
            torch.cuda.synchronize()
            walls.append((res, time.monotonic() - t0))
        (mesh, t_mesh), (std, t_std) = walls
        ok = {
            "steps 2n-1": mesh.steps == 2 * n - 1,
            "steps 3n-2": std.steps == 3 * n - 2,
            "unscramble(mesh) == a @ b": torch.equal(scr.unscramble(mesh.output), c),
            "standard == a @ b": torch.equal(std.output, c),
            "mesh_matmul_reference == mesh": torch.equal(ma.mesh_matmul_reference(a, b),
                                                         mesh.output),
        }
        log(f"[paper] n={n}: mesh {mesh.steps} steps, standard {std.steps} steps;"
            f" wall mesh {t_mesh:.3f} s, standard {t_std:.3f} s; bitwise: "
            + ", ".join(f"{k} {v}" for k, v in ok.items()))
        check(all(ok.values()), f"[paper] n={n}: {ok}")

    for n in PAPER_SYMMETRIC_SIZES:
        a, b = ints(n, n), ints(n, n)
        sched = sym.symmetric_readout_schedule(n)
        pq = torch.tensor(list(sched), device="cuda") - 1
        cell = torch.tensor([v[0] for v in sched.values()], device="cuda") - 1
        step = torch.tensor([v[1] for v in sched.values()], device="cuda")
        reads = {}
        for name, rhs in (("A.A^T", a.T.contiguous()), ("A.B", b)):
            res = ma.simulate_mesh(a, rhs, record_history=True)
            read = res.history[step - 1, cell[:, 0], cell[:, 1]]
            want = (a @ rhs)[pq[:, 0], pq[:, 1]]
            reads[name] = int((read != want).sum().item())
            hist_mb = res.history.numel() * res.history.element_size() / 1e6
            del res
        horizon, bound = sym.symmetric_readout_steps(n), sym.paper_symmetric_bound(n)
        log(f"[paper] symmetric readout n={n}: last read at step {horizon} (paper bound"
            f" n+1+n/2 = {bound}, general 2n-1 = {2 * n - 1}); entries read wrong:"
            f" A.A^T {reads['A.A^T']} of {n * n}, general A.B {reads['A.B']} of {n * n};"
            f" history {hist_mb:.1f} MB")
        check(reads["A.A^T"] == 0 and horizon <= bound and int(step.max()) == horizon,
              f"[paper] symmetric readout n={n} failed: {reads}, {horizon} vs {bound}")
        check(reads["A.B"] > 0, f"[paper] n={n}: the early readout held for a general product")

    orders = {n: scr.scramble_order(n) for n in (3, 4, 5)}
    log(f"[paper] order of S: {orders} (paper: 7, 7, 20)")
    check(orders == {3: 7, 4: 7, 5: 20}, f"[paper] orders of S {orders}")

    # A runtime key on the card: S^k by one gather whose indices come from
    # the cycle tables, against k single scrambles, with no host sync.
    n = PAPER_KEY_SHAPE[-1]
    x = torch.randn(*PAPER_KEY_SHAPE, device="cuda")
    key = torch.tensor(PAPER_KEY, device="cuda")
    t0 = time.monotonic()
    scr.apply_scramble_power(x, key, n)  # builds and uploads the tables once
    torch.cuda.synchronize()
    t_tables = time.monotonic() - t0
    want = x
    for _ in range(PAPER_KEY):
        want = scr.apply_scramble(want, 1)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = scr.apply_scramble_power(x, key, n)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(torch.equal(got, want), f"[paper] apply_scramble_power(k={PAPER_KEY}) != "
          f"{PAPER_KEY} apply_scramble calls")
    xs = [x] + [x.clone() for _ in range(3)]  # 4 x 32 MB: more than twice the L2
    ms = time_ms(torch, [lambda x=x: scr.apply_scramble_power(x, key, n) for x in xs], 20)
    dev = device_ms(torch, [lambda x=x: scr.apply_scramble_power(x, key, n) for x in xs], 20)
    bms, _ = bound_ms(2 * x.numel() * x.element_size(), 0, "float32")
    log(f"[paper] apply_scramble_power {PAPER_KEY_SHAPE} f32, device key k={PAPER_KEY}:"
        f" bitwise equal to {PAPER_KEY} apply_scramble calls, no host sync under"
        f" set_sync_debug_mode('error'); {ms:.4f} ms (CUDA events), {dev:.4f} ms device,"
        f" bound of x read and written {bms:.4f} ms; tables built in {t_tables:.1f} s"
        f" (order of S at n={n}: {scr.scramble_order(n):.3e}) | {smi}")


def phase_planner(torch):
    """The GEMM planner's shim, default scope, dispatch, degradation ladder
    and guard on the card at mesh-paper's full width (d_model 2048, d_ff
    8192, 2 x 2048 tokens, bf16).  The only phase that arms faults: it
    clears the plan cache and the ledger when it ends."""
    import warnings

    from repro_torch.kernels import api, ops
    from repro_torch.kernels.mesh_matmul import mesh_matmul
    from repro_torch.resilience import faults, ledger
    from repro_torch.resilience.policy import NonFiniteError

    bf16 = torch.bfloat16
    d, ff, tokens = 2048, 8192, TRAIN_BATCH * TRAIN_SEQ
    g = torch.Generator(device="cuda").manual_seed(11)

    def rnd(*shape):
        return (torch.randn(*shape, generator=g, device="cuda") / math.sqrt(shape[0])).to(bf16)

    def spec(a, b, **kw):
        return api.GemmSpec.from_operands(a, b, out_dtype=bf16, **kw)

    def events():
        return [(e.site, e.fallback) for e in ledger.events()]

    api.clear_plan_cache()
    ledger.clear()
    reset_k1(mesh_matmul)
    x, h = rnd(tokens, d), rnd(tokens, ff)
    w = {"wq": rnd(d, d), "wk": rnd(d, d), "wv": rnd(d, d), "wo": rnd(d, d),
         "wi": rnd(d, 2 * ff), "wo_ff": rnd(ff, d)}

    # The legacy shim routes to the plans a caller builds directly.
    s = rnd(d, d)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        via_ops = ops.matmul(x, w["wq"], backend="cuda_mesh", out_dtype=bf16)
        via_alias = ops.matmul(s, w["wq"], backend="cuda_mesh_scrambled", out_dtype=bf16)
    direct = api.plan(spec(x, w["wq"]), backend="cuda_mesh", device="cuda")(x, w["wq"])
    direct_s = api.plan(spec(s, w["wq"], structure="scrambled"), backend="cuda_mesh",
                        device="cuda")(s, w["wq"])
    shim = {"ops.matmul cuda_mesh": torch.equal(via_ops, direct),
            "cuda_mesh_scrambled 2048^3": torch.equal(via_alias, direct_s)}

    # The scoped default routes an unpinned plan to K1.
    before = mesh_matmul.launches
    with api.default_backend("cuda_mesh"):
        pinned = api.plan(spec(x, w["wk"]), device="cuda")
        pinned(x, w["wk"])
    shim["default_backend -> K1"] = (pinned.backend == "cuda_mesh"
                                     and mesh_matmul.launches == before + 1)
    shim["unpinned -> torch"] = api.plan(spec(x, w["wk"]), device="cuda").backend == "torch"
    log(f"[planner] shim and default scope: {shim}")
    check(all(shim.values()), f"[planner] shim/default scope: {shim}")

    # execute_async over one layer's projections against sequential calls.
    items = [(api.plan(spec(x, w[n]), backend="cuda_mesh", device="cuda"), (x, w[n]))
             for n in ("wq", "wk", "wv", "wo", "wi")]
    items.append((api.plan(spec(h, w["wo_ff"]), backend="cuda_mesh", device="cuda"),
                  (h, w["wo_ff"])))
    seq = [p(*args) for p, args in items]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    seq = [p(*args) for p, args in items]
    torch.cuda.synchronize()
    t_seq = time.monotonic() - t0
    t0 = time.monotonic()
    outs = api.execute_async(items)
    t_async = time.monotonic() - t0
    same = [torch.equal(o, r) for o, r in zip(outs, seq)]
    log(f"[planner] execute_async over wq, wk, wv, wo, wi, wo_ff: bitwise equal to"
        f" sequential calls {same}; wall {t_async * 1e3:.2f} ms vs {t_seq * 1e3:.2f} ms")
    check(all(same), f"[planner] execute_async differs from sequential calls: {same}")
    check(not ledger.events(), f"[planner] events before any fault: {events()}")

    # The ladder: an execution fault degrades a fallback=True K1 plan to
    # `torch` once and for all; without the ladder it raises; a build fault
    # builds on `torch`.
    sq = spec(x, w["wq"])
    want = api.plan(sq, backend="torch", device="cuda")(x, w["wq"])
    ladder = api.plan(sq, backend="cuda_mesh", device="cuda", fallback=True)
    before = mesh_matmul.launches
    with faults.inject({"plan.execute": faults.FaultSpec(times=1)}):
        got = ladder(x, w["wq"])
    first = events()
    again = ladder(x, w["wq"])
    ok = {
        "degraded to torch": ladder.active_backend == "torch",
        "one plan.execute event": first == [("plan.execute", "torch")],
        "== torch plan bitwise": torch.equal(got, want),
        "stays on torch, no new event": torch.equal(again, want) and events() == first,
        "no K1 launch": mesh_matmul.launches == before,
    }
    raised = None
    with faults.inject({"plan.execute": faults.FaultSpec(times=1)}):
        try:
            api.plan(sq, backend="cuda_mesh", device="cuda")(x, w["wq"])
        except faults.FaultError as e:
            raised = e
    ok["fallback=False raises"] = raised is not None and events() == first
    ledger.clear()
    sv = spec(x, w["wv"], blocks=(128, 128, 64))  # not yet planned
    with faults.inject({"plan.build": faults.FaultSpec(times=1)}):
        built = api.plan(sv, backend="cuda_mesh", device="cuda", fallback=True)
    ok["build fault -> torch, one event"] = (built.backend == "torch"
                                             and events() == [("plan.build", "torch")])
    ok["built plan == torch plan bitwise"] = torch.equal(
        built(x, w["wv"]), api.plan(sv, backend="torch", device="cuda")(x, w["wv"]))
    log(f"[planner] ladder: {ok}")
    check(all(ok.values()), f"[planner] ladder: {ok}")

    # The guard, with kernel.output poisoned with NaN.
    ledger.clear()
    so = spec(x, w["wo"])
    clean = api.plan(so, backend="cuda_mesh", device="cuda")(x, w["wo"])
    nan = {"kernel.output": faults.FaultSpec(poison="nan")}
    guard = {}
    with faults.inject(nan):
        try:
            api.plan(so, backend="cuda_mesh", device="cuda", guard_nonfinite="raise")(x, w["wo"])
            guard["raise"] = False
        except NonFiniteError:
            guard["raise"] = True
    check(not ledger.events(), f"[planner] the raise policy recorded {events()}")
    with faults.inject(nan):
        out = api.plan(so, backend="cuda_mesh", device="cuda",
                       guard_nonfinite="zero_and_record")(x, w["wo"])
    guard["zero_and_record"] = (bool(torch.isfinite(out).all()) and out.view(-1)[0] == 0
                                and torch.equal(out.view(-1)[1:], clean.view(-1)[1:])
                                and events() == [("guard.nonfinite", "zero")])
    ledger.clear()
    fb = api.plan(so, backend="cuda_mesh", device="cuda", guard_nonfinite="fallback",
                  fallback=True)
    with faults.inject({"kernel.output": faults.FaultSpec(poison="nan",
                                                          match={"backend": "cuda_mesh"})}):
        out = fb(x, w["wo"])
    guard["fallback"] = (fb.active_backend == "torch" and bool(torch.isfinite(out).all())
                         and torch.equal(out, api.plan(so, backend="torch", device="cuda")(
                             x, w["wo"]))
                         and events() == [("guard.nonfinite", "torch")])
    log(f"[planner] guard under a NaN-poisoned kernel.output: {guard}")
    check(all(guard.values()), f"[planner] guard: {guard}")
    launches = {"mesh_matmul": mesh_matmul.launches}
    check_main_path_tiles("planner", tile_counts(mesh_matmul), canary=False)
    log(f"[planner] K1 launches {launches['mesh_matmul']}")
    log(ledger.format_summary("[planner]"))
    check(launches["mesh_matmul"] > 0, "[planner] K1 never launched")
    api.clear_plan_cache()
    ledger.clear()
    return launches


def main_path_products():
    """mesh-paper's main-path K1 products (M, K, N), bf16: decode (M =
    SLOTS), prefill (M = PROMPT) and the training forward (M = TRAIN_BATCH x
    TRAIN_SEQ), for each of its GEMMs."""
    return {f"{name} M={m}": (m, k, n) for m in (SLOTS, PROMPT, TRAIN_BATCH * TRAIN_SEQ)
            for name, (k, n) in MESH_PAPER_GEMMS.items()}


def phase_obs(torch, smi: str):
    """Observability and the cost model at mesh-paper's full width, (a)-(d)
    of the module docstring."""
    import dataclasses
    import importlib
    import re

    import numpy as np

    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.costmodel import default_coefficients, predict, terms_from_describe
    from repro_torch.kernels import api, autotune
    from repro_torch.kernels.mesh_matmul import mesh_matmul
    from repro_torch.launch.scheduler import ContinuousBatchingServer, Request, ServeConfig
    from repro_torch.launch.serve import serving_steps
    from repro_torch.launch.train import build_trainer
    from repro_torch.models import get_model
    from repro_torch.obs import bridge

    cal = importlib.import_module("repro_torch.costmodel.calibrate")
    bf16 = torch.bfloat16
    tmp = tempfile.TemporaryDirectory()
    scratch = Path(tmp.name)

    # (a) The blocks the chooser picked for each main-path product (the
    # run's cache, timed when a phase first planned it), and every timed
    # candidate's device ms, timed again into a scratch cache.
    products = main_path_products()
    picked, dev_ms, same_as_cpu = {}, {}, 0
    retime = autotune.AutotuneCache(scratch / "retime.json")
    on_cpu = autotune.AutotuneCache(scratch / "cpu.json")
    for label, (m, k, n) in products.items():
        blocks = autotune.resolve_blocks(m, k, n, bf16, "cuda_mesh", platform="cuda")
        obs.clear_spans()
        with obs.tracing():
            best = autotune.autotune(m, k, n, bf16, "cuda_mesh", platform="cuda", cache=retime)
        cands = {tuple(sp.attrs["blocks"]): sp.attrs["ms"] for sp in obs.spans("autotune.measure")}
        obs.clear_spans()
        check(len(cands) >= 1 and all(autotune.legal_on_card(m, k, n, c, bf16) for c in cands)
              and autotune.legal_on_card(m, k, n, blocks, bf16),
              f"[obs] (a) {label}: a block candidate off the tensor-core tiles: {cands}")
        picked[label] = blocks
        dev_ms[label] = cands.get(blocks) or autotune._default_measure(
            m, k, n, bf16, "cuda_mesh", blocks, platform="cuda")
        cpu = autotune.autotune(m, k, n, bf16, "cuda_mesh", platform="cpu", cache=on_cpu)
        same_as_cpu += blocks == cpu
        log(f"[obs] (a) {label} K={k} N={n}: picked {blocks} ({dev_ms[label]:.4f} ms device;"
            f" the CPU's, the reference's, {cpu}); timed again: {best}; candidates (ms) "
            + ", ".join(f"{'x'.join(map(str, c))} {t:.4f}" for c, t in sorted(
                cands.items(), key=lambda kv: kv[1])))

    log(f"[obs] (a) {same_as_cpu} of {len(products)} main-path products on the reference's"
        " blocks")

    # (b) The serve requests, untraced and traced (bridge installed) in turns.
    cfg = get_config("mesh-paper")
    model = get_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, PROMPT).astype(np.int32) for _ in range(REQUESTS)]
    pages = -(-(PROMPT + NEW_TOKENS) // PAGE)
    scfg = ServeConfig(
        max_slots=SLOTS, page_size=PAGE, num_pages=1 + SLOTS * pages,
        max_pages_per_seq=pages, queue_capacity=REQUESTS, warmup_prompt_lens=(PROMPT,),
    )

    def serve(the_model, traced):
        """One server over the requests: (tokens by rid, tokens/s, server);
        traced, the bridge's pending records are returned too."""
        server = ContinuousBatchingServer(the_model, params, scfg, device="cuda")
        if traced:
            obs.enable()
            bridge.install()
        server.warmup()
        reqs = [Request(rid=f"req{i}", prompt=p, max_new_tokens=NEW_TOKENS)
                for i, p in enumerate(prompts)]
        torch.cuda.synchronize()
        t0 = time.monotonic()
        results = server.run(reqs)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        pending = bridge.pending_calibration_records() if traced else []
        server.drain()  # the I/O point: folds the bridge's records in
        obs.disable()
        check(all(r.status == "ok" for r in results.values()), f"[obs] serve: {results}")
        tokens = {rid: r.tokens for rid, r in results.items()}
        return tokens, sum(map(len, tokens.values())) / wall, server, pending

    rates = {"untraced": [], "traced": []}
    tokens, _, _, _ = serve(model, False)  # warm: plans, caches
    counts = pending = None
    for traced in (False, True, True, False):
        obs.clear_spans()
        reset_k1(mesh_matmul)
        got, rate, server, pend = serve(model, traced)
        rates["traced" if traced else "untraced"].append(rate)
        check(got == tokens, f"[obs] (b) {'traced' if traced else 'untraced'} tokens differ")
        if traced and counts is None:
            check_main_path_tiles("obs", tile_counts(mesh_matmul), canary=True)
            counts = {}
            for sp in obs.spans():
                counts[sp.name] = counts.get(sp.name, 0) + 1
            pending = pend
            check(counts.get("serve.tick") == server.counters["ticks"]
                  and counts.get("serve.prefill") == REQUESTS
                  and counts.get("plan.execute", 0) > 0,
                  f"[obs] (b) span counts {counts} vs counters {server.counters}")
            stats = obs.stats()
    log(f"[obs] (b) {REQUESTS} requests x {NEW_TOKENS} tokens, the same tokens every run;"
        f" tokens/s untraced {rates['untraced']} traced {rates['traced']}"
        f" (order: untraced, traced, traced, untraced; card {smi})")
    log(f"[obs] (b) spans by name in one traced run: {dict(sorted(counts.items()))};"
        f" stats {stats}")
    on_card = [r for r in pending if "events" in r]
    obs_recs = [r for r in cal.default_cache().records("cuda") if r.get("source") == "obs"]
    check(pending and len(on_card) == len(pending) and obs_recs
          and all(r["ms"] > 0 for r in obs_recs),
          f"[obs] (b) calibration records: {len(pending)} pending, {len(on_card)} with CUDA"
          f" events, {len(obs_recs)} ingested")
    by_key = {}
    for r in obs_recs:
        by_key.setdefault(r["key"], []).append(r["ms"])
    log(f"[obs] (b) bridge: {len(on_card)} records per traced run, each with CUDA events"
        f" read at drain; {len(obs_recs)} in the calibration file; event ms (min / median)"
        " by plan: " + "; ".join(f"{k} {min(v):.4f} / {sorted(v)[len(v) // 2]:.4f}"
                                 for k, v in sorted(by_key.items())))

    # No host sync on the model's path with tracing on: one paged decode
    # step and one prefill, each GEMM under a span with its CUDA events.
    prefill, _ = serving_steps(model)
    zeros = {name: torch.zeros(shape, dtype=torch.int32, device="cuda")
             for name, shape in (("tokens", (SLOTS, 1)), ("tables", (SLOTS, pages)),
                                 ("positions", (SLOTS,)))}
    prompt = torch.as_tensor(prompts[0], device="cuda")[None]

    def one_step_and_prefill():
        with torch.inference_mode():
            model.paged_decode(params, zeros["tokens"], server.pools, zeros["tables"],
                               zeros["positions"])
            prefill(params, {"tokens": prompt})

    obs.clear_spans()
    with obs.tracing():
        no_host_sync(torch, one_step_and_prefill)
    traced_gemms = obs.spans("plan.execute")
    check(len(traced_gemms) == 2 * (sum(TICK_LAUNCHES.values()))
          and all(sp.events is not None for sp in traced_gemms),
          f"[obs] (b) traced step and prefill: {len(traced_gemms)} plan.execute spans")
    log(f"[obs] (b) one paged decode step and one prefill traced under"
        f" set_sync_debug_mode('error'): 0 host syncs, {len(traced_gemms)} plan.execute"
        " spans, each with a CUDA event pair")

    # The exports, written and parsed back.
    obs.enable()
    with obs.span("obs.export", run="chip_smoke"):
        pass
    obs.disable()
    trace_path = scratch / "trace.json"
    obs.write_chrome_trace(str(trace_path), metadata={"card": smi,
                                                      "calibration": bridge.calibration_stamp()})
    obs.write_prometheus(str(trace_path) + ".prom")
    n_jsonl = obs.write_spans_jsonl(str(trace_path) + ".jsonl")
    doc = json.loads(trace_path.read_text())
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    prom = (scratch / "trace.json.prom").read_text().strip().splitlines()
    prom_ok = all(re.match(r"^(# (HELP|TYPE) .*|[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})?"
                           r" ([0-9.e+-]+|\+Inf))$", line) for line in prom)
    jsonl = [json.loads(x) for x in (scratch / "trace.json.jsonl").read_text().splitlines()]
    check(len(xs) == len(jsonl) == n_jsonl == len(obs.spans()) == len(traced_gemms) + 1
          and prom_ok
          and any(line.startswith("serve_ticks_total") for line in prom),
          f"[obs] (b) exports: {len(xs)} trace events, {len(jsonl)} jsonl lines,"
          f" {len(obs.spans())} spans, prometheus parses: {prom_ok}")
    log(f"[obs] (b) exports parsed back: {len(xs)} trace events, {len(prom)} prometheus"
        f" lines, {len(jsonl)} span lines")
    obs.clear_spans()
    bridge.uninstall()

    # Tracing's host cost per GEMM: one decode-shape plan called back to
    # back, untraced and traced in turns (the card runs each call in about
    # 0.011 ms, below the host's launch cost, so the wall is host time).
    x = torch.randn(SLOTS, 2048, device="cuda").to(bf16)
    w = torch.randn(2048, 2048, device="cuda").to(bf16)
    gemm = api.plan(api.GemmSpec.from_operands(x, w, out_dtype=bf16), backend="cuda_mesh",
                    device="cuda")
    per_call = {False: [], True: []}
    for traced in (False, True, True, False):
        obs.clear_spans()
        scope = obs.tracing() if traced else contextlib.nullcontext()
        with scope, torch.inference_mode():
            gemm(x, w)
            torch.cuda.synchronize()
            t0 = time.monotonic()
            for _ in range(2000):
                gemm(x, w)
            torch.cuda.synchronize()
        per_call[traced].append((time.monotonic() - t0) / 2000 * 1e6)
    obs.clear_spans()
    log(f"[obs] (b) host us per call of the M={SLOTS} K=2048 N=2048 plan, 2000 calls:"
        f" untraced {per_call[False]}, traced {per_call[True]} (order: untraced, traced,"
        " traced, untraced)")

    # (c) Calibration on the card, into a scratch file; predicted ms of each
    # main-path product against its device ms from (a).
    shipped = default_coefficients("cuda")
    from_obs = cal.default_cache().coefficients("cuda")
    fitted = cal.calibrate(platform="cuda", cache=cal.CalibrationCache(scratch / "cal.json"),
                           persist=False)
    fields = ("flops_per_s", "hbm_bytes_per_s", "link_bytes_per_s", "phase_latency_s",
              "launch_overhead_s")
    for name, co in (("shipped", shipped), ("fit to (b)'s spans", from_obs),
                     ("fit to the probes", fitted)):
        log(f"[obs] (c) coefficients, {name}: "
            + ", ".join(f"{f}={getattr(co, f):.4g}" for f in fields)
            + f", source={co.source}")
    for label, (m, k, n) in products.items():
        p = api.plan(api.GemmSpec(m=m, k=k, n=n, dtype_a=bf16, dtype_b=bf16, out_dtype=bf16),
                     backend="cuda_mesh", device="cuda")
        terms = terms_from_describe(p.describe())
        log(f"[obs] (c) {label} (K={k} N={n}, blocks {p.blocks}): predicted"
            f" {predict(terms, shipped)['total_s'] * 1e3:.4f} ms shipped,"
            f" {predict(terms, fitted)['total_s'] * 1e3:.4f} ms probe fit;"
            f" device {dev_ms[label]:.4f} ms")
    check(fitted.source == "calibrated" and all(getattr(fitted, f) > 0 for f in fields[:3]),
          f"[obs] (c) calibrate() on the card: {fitted}")

    # (d) The chooser's blocks against 128^3, in turns.
    ref_blocks = (128, 128, 128)
    k1 = {}
    for label, (m, k, n) in products.items():
        times = {}
        for blocks in (picked[label], ref_blocks, ref_blocks, picked[label]):
            t = autotune._default_measure(m, k, n, bf16, "cuda_mesh", blocks, platform="cuda")
            times[blocks] = min(times.get(blocks, t), t)
        k1[label] = (times[picked[label]], times[ref_blocks])
        log(f"[obs] (d) K1 {label}: {picked[label]} {k1[label][0]:.4f} ms, 128^3"
            f" {k1[label][1]:.4f} ms device")
    tick = [sum(TICK_LAUNCHES[name] * k1[f"{name} M={SLOTS}"][i] for name in TICK_LAUNCHES)
            for i in (0, 1)]
    fwd = [sum(TICK_LAUNCHES[name] * k1[f"{name} M={TRAIN_BATCH * TRAIN_SEQ}"][i]
               for name in TICK_LAUNCHES) for i in (0, 1)]
    log(f"[obs] (d) K1 per decode tick (25 launches at M={SLOTS}): chooser {tick[0]:.4f} ms,"
        f" 128^3 {tick[1]:.4f} ms; per training forward (25 launches at"
        f" M={TRAIN_BATCH * TRAIN_SEQ}): chooser {fwd[0]:.4f} ms, 128^3 {fwd[1]:.4f} ms")
    cfg128 = dataclasses.replace(cfg, mesh_block_m=128, mesh_block_n=128, mesh_block_k=128)
    model128 = get_model(cfg128)
    serve_rates = {"chooser": [], "128^3": []}
    for name in ("chooser", "128^3", "128^3", "chooser"):
        _, rate, _, _ = serve(model if name == "chooser" else model128, False)
        serve_rates[name].append(rate)
    log(f"[obs] (d) serve tokens/s, chooser {serve_rates['chooser']}, 128^3"
        f" {serve_rates['128^3']} (order: chooser, 128^3, 128^3, chooser)")
    del params, server
    _free(torch)
    steps = {}
    for name, c in (("chooser", cfg), ("128^3", cfg128)):
        step_fn, state, data = build_trainer(c, batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=TRAIN_LR,
                                             total_steps=TRAIN_STEPS, seed=0, device="cuda")
        state, _ = step_fn(state, next(data))  # warm
        steps[name] = [step_fn, state, next(data), []]
    for name in ("chooser", "128^3", "128^3", "chooser"):
        step_fn, state, batch, times = steps[name]
        torch.cuda.synchronize()
        t0 = time.monotonic()
        steps[name][1], met = step_fn(state, batch)
        torch.cuda.synchronize()
        times.append((time.monotonic() - t0) * 1e3)
        check(math.isfinite(float(met["loss"])), f"[obs] (d) {name} step loss {met['loss']}")
    log(f"[obs] (d) train ms per step, chooser {steps['chooser'][3]}, 128^3"
        f" {steps['128^3'][3]} (order: chooser, 128^3, 128^3, chooser)")
    del steps
    _free(torch)
    tmp.cleanup()


def healthy(name, fn):
    """`fn` as a phase that arms no fault: the resilience ledger is cleared
    before it, and after it no planner event (`plan.*`, `guard.*`) may have
    been recorded and every cached plan must still run on its own backend,
    so no main-path GEMM left its kernel unseen."""
    def run(torch, *args):
        from repro_torch.kernels import api
        from repro_torch.resilience import ledger

        ledger.clear()
        t0 = time.monotonic()
        out = fn(torch, *args)
        log(f"[{name}] phase wall {time.monotonic() - t0:.1f} s")
        bad = [(e.site, e.fallback) for e in ledger.events()
               if e.site.startswith(("plan.", "guard."))]
        moved = [(d["mkn"], d["backend"], d["health"]["active_backend"])
                 for d in api.plan_cache_info()["plans"]
                 if d["health"]["active_backend"] != d["backend"]]
        check(not bad and not moved,
              f"[{name}] planner degradations in a fault-free phase: {bad} {moved}")
        return out
    return run


def main() -> int:
    only = None
    if len(sys.argv) == 3 and sys.argv[1] == "--only":
        only = set(sys.argv[2].split(","))
    elif len(sys.argv) != 1:
        print("usage: chip_smoke.py [--only PHASE,...]", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}; run it from "
              "the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 2
    smi = smi_line()
    log(f"[device] {smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    # Fresh autotune and calibration caches for the run: the blocks the
    # card picks (timed) fix K1's k order from then on.
    caches = tempfile.TemporaryDirectory()
    os.environ["REPRO_AUTOTUNE_CACHE"] = os.path.join(caches.name, "autotune.json")
    os.environ["REPRO_COSTMODEL_CACHE"] = os.path.join(caches.name, "costmodel.json")
    t_start = time.monotonic()
    phase_build(torch)
    phases = {name: healthy(name, fn) for name, fn in (
        ("k1", phase_k1), ("k4", phase_k4), ("k3", phase_k3), ("k1_bwd", phase_k1_backward),
        ("k5", phase_k5), ("k5_bwd", phase_k5_backward), ("k6", phase_k6),
        ("k6_bwd", phase_k6_backward), ("serve", phase_serve), ("train", phase_train),
        ("serve_moe", phase_serve_moe), ("serve_qwen2", phase_serve_qwen2),
        ("train_flash", phase_train_flash), ("serve_qwen2_moe", phase_serve_qwen2_moe),
        ("train_moe", phase_train_moe), ("configs", phase_configs))}
    phases["paper"] = healthy("paper", lambda torch: phase_paper(torch, smi))
    phases["planner"] = phase_planner
    phases["obs"] = healthy("obs", lambda torch: phase_obs(torch, smi))
    if only is not None:
        unknown = only - set(phases)
        check(not unknown, f"unknown phases {sorted(unknown)}; known: {sorted(phases)}")
        for name, fn in phases.items():
            if name in only:
                fn(torch)
        log(f"[done] phases {sorted(only)} only, {time.monotonic() - t_start:.1f} s;"
            " no result line")
        return 0
    k1_err, k1, k1b = phases["k1"](torch)
    k4_err, k4, k4_qwen = phases["k4"](torch)
    k3_err, k3 = phases["k3"](torch)
    k1_err = max(k1_err, phases["k1_bwd"](torch))
    k5_err, k5_tick, k5_prefill = phases["k5"](torch)
    k5_err = max(k5_err, phases["k5_bwd"](torch))
    k6_err, k6 = phases["k6"](torch)
    phases["k6_bwd"](torch)
    torch.cuda.synchronize()
    serve = phases["serve"](torch)
    train = phases["train"](torch)
    serve_moe = phases["serve_moe"](torch)
    serve_qwen2 = phases["serve_qwen2"](torch)
    train_flash = phases["train_flash"](torch)
    serve_qwen2_moe = phases["serve_qwen2_moe"](torch)
    train_moe = phases["train_moe"](torch)
    configs = phases["configs"](torch)
    phases["paper"](torch)
    planner = phases["planner"](torch)
    phases["obs"](torch)

    def row(name, source, replaces, launches, err, t, shape, **extra):
        return dict(name=name, route="cuda", source=f"src/repro_torch/csrc/{source}",
                    replaces=replaces, launches=launches, max_abs_err=err, ms=t["ms"],
                    plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                    library_ms=t["library_ms"], shape=shape, **extra)

    kernels = [
        row("mesh_matmul", "mesh_matmul.cu", "src/repro/kernels/mesh_matmul.py:341",
            serve["mesh_matmul"] + train["mesh_matmul"] + serve_moe["mesh_matmul"]
            + serve_qwen2_moe["mesh_matmul"] + train_moe["mesh_matmul"]
            + planner["mesh_matmul"], k1_err, k1,
            "one decode tick: 25 launches at M=4",
            launches_by_path={"serve": serve["mesh_matmul"], "train": train["mesh_matmul"],
                              "serve_moe": serve_moe["mesh_matmul"],
                              "serve_qwen2_moe": serve_qwen2_moe["mesh_matmul"],
                              "train_moe": train_moe["mesh_matmul"],
                              "planner": planner["mesh_matmul"]},
            launches_by_tile=K1_TILES,
            batched={**k1b, "replaces": "src/repro/kernels/mesh_matmul.py:404",
                     "shape": "B=4 M=128 K=1024 N=512 bf16"}),
        row("paged_attention", "paged_attention.cu",
            "src/repro/kernels/paged_attention.py:182",
            serve["paged_attention"] + serve_moe["paged_attention"]
            + serve_qwen2["paged_attention"] + serve_qwen2_moe["paged_attention"]
            + configs["paged_attention"], k4_err, k4,
            "one launch: S=4 H=KV=16 hd=128 bf16, 128-160 token contexts",
            launches_by_path={"serve": serve["paged_attention"],
                              "serve_moe": serve_moe["paged_attention"],
                              "serve_qwen2": serve_qwen2["paged_attention"],
                              "serve_qwen2_moe": serve_qwen2_moe["paged_attention"],
                              "configs": configs["paged_attention"]},
            qwen2={**k4_qwen, "shape": f"one launch: S=4 H=28 KV=4 hd=128 bf16, contexts"
                   f" {QWEN_LIVE}"}),
        row("scramble_blocks", "scramble_blocks.cu",
            "src/repro/kernels/scramble_kernel.py:41", train["scramble_blocks"], k3_err, k3,
            f"one launch: ({TRAIN_BATCH}, {TRAIN_SEQ}, 2048) bf16, 16x16 blocks of 128^2;"
            " library_ms is x.clone() (same bytes, no permutation)"),
        row("grouped_mesh_matmul", "grouped_matmul.cu", "src/repro/kernels/grouped.py:119",
            serve_moe["grouped_mesh_matmul"] + serve_qwen2_moe["grouped_mesh_matmul"]
            + train_moe["grouped_mesh_matmul"], k5_err, k5_tick,
            f"one OLMoE decode step: 32 launches (wi, wo x 16 layers), 64 experts x 8 rows,"
            f" {SLOTS} tokens routed; library_ms is torch.bmm + segment mask",
            launches_by_path={"serve_moe": serve_moe["grouped_mesh_matmul"],
                              "serve_qwen2_moe": serve_qwen2_moe["grouped_mesh_matmul"],
                              "train_moe": train_moe["grouped_mesh_matmul"]},
            launches_by_tile=K5_TILES, qwen2_moe_decode_step=serve_qwen2_moe["k5_decode_step"],
            prefill={**k5_prefill, "shape": f"one {PROMPT}-token prefill: 32 launches,"
                     " 64 experts x 128 rows"}),
        row("flash_attention", "flash_attention.cu", "src/repro/kernels/flash_attention.py:97",
            serve_qwen2["flash_attention"] + train_flash["flash_attention"]
            + configs["flash_attention"], k6_err,
            k6["qwen2 T=2048"],
            "one launch: Qwen2-7B prefill B=1 T=2048 H=28 KV=4 hd=128 bf16 causal; library_ms"
            " is scaled_dot_product_attention (is_causal, enable_gqa)",
            launches_by_path={"serve_qwen2": serve_qwen2["flash_attention"],
                              "train_flash": train_flash["flash_attention"],
                              "configs": configs["flash_attention"]},
            device_ms=k6["qwen2 T=2048"]["device_ms"],
            library_device_ms=k6["qwen2 T=2048"]["library_device_ms"],
            t4096=k6["qwen2 T=4096"], mesh_paper_train=k6["mesh-paper train"]),
    ]
    log(f"[done] total {time.monotonic() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
