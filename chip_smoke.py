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
              (tensor cores) and f32 (SIMT), causal with Tq != Tk and at
              a query offset, held by output-relative measures, and K6
              under `_FlashAttention`
              yielding gradients; R1 (`[rmsnorm]`, the port's own rmsnorm
              kernel, one CTA a row) at every d of the configs, bf16 within
              one output ulp and f32 within 1e-6 relative, each row of a
              call at 1-4096 rows bitwise equal to the row alone; K4 is also timed at Qwen2-7B's decode (GQA
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
              mode "error", paged vs dense logits (free-running: held at
              the steps with no flipped routing set, the flips counted;
              and on the dense step's routing), K5 per decode step
              against its byte bound, a 2-layer f32 witness of the kernel
              path against the `torch` backend, one window profiled;
  9. train_moe  OLMoE-1B-7B at full width and 2 of its 16 layers on the
              kernel path, 2 x 2048 tokens (capacity 640 rows per expert,
              pairs dropped): the kernel step against the `torch` step,
              `dots` against `none` (loss bitwise), 4 steps through
              `train_loop` at 1 of the 2 layers with the step-2 checkpoint
              written by an `AsyncCheckpointer` (submit without a host
              sync, bitwise equal to a synchronous copy, a resume of steps
              3-4), and one step per remat policy with its peak memory and
              K1/K5 launches;
  10. configs  Granite-3 8B, Phi-3-medium 14B and Mistral-Large 123B through
              `tuned()` at full width and 2 layers: a 2048-token prompt
              through K6, 8 decode steps through the server on K4 (GQA rep
              4, 4, 12), the padded and tied head, paged vs dense logits;
  10a. serve_rwkv  full-width RWKV-6 1.6B (24 layers, d_model 2048, 32 heads
              of 64, d_ff 7168, vocab 65536, bf16) through `tuned()` on the
              kernel path and the server's stacked-state path with serve's
              requests: K1 (193 a step: 8 a layer with the silu, relu and
              sigmoid epilogues, and the head) against the server's
              counters, 0 host syncs in a decode step, a 1-slot server's
              tokens equal to `generate`'s, the chunked WKV's prefill
              logits against the scan's in bf16 and with f32 weights;
  10b. serve_pixtral  full-width Pixtral-12B (40 layers, d_model 5120, 32
              heads over 8 of 128, d_ff 14336, vocab 131072, 256 stub
              patches, bf16, `torch` backend) through the server's pages:
              4 prompts of 1792-3840 tokens (+ 256 patches: 2048-4096
              positions) x 16 tokens, K6 40 a prefill and K4 40 a decode
              step against the counters, K6 prefill logits against the
              plain chunked path, paged vs dense decode;
  10c. serve_zamba  full-width Zamba2-1.2B (38 Mamba2 layers, 6
              applications of the shared block, a 2-layer tail) on the
              kernel path through `generate`: 2 x 2048-token prompts x 16
              tokens, K6 6 a prefill, K1 113 a step, prefill and decode
              logits against `forward`, `ssd_chunked` against `ssd_scan`
              at one layer's width in f32;
  10d. serve_whisper  full-width Whisper-medium (24 + 24 layers, d_model
              1024, 16 heads of 64, vocab padded to 51968) on the kernel
              path: 2 x 2048 frames (K6 non-causal 24 a prefill), a
              256-token decoder prompt and 16 decode steps, K1 386 a prefill
              and 241 a decode step, logits against `forward`;
  10e. train_rwkv  full-width RWKV-6 1.6B through `tuned()` (the chunked
              WKV, its chunk checkpoint on) on the kernel path, 2 x 2048
              tokens: the kernel step's loss and gradients against the
              `torch` backend's ([train]'s limits), 2 AdamW steps through
              `train_loop` at 6 of its 24 layers (K1 165 a step), and one
              step's peak memory with the chunk checkpoint and without it
              (6 of 24 layers); every
              K1 call of the
              phase, the backward's too, held by [K1 train] on its blocks;
  10f. train_zamba  full-width Zamba2-1.2B the same way (K1 339 a step, K6
              6: the shared block's attention forward);
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
  12a. sharded  the planner's collective schedules across 4 ranks, processes
              that share the card (gloo, the hops staged through host
              memory; a 2-rank NCCL probe first shows whether NCCL takes two
              ranks on one card), at mesh-paper's width M K N = 4096 2048
              8192: every schedule on K1 and `expert` on K5 at OLMoE's
              decode shape, integer-valued f32 bitwise and bf16 within
              2^-7·max|ref| of the unsharded plan, K1/K5 launches per rank
              against the plan's kernel_invocations, Cannon on a 2 x 2
              mesh, and a planted collective.step fault raising by default
              and degrading to replicated with the same bits; walls are
              printed, never as a speed;
  12b. train_dp  data-parallel training of full-width mesh-paper on 2 ranks
              sharing the card (gloo, the all-reduces staged through host
              memory), one row of train's 2 x 2048-token batch a rank,
              through `build_trainer(mesh=)` and `train_loop`: the DP
              gradients and loss bitwise equal to the rows' single-process
              steps weighted in f32, and against the full-batch step at
              [train]'s limits (K1's stagger gives a row another k order
              in a 2-row batch) with the grad norm within 0.01 %, 3 steps
              with K1 75 and K3 4 a step on each rank and the ranks'
              parameters bitwise equal after them, 3 int8 error-feedback
              steps (the residual identity bitwise at step 1, the mean
              within scale/2 and the cast, falling losses);
              then mesh-paper's 4 blocks as the stages of `pipeline_apply`
              over 4 ranks, bitwise equal to the blocks in sequence here;
              every rank's plans on this process's blocks; walls and bytes
              printed, never as speeds;
  12c. serve_tp  tensor-parallel serving on 2 ranks sharing the card (gloo):
              full-width mesh-paper through `ContinuousBatchingServer(ctx=)`
              with serve's requests (8 of 16 heads a rank; req0's first
              token equal to the single-process server's, teacher-forced
              TP logits against single-process ones, K1 and K4 launches
              against the server's counters), OLMoE-1B-7B with 32 of its
              64 experts a rank (one 128-token prefill and 8 decode steps
              on the single-process routing replayed and free-running,
              the flipped routing sets counted; K1 and K5 launches), and
              Qwen2-7B at 4 of its 28 layers, its 2048-token chunked
              prefill context-parallel under 'seq_attn' (K6 at q_offset 0
              and 1024); the parent plans every shard shape first and
              holds every K1 call of the ranks on its blocks and every K4,
              K5 and K6 call against its plain version; walls and each
              rank's peak memory printed, never as speeds;
  12d. serve_tp_families  on 4 ranks sharing the card (gloo): RWKV-6
              1.6B, Zamba2-1.2B and Whisper-medium at full width through
              `tuned()` on 1x2 (RWKV-6's generate, its 4-slot server and
              req0 teacher-forced, with an f32 witness; Zamba2's and
              Whisper's prefill and 8 teacher-forced decode steps; logits
              against the single-process ones), then mesh-paper through
              the server with serve's requests on 2x1 (2 slots a data
              rank: bitwise the single-process server) and 2x2 (2 slots
              and 8 of 16 heads a rank; its device steps teacher-forced);
              K1, K4 and K6 launches per rank against the code's counts,
              every K1 call held on its blocks and every K4 and K6 call
              against its plain version; each 2x1 data rank's decode
              products planned on the single process's 4-slot blocks (the
              bitwise check needs K1 on equal blocks; R1 makes rmsnorm
              batch-invariant);
  12e. dryrun  the dry runs (`launch/dryrun.py`) as rank 0 of pod16x16
              under a "fake" 256-rank process group: four cells traced on
              the CPU in a subprocess (statuses, finite and positive FLOPs,
              bytes and link bytes, each cell's roofline line), and
              Granite-3 8B at 2 layers through `tuned()`'s fields: its real
              train_4k and decode_32k steps on the card (decode on a
              sequence-sharded cache: its 8 kv heads do not divide 'model'),
              and its tuned train_4k step ('seq_sp' and FSDP), the peak
              memory against the dry run's argument + temp bytes, K6's
              launches against the code's count, the step's ms beside the
              roofline's bound (a reading);
  12f. train_sp  on 4 ranks sharing the card (gloo): full-width mesh-paper
              through `build_trainer` under 'seq_sp' (TRAIN_RULES) on 1x2
              and with FSDP parameters (PARAM_RULES) on 2x2, one step's
              gradients gathered against the single-process kernel step's,
              K1 75 and K3 4 a step on each rank, the FSDP rank's state
              against the same mesh's without FSDP; Granite-3 8B at 2
              layers decoding on 1x2 on a sequence-sharded cache, its
              logits against the single process's dense decode (bf16, and
              an f32 witness); every K1 and K6 call held;
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

Every phase but `planner` arms no fault in this process (the `sharded`
ranks arm one in their own): each starts with an empty resilience ledger
and fails if it records a planner event (`plan.*`, `guard.*`) or leaves a
cached plan on another backend than its own.

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
# later read 0.1953 and 0.3438); 1.0 is about 3x that.  Free-running, each
# path routes for itself, and a routing set flipped at a step moves that
# step's logits chaotically (1.379 in one run, 0.572 in the next, as the
# timed autotuner's blocks fell): so the logits are held only at the steps
# where no (step, layer) routing set differs, and the flips are counted:
# over 3 requests' 7 steps x 24 layers (504 sets) the first readings were
# 97 and 67, and the limit was about 3x the first; checked over
# QMOE_CHECKED requests it scales with their count.  The f32
# prefill witness (2 layers, kernel path vs `torch` backend, summation
# order only): the first reading was 1.693e-05 on logits up to 5.22.
QMOE_LOGIT_TOL = 1.0
QMOE_FLIP_TOL = 290 * 2 // 3  # over QMOE_CHECKED = 2 requests
QMOE_F32_TOL = 5e-5
# The same teacher-forced decode with the paged step on the dense step's
# routing, where only the attentions' roundings differ: the first readings
# were 0.0781, 0.0774 and 0.0742 on req0-2 (logits up to 4.28-4.38), and
# 0.25 is about 3x the largest.  With 2 f32 layers (summation order only):
# the first reading was 1.192e-05, and 3.5e-5 is about 3x that.  Two
# requests are checked (three until the run needed the time for [dryrun]);
# one alone may show no step without a flipped routing set.
QMOE_CHECKED = 2
QMOE_SAME_ROUTING_TOL = 0.25
QMOE_F32_DECODE_TOL = 3.5e-5
# OLMoE-1B-7B trained at full width and 2 of its 16 layers: AdamW's f32
# moments for the 6.919 B parameters alone take 55 GB, a full-depth step
# about 83 GB; 4 layers hold 1.88 B parameters, about 19 GB of state, and
# the three checkpoint writes of that state took most of the phase's
# 209-238 s, so the depth is cut to 2 to keep the whole run within its time.
MOE_TRAIN_LAYERS = 2
# Its steps through train_loop with an asynchronous checkpoint every 2: the
# step-MOE_HELD_CKPT checkpoint is held and resumed (6 steps and the step-4
# checkpoint until the run needed the time for [dryrun]: each 9.73 GiB
# write took about 40 s on a slow machine).
MOE_TRAIN_STEPS, MOE_HELD_CKPT = 4, 2
# The steps through train_loop and its checkpoint run at MOE_CKPT_LAYERS of
# those layers (full width), and only the held step-MOE_HELD_CKPT
# checkpoint is written (the loop's final one is not): one write of 5.7
# GiB, not two of 9.73 (which took about 90 s of the phase's 107 s on a
# slow machine), to pay for [train_sp] and [rmsnorm] in the run's time.
MOE_CKPT_LAYERS = 1
# Its capacity: 1.25 x 4096 tokens x 8 choices / 64 experts, rows per expert.
MOE_TRAIN_CAP = 640
# (token, choice) pairs of one step that the `torch` backend routes to
# another expert than the kernel path: the first reading, over 4 layers'
# 131,072, was 917, and the limit is 3x that (at 2 layers it bounds fewer).
MOE_TRAIN_FLIP_TOL = 2750
# Its free-running kernel-vs-torch grad norm (each step routing for itself)
# follows the flips: 0.0469 % in four runs and 0.1119 % in one at 4 layers,
# of one tree whose timed autotuner picked other blocks; the limit is 3x the
# larger.
# The 0.1 % limit of a step that differs in roundings only holds the torch
# step replaying the kernel step's routing.
MOE_TRAIN_FREE_NORM_TOL = 3.4e-3
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
# [dryrun]: the dry runs (`launch/dryrun.py`) of one rank of pod16x16 (256
# ranks under a "fake" process group).  (a) cells traced on the CPU in a
# subprocess: a dense train cell, an MoE decode cell, a recurrent cell and
# the long_500k skip of a full-attention arch.  (b), (c) Granite-3 8B
# through `tuned()`'s config fields (attn_chunk 1024: K6; vocab padded to a
# multiple of 256) at DRYRUN_DEPTH of its 40 layers and full width, under
# the untuned rules: rank 0's real train_4k step and decode_32k step on the
# card, from seed 0,
# their peak memory above the baseline against the dry run's argument +
# temp bytes at the same depth (DRYRUN_MEM_TOL, relative), K6's launches
# against the code's count (a layer's forward and its `dots` recompute).
# The values mean nothing (the fake group moves no data), only sizes and
# launches do.  The first readings (H100 80GB HBM3, 700 W): train 13.400
# GiB on the card against 13.210 GiB traced, 1.44 % (the card's library
# workspaces and the allocator's rounding), so 4.5 %, about 3x; decode
# 6.099 GiB both ways, under 0.005 %, held at 0.5 %.  Since the port has a
# sequence-sharded cache, decode_32k runs the reference's rule for
# Granite's 8 kv heads (kv_heads None, kv_seq 'model': a rank holds 1/16 of
# each row's positions), held at the same 0.5 %; (d) the tuned train_4k
# cell ('seq_sp' on 'model' and FSDP's PARAM_RULES) at the same depth and
# train_4k's 4.5 %.
DRYRUN_CELLS = (("granite-3-8b", "train_4k"), ("olmoe-1b-7b", "decode_32k"),
                ("rwkv6-1.6b", "decode_32k"), ("qwen2-7b", "long_500k"))
DRYRUN_SKIPPED = {("qwen2-7b", "long_500k")}
DRYRUN_ARCH, DRYRUN_DEPTH = "granite-3-8b", 2
DRYRUN_TUNED = {"attn_chunk": 1024, "vocab_pad_multiple": 256}
DRYRUN_MEM_TOL = {"train_4k": 0.045, "decode_32k": 0.005, "train_4k tuned": 0.045}
DRYRUN_CARD = ("train_4k", "decode_32k", "train_4k tuned")
DRYRUN_CPU_TIMEOUT_S = 300


_T0 = time.monotonic()


def log(msg: str) -> None:
    """A line of the run's log, with the seconds since the script started."""
    print(f"{msg} [t+{time.monotonic() - _T0:.1f}s]", flush=True)


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


# The blocks [K1] checked each (M, K, N) of K1_PATH_GEMMS on.
K1_PATH_BLOCKS = {}


@contextlib.contextmanager
def k1_products(family):
    """Records (M, K, N, activation, blocks) of every product the planner
    runs on K1 inside the block, then checks each is a case [K1] holds
    against its plain version: in K1_PATH_GEMMS[family] at one of its M,
    and on the blocks [K1] ran it on (when [K1] ran in this process)."""
    from repro_torch.kernels import api

    run, seen = api._DENSE_FORWARD["cuda_mesh"], set()

    def record(a, b, bias, residual, opts, sigma):
        seen.add((a.numel() // a.shape[-1], a.shape[-1], b.shape[-1], opts.activation,
                  (opts.block_m, opts.block_n, opts.block_k)))
        return run(a, b, bias, residual, opts, sigma)

    api._DENSE_FORWARD["cuda_mesh"] = record
    try:
        yield seen
    finally:
        api._DENSE_FORWARD["cuda_mesh"] = run
    table = {(k, n, kw.get("activation")): ms for k, n, kw, ms in K1_PATH_GEMMS[family].values()}
    stray = sorted((x for x in seen if x[0] not in table.get(x[1:4], ())
                    or K1_PATH_BLOCKS.get(x[:3], x[4]) != x[4]), key=str)
    log(f"[{family}] K1 products (M, K, N, activation, blocks) on the path:"
        f" {sorted(seen, key=str)}")
    check(not stray, f"{family}: K1 products that [K1] does not hold: {stray}")


# Every K1 call [K1] and [K1 train] held against mesh_matmul_torch (k1_key),
# and which of the two phases ran in this process.
K1_HELD = set()
K1_HELD_BY = set()


def k1_key(a, b, kw):
    """A call of mesh_matmul(a, b, **kw) as the product it runs: operand
    shapes and dtype, output dtype, blocks, stagger and epilogue, with
    mesh_matmul's defaults filled in."""
    return (tuple(a.shape), tuple(b.shape), str(a.dtype)[6:],
            str(kw.get("out_dtype") or a.dtype)[6:],
            tuple(kw.get(f"block_{x}", 128) for x in "mnk"), kw.get("stagger", True),
            kw.get("scramble_out", False), kw.get("activation"), kw.get("bias") is not None,
            kw.get("residual") is not None)


@contextlib.contextmanager
def k1_calls():
    """Records k1_key of every K1 call `kernels.api` makes inside the
    block: the planner's forward products and the `_mm` backward's GEMMs
    (autograd's device thread included)."""
    from repro_torch.kernels import api

    run, seen = api.mesh_matmul, set()

    def record(a, b, **kw):
        seen.add(k1_key(a, b, kw))
        return run(a, b, **kw)

    api.mesh_matmul = record
    try:
        yield seen
    finally:
        api.mesh_matmul = run


def check_k1_held(tag, seen):
    """Each K1 call in `seen` is one [K1 train] held against its plain
    version, blocks and all, when it ran in this process; else at least one
    of dp_products' or family_train_products' shapes (the blocks
    unchecked, as logged)."""
    if "k1_bwd" in K1_HELD_BY:
        stray = [x for x in seen if x not in K1_HELD]
        how = "held by [K1]/[K1 train] on the same blocks"
    else:
        shapes = {(a, b, dt) for _, a, b, dt, _ in dp_products(lambda *_: None)}
        shapes |= {key[:3] for key in family_train_products(lambda *_: (128, 128, 128))}
        stray = [x for x in seen if x[:3] not in shapes]
        how = "among [train_dp]'s and the families' shapes ([K1 train] did not run here: blocks" \
              " unchecked)"
    log(f"[{tag}] {len(seen)} distinct K1 calls (a, b, dtype, out, blocks, stagger, scramble,"
        f" activation, bias, residual), {len(seen) - len(stray)} {how}")
    check(not stray, f"{tag}: K1 calls that [K1 train] does not hold: {sorted(stray, key=str)}")


@contextlib.contextmanager
def k4_k5_calls():
    """Records every K4, K5 and K6 launch the model code makes inside the
    block as the case it runs: K4's operand shapes, dtype, block table and
    lengths; K5's operand shapes, dtypes, blocks, stagger, epilogue and
    group sizes; K6's operand shapes, dtype, mask and query offset.  Each
    K4 and K5 call reads its table, lengths or sizes back to the host (a
    sync).  Yields the three sets (k4, k5, k6)."""
    import dataclasses

    from repro_torch.kernels import api
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa

    k4, k5, k6 = set(), set(), set()
    door, grouped, flash = pa._PAGED_REGISTRY["cuda_paged"], api.grouped_mesh_matmul, fa._launch

    def paged(q, kp, vp, bt, ln):
        k4.add((tuple(q.shape), tuple(kp.shape), str(q.dtype)[6:],
                tuple(map(tuple, bt.tolist())), tuple(ln.tolist())))
        return door.fn(q, kp, vp, bt, ln)

    def ragged(tokens, sizes, w, **kw):
        k5.add((tuple(tokens.shape), tuple(w.shape), str(tokens.dtype)[6:],
                str(kw.get("out_dtype") or tokens.dtype)[6:],
                tuple(kw[f"block_{x}"] for x in "mnk"), kw["stagger"], kw["activation"],
                kw.get("bias") is not None, kw.get("residual") is not None,
                tuple(sizes.tolist())))
        return grouped(tokens, sizes, w, **kw)

    def attend(q, k, v, causal, q_offset=0):
        k6.add((tuple(q.shape), tuple(k.shape), str(q.dtype)[6:], bool(causal), int(q_offset)))
        return flash(q, k, v, causal, q_offset)

    pa._PAGED_REGISTRY["cuda_paged"] = dataclasses.replace(door, fn=paged)
    api.grouped_mesh_matmul = ragged
    fa._launch = attend
    try:
        yield k4, k5, k6
    finally:
        pa._PAGED_REGISTRY["cuda_paged"] = door
        api.grouped_mesh_matmul = grouped
        fa._launch = flash


def _as_key(x):
    """A JSON-read key of k1_calls or k4_k5_calls (lists) as the tuple it
    was."""
    return tuple(_as_key(v) for v in x) if isinstance(x, list) else x


def hold_k4_k5_calls(torch, tag, k4, k5, k6=()):
    """Holds every K4, K5 and K6 call recorded by k4_k5_calls against its
    plain version, at [K4]'s, [K5]'s and [K6]'s limits: random operands of
    the call's shapes and types (one set per shape) with its block table
    and lengths, its group sizes, or its mask and query offset (K6's plain
    version in chunks of QWEN_CHUNK keys, as [K6] and the models' attn_chunk
    run it).  Logs each failure and the worst case of each kernel; returns
    (K4 calls held, K5 calls held, K6 calls held)."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_torch

    g = torch.Generator(device="cuda").manual_seed(12)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def rnd(shape, dt):
        return torch.randn(*shape, generator=g, device="cuda").to(getattr(torch, dt))

    failed, worst, operands = [], {}, {}
    for key in sorted(k4, key=str):
        q_shape, pool_shape, dt, table, lengths = key
        if (q_shape, pool_shape, dt) not in operands:
            operands.clear()
            operands[(q_shape, pool_shape, dt)] = (rnd(q_shape, dt), rnd(pool_shape, dt),
                                                  rnd(pool_shape, dt))
        q, kp, vp = operands[(q_shape, pool_shape, dt)]
        bt = torch.tensor(table, dtype=torch.int32, device="cuda")
        ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        err, bad, line = _k4_case(torch, tag, "K4 call", q, kp, vp, bt, ln, sms)
        worst["K4"] = max(worst.get("K4", (-1.0, "")), (err, line))
        if bad:
            log(line)
            failed.append(f"K4 {key}: {'; '.join(bad)}")
    operands.clear()
    for key in sorted(k5, key=str):
        t_shape, w_shape, dt, out_dt, blocks, stagger, act, bias, res, sizes = key
        if (t_shape, w_shape, dt) not in operands:
            operands.clear()
            operands[(t_shape, w_shape, dt)] = (rnd(t_shape, dt), rnd(w_shape, dt))
        tokens, w = operands[(t_shape, w_shape, dt)]
        kw = dict(block_m=blocks[0], block_n=blocks[1], block_k=blocks[2], stagger=stagger,
                  activation=act, out_dtype=getattr(torch, out_dt))
        if bias:
            kw["bias"] = rnd((w_shape[0], w_shape[2]), dt)
        if res:
            kw["residual"] = rnd((t_shape[0], w_shape[2]), dt)
        sz = torch.tensor(sizes, dtype=torch.int32, device="cuda")
        err, bad, line = _k5_case(torch, tag, "K5 call", tokens, sz, w, kw)
        worst["K5"] = max(worst.get("K5", (-1.0, "")), (err, line))
        if bad:
            log(line)
            failed.append(f"K5 {key[:-1]} sizes {sizes}: {'; '.join(bad)}")
    operands.clear()
    for key in sorted(k6, key=str):
        q_shape, k_shape, dt, causal, off = key
        q, k, v = rnd(q_shape, dt), rnd(k_shape, dt), rnd(k_shape, dt)
        chunk = QWEN_CHUNK if k_shape[1] % QWEN_CHUNK == 0 else k_shape[1]
        out = flash_attention_cuda(q, k, v, causal=causal, q_offset=off)
        ref = flash_attention_torch(q, k, v, causal=causal, block_q=1, block_k=chunk,
                                    q_offset=off)
        got, lim = disagreement(torch, out, ref), K6_LIMITS[dt]
        bad = [f"{m} {got[m]:.3e} > {x:.3e}" for m, x in lim.items() if not got[m] <= x]
        if not bool(torch.isfinite(out.float()).all()):
            bad.append("non-finite output")
        line = (f"[{tag}] K6 call q {q_shape} k {k_shape} {dt} causal={causal} q_offset={off}: "
                + " ".join(f"{m}={x:.3e}" for m, x in got.items()))
        worst["K6"] = max(worst.get("K6", (-1.0, "")), (got["err"], line))
        if bad:
            log(line)
            failed.append(f"K6 {key}: {'; '.join(bad)}")
        del q, k, v, out, ref
    for name, (_, line) in sorted(worst.items()):
        log(f"[{tag}] {name}: the call with the largest |d| of those held: {line}")
    check(not failed, f"{tag}: K4/K5/K6 calls disagree with their plain versions: {failed}")
    return len(k4), len(k5), len(k6)


def phase_k1(torch):
    """K1 (mesh_matmul) against mesh_matmul_torch on every tile family and
    every GEMM of the kernel-path phases, then timings."""
    from repro_torch.kernels import api
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
        # The server's warmup canary (every serving phase and rank runs it).
        ("warmup canary 8x8x8", (8, 8, 8), f32, dict(block_m=8, block_n=8, block_k=8)),
    ]
    # Every GEMM of [serve_rwkv], [serve_zamba] and [serve_whisper], with its
    # fused epilogue, at each M its phase runs it, on the blocks the planner
    # resolves for that product (the autotuner's, memoized for the run, so
    # the phases' plans take the same ones).
    held = set()
    for family, table in K1_PATH_GEMMS.items():
        for label, (k, n, kw, ms) in table.items():
            for m in ms:
                if (m, k, n, kw.get("activation")) in held:
                    continue
                held.add((m, k, n, kw.get("activation")))
                spec = api.GemmSpec.from_operands(
                    torch.empty(m, k, dtype=bf16, device=dev),
                    torch.empty(k, n, dtype=bf16, device=dev), out_dtype=bf16)
                blocks = api.plan(spec, backend="cuda_mesh", device=dev).blocks
                K1_PATH_BLOCKS[(m, k, n)] = blocks
                cases.append((f"{family} {label} M={m}", (m, k, n), bf16,
                              dict(kw, **dict(zip(("block_m", "block_n", "block_k"), blocks)))))
    # Qwen1.5-MoE's dense GEMMs on [serve_qwen2_moe]'s path, at its decode
    # and prefill M: the 151,936-column unembed and the shared experts'
    # fused wi and wo.
    for label, (k, n) in QMOE_DENSE_GEMMS.items():
        for m in (SLOTS, PROMPT):
            cases.append((f"qwen2-moe {label} M={m}", (m, k, n), bf16, {}))
    # [serve_tp]'s products on a rank (its heads, its gate and up slices,
    # its vocab rows; the row-parallel ones with f32 outputs), on the blocks
    # the planner resolves: planned here, so [serve_tp]'s ranks read them
    # from the run's autotune cache.
    tp_blocks, seen = plan_products(torch, tp_products(torch)), set()
    for label, m, k, n, out_dt in tp_products(torch):
        if (m, k, n, out_dt) in seen:
            continue
        seen.add((m, k, n, out_dt))
        kw = dict(zip(("block_m", "block_n", "block_k"), tp_blocks[(m, k, n)]))
        if out_dt is not None:
            kw["out_dtype"] = out_dt
        cases.append((f"serve_tp {label}", (m, k, n), bf16, kw))
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
        else:
            K1_HELD.add(k1_key(a, b, kw))
        max_err = max(max_err, err)
    check(not failed, f"K1 disagrees with its plain version: {failed}")
    K1_HELD_BY.add("k1")

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
    from repro_torch.kernels.paged_attention import split_plan

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
        # A rank's heads of mesh-paper under [serve_tp] (the split's pairs
        # are slots x the rank's kv heads).
        ("mesh-paper TP rank: 8 of 16 heads", TP_DECODE, live, bf16, None),
        ("mesh-paper TP rank: 8 of 16 heads f32", TP_DECODE, live, f32, None),
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
        ("pixtral rep=4, 2-4k tokens", PIXTRAL_DECODE, PIXTRAL_LIVE, bf16, None),
        ("pixtral rep=4, 2-4k tokens f32", PIXTRAL_DECODE, PIXTRAL_LIVE, f32, None),
    ]
    max_err, failed = 0.0, []
    for label, (s, h, kvh, hd), lengths, dtype, width in cases:
        q, kp, vp, bt, ln = _paged_inputs(torch, g, s, h, kvh, hd, lengths, dtype, width)
        err, bad, line = _k4_case(torch, "K4", f"{label:30s}", q, kp, vp, bt, ln, sms)
        log(line)
        if bad:
            failed.append(f"{label} {dtype}: {'; '.join(bad)}")
        max_err = max(max_err, err)
        del q, kp, vp, bt, ln
    check(not failed, f"K4 disagrees with its plain version: {failed}")

    # Timings at the serving decode shapes (one launch per layer and tick):
    # mesh-paper's and Qwen2-7B's.
    mesh = _k4_time(torch, g, (SLOTS, 16, 16, 128), live)
    return max_err, mesh, _k4_time(torch, g, qwen, QWEN_LIVE)


def _k4_case(torch, tag, label, q, kp, vp, bt, ln, sms):
    """One launch of K4 on (q, pools, table, lengths) against
    paged_attention_torch: (max |d|, the failed measures, a log line)."""
    from repro_torch.kernels.paged_attention import (
        paged_attention_cuda,
        paged_attention_torch,
        split_plan,
    )

    s, h, _ = q.shape
    kvh, dtype = kp.shape[2], q.dtype
    split_pages, n_splits = split_plan(bt.shape[1], s * kvh, sms)
    before = paged_attention_cuda.launches
    out = paged_attention_cuda(q, kp, vp, bt, ln)
    launched = paged_attention_cuda.launches - before
    ref = paged_attention_torch(q, kp, vp, bt, ln)
    torch.cuda.synchronize()
    got = disagreement(torch, out, ref)
    err = got["err"]
    # bf16: probabilities round to bf16 before the p.v product at different
    # points (unnormalized per key group in the kernel, normalized in the
    # plain version), each term off by <= 2^-8 relative, plus the output
    # rounding: 2^-6 of the largest |v|.  f32: summation order only.  That
    # bound does not scale with the output (|out| is about sqrt(e / n) over
    # n live keys), so the measures relative to the output, K4_LIMITS, hold
    # each case beside it.
    bf16 = dtype == torch.bfloat16
    tol = (2.0**-6 if bf16 else 1e-5) * vp.float().abs().max().item()
    why = ("2^-6 max|v|: p rounded to bf16 at different points, bf16 output"
           if bf16 else "1e-5 max|v|: summation order only")
    lim = K4_LIMITS[str(dtype).removeprefix("torch.")]
    bad = [f"{name} {got[name]:.3e} > {x:.3e}" for name, x in lim.items() if not got[name] <= x]
    if not bool(torch.isfinite(out.float()).all()):
        bad.append("non-finite output")
    if not err <= tol:
        bad.append(f"err {err} > tol {tol}")
    if launched != 1:
        bad.append(f"{launched} counted launches")
    line = (f"[{tag}] {label} {str(dtype)[6:]:8s} S={s} H={h} KV={kvh} hd={q.shape[-1]}"
        f" lengths={ln.tolist()} splits={n_splits}x{split_pages} pages"
        f" max|out|={ref.float().abs().max().item():.3e} "
        + " ".join(f"{name}={x:.3e}" for name, x in got.items())
        + f" tol={tol:.3e} ({why}) limits {lim}: "
        + ("FAIL " + "; ".join(bad) if bad else "ok"))
    return err, bad, line


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


# [rmsnorm]: R1 (`kernels/rmsnorm.py`, `csrc/rmsnorm.cu`), the port's own
# kernel: rmsnorm whose order of summation is fixed per row.  Held against
# rmsnorm_torch at every d the configs use, bf16 within one output ulp
# elementwise and f32 within 1e-6 relative; read bitwise batch-invariant:
# each row of a call at RMSNORM_ROWS rows equal to the same row alone, over
# RMSNORM_DRAWS random draws.  R1's element-by-element load path (d not a
# multiple of 16 bytes' elements, or rows at an unaligned address) is held
# the same way at RMSNORM_ODD_D and on rows one element into their storage,
# which must also equal the aligned rows bitwise (one order of summation).
# Timed at mesh-paper's training activations and a decode tick against its
# byte bound and F.rms_norm.
RMSNORM_WIDTHS = (1024, 1536, 2048, 3584, 4096, 5120, 12288)
RMSNORM_ODD_D = 1001
RMSNORM_ROWS = (1, 2, 3, 4, 8, 64, 4096)
RMSNORM_DRAWS = 4
RMSNORM_F32_TOL = 1e-6
# R1's launches in each phase's own process, read by `healthy` (the ranks'
# launches of multi-rank phases are their own processes', not counted here).
RMSNORM_BY_PHASE = {}


def _bf16_ulp(torch, t):
    a = t.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def phase_rmsnorm(torch):
    """R1 against rmsnorm_torch at every (d, dtype), its batch invariance
    bitwise, then its device time against the byte bound and F.rms_norm."""
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_cuda, rmsnorm_torch

    g = torch.Generator(device="cuda").manual_seed(21)
    eps, max_err, worst = 1e-5, 0.0, {}

    def held(x, w, label):
        nonlocal max_err
        got, want = rmsnorm_cuda(x, w, eps), rmsnorm_torch(x, w, eps)
        diff = (got.float() - want.float()).abs()
        if x.dtype == torch.bfloat16:
            rel = float((diff / _bf16_ulp(torch, want)).max())  # in output ulps
            ok = rel <= 1.0
        else:
            rel = float((diff / want.float().abs().clamp_min(1e-30)).max())
            ok = rel <= RMSNORM_F32_TOL
        max_err = max(max_err, float(diff.max()))
        worst[label] = rel
        check(ok, f"[rmsnorm] {label}: {rel} against its limit")
        return got

    for d in RMSNORM_WIDTHS + (RMSNORM_ODD_D,):
        for dtype in (torch.bfloat16, torch.float32):
            x = (torch.randn(37, d, generator=g, device="cuda")
                 * torch.rand(37, 1, generator=g, device="cuda") * 4).to(dtype)
            w = (1 + 0.1 * torch.randn(d, generator=g, device="cuda")).to(dtype)
            got = held(x, w, f"{d} {str(dtype)[6:]}")
            if d == 2048:
                # The same rows one element into their storage: not 16-byte aligned.
                buf = torch.empty(x.numel() + 1, dtype=dtype, device="cuda")
                shifted = buf[1:].view(x.shape)
                shifted.copy_(x)
                check(shifted.data_ptr() % 16 != 0, "[rmsnorm] the shifted rows are aligned")
                check(torch.equal(held(shifted, w, f"{d} {str(dtype)[6:]} unaligned"), got),
                      f"[rmsnorm] d={d} {dtype}: unaligned rows differ from the aligned rows")
    log("[rmsnorm] R1 against rmsnorm_torch, 37 rows: worst per (d, dtype) (bf16 in output"
        f" ulps, limit 1; f32 relative, limit {RMSNORM_F32_TOL}; d {RMSNORM_ODD_D} and the"
        " unaligned rows on the element-by-element loads, the unaligned rows bitwise the"
        " aligned): " + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))
    # Batch invariance: every row of a call against the row alone.
    mism, rows_checked = [], 0
    for d in (2048, 4096, RMSNORM_ODD_D):
        for dtype in (torch.bfloat16, torch.float32):
            w = (1 + 0.1 * torch.randn(d, generator=g, device="cuda")).to(dtype)
            for n in RMSNORM_ROWS:
                for _ in range(RMSNORM_DRAWS):
                    x = (torch.randn(n, d, generator=g, device="cuda") * 3).to(dtype)
                    whole = rmsnorm(x, w, eps)
                    picks = sorted({0, n // 2, n - 1} | set(
                        torch.randint(0, n, (5,), generator=g, device="cuda").tolist()))
                    for r in picks:
                        rows_checked += 1
                        if not torch.equal(whole[r], rmsnorm(x[r:r + 1], w, eps)[0]):
                            mism.append((d, str(dtype)[6:], n, r))
    log(f"[rmsnorm] batch invariance: {rows_checked} rows of calls at {RMSNORM_ROWS} rows"
        f" (d 2048, 4096 and {RMSNORM_ODD_D}, bf16 and f32, {RMSNORM_DRAWS} draws"
        f" each) against the row alone:"
        f" {len(mism)} differ")
    check(not mism, f"[rmsnorm] rows that depend on the call's row count: {mism[:8]}")
    # Time: mesh-paper's training activations (2 x 2048 rows of 2048, bf16),
    # cycled past the L2, and a decode tick's 4 rows.
    times = {}
    for label, rows in (("train", TRAIN_BATCH * TRAIN_SEQ), ("decode", SLOTS)):
        d = 2048
        w = (1 + 0.1 * torch.randn(d, generator=g, device="cuda")).to(torch.bfloat16)
        xs = [torch.randn(rows, d, generator=g, device="cuda").to(torch.bfloat16)]
        nbytes = xs[0].numel() * 2
        xs += [xs[0].clone() for _ in range(math.ceil(2 * L2_BYTES / nbytes))]
        before = rmsnorm_cuda.launches
        ms = device_ms(torch, [lambda x=x: rmsnorm_cuda(x, w, eps) for x in xs], 50)
        plain = device_ms(torch, [lambda x=x: rmsnorm_torch(x, w, eps) for x in xs], 20)
        lib = device_ms(torch, [lambda x=x: F.rms_norm(x, (d,), w, eps) for x in xs], 50)
        rmsnorm_cuda.launches = before  # timing launches are not a path's
        bms, by = bound_ms(2 * nbytes + 2 * d, 0, "bfloat16")
        times[label] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by)
        log(f"[rmsnorm] time ({rows}, {d}) bf16 (device time): kernel={ms:.5f} ms"
            f" plain={plain:.5f} ms F.rms_norm={lib:.5f} ms bound={bms:.5f} ms ({by});"
            f" {len(xs)} inputs cycled")
    return max_err, times["train"], times["decode"]


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
            else:
                K1_HELD.add(k1_key(p, q, blocks))
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
    library = sum(rows[(lbl, kind)][2] * c for lbl, c in per_layer.items()
                  for kind in ("fwd bf16", "dA f32", "dB f32"))
    log(f"[K1 train] one step's 75 K1 launches at these times: "
        f"{sum(step.values()):.1f} ms (fwd {step['fwd bf16']:.1f}, dA {step['dA f32']:.1f},"
        f" dB {step['dB f32']:.1f}); torch.matmul (TF32 off) on the same 75 products"
        f" {library:.1f} ms; bound {sum(bound.values()):.1f} ms")
    check(not failed, f"K1 at the training shapes differs from its plain version: {failed}")

    # [train_dp]'s products, on the blocks the planner resolves for each
    # (the autotuner's, memoized for the run: [train_dp] and its ranks plan
    # the same ones), at the limits above; those the timings held already
    # are not run again.
    def planned(rows, t, k, n):
        x = torch.empty(rows, t, k, dtype=torch.bfloat16, device="cuda")
        w = torch.empty(k, n, dtype=torch.bfloat16, device="cuda")
        spec = api.GemmSpec.from_operands(x, w, epilogue=api.Epilogue(), out_dtype=x.dtype,
                                          blocks=(None, None, None))
        return api.plan(spec, backend="cuda_mesh", device="cuda").blocks

    ran = 0
    for label, a_shape, b_shape, dt, (bm, bn, bk) in dp_products(planned):
        dtype = getattr(torch, dt)
        p, q = rnd(*a_shape, dtype=dtype), rnd(*b_shape, dtype=dtype)
        kw = dict(block_m=bm, block_n=bn, block_k=bk, out_dtype=dtype)
        key = k1_key(p, q, kw)
        if key in K1_HELD:
            continue
        out, ref = mesh_matmul(p, q, **kw).float(), mesh_matmul_torch(p, q, **kw).float()
        err = (out - ref).abs().max().item()
        tol = (1e-5 if dt == "float32" else 2.0**-7) * ref.abs().max().item()
        max_err, ran = max(max_err, err), ran + 1
        tile = tile_config(a_shape[0], b_shape[1], a_shape[1], bm, bn, bk, dtype)
        log(f"[K1 train] [train_dp] {label:28s} {a_shape[0]}x{a_shape[1]}x{b_shape[1]}"
            f" blocks {(bm, bn, bk)} {tile}: err={err:.3e} tol={tol:.3e}")
        if not (err <= tol and bool(torch.isfinite(out).all())) or tile in OLD_TILES:
            failed.append(f"[train_dp] {label} blocks {(bm, bn, bk)} {tile}: err {err} > {tol}")
        else:
            K1_HELD.add(key)
        del p, q, out, ref
    log(f"[K1 train] [train_dp]'s products: {ran} checked here, the rest held above")
    check(not failed, f"K1 at [train_dp]'s shapes differs from its plain version: {failed}")

    # [train_rwkv]'s and [train_zamba]'s calls, forward and backward, on the
    # blocks the planner resolves for their forward products.
    keys = family_train_products(lambda m, k, n: planned(1, m, k, n))
    here, before = hold_k1_keys(torch, "K1 train", keys)
    log(f"[K1 train] [train_rwkv]'s and [train_zamba]'s {len(keys)} K1 calls (forward, z"
        f" recomputed where an activation is fused, dA, dB): {here} checked here, {before}"
        " held above")

    # mesh-paper's step on the blocks the planner resolves (the run's timed
    # autotuner), at a DP rank's 2048 rows and the full batch's 4096: each
    # product's kernel time times its launches a step.
    planner_step = {}
    for m in (TRAIN_SEQ, TRAIN_BATCH * TRAIN_SEQ):
        total, used = {"fwd bf16": 0.0, "dA f32": 0.0, "dB f32": 0.0}, {}
        for label, (k, n) in MESH_PAPER_GEMMS.items():
            bm, bn, bk = planned(1, m, k, n)
            used[label] = (bm, bn, bk)
            x, w = rnd(m, k), rnd(k, n)
            dz, w_t, x_t = rnd(m, n).float(), w.t().float().contiguous(), x.t().float().contiguous()
            work = {"fwd bf16": (x, w, dict(block_m=bm, block_n=bn, block_k=bk)),
                    "dA f32": (dz, w_t, dict(block_m=bm, block_n=bk, block_k=bn)),
                    "dB f32": (x_t, dz, dict(block_m=bk, block_n=bn, block_k=bm))}
            for kind, (p, q, blocks) in work.items():
                iters = 3 if kind != "fwd bf16" else 10
                ms = time_ms(torch, [lambda p=p, q=q, b=blocks: mesh_matmul(p, q, **b)], iters,
                             warmup=1)
                total[kind] += ms * per_layer[label]
            del x, w, dz, w_t, x_t
        planner_step[m] = dict(ms=sum(total.values()), **total, blocks=used)
        log(f"[K1 train] one mesh-paper step's 75 K1 launches at M = {m} on the planner's"
            f" blocks {used}: {sum(total.values()):.1f} ms (fwd {total['fwd bf16']:.1f}, dA"
            f" {total['dA f32']:.1f}, dB {total['dB f32']:.1f})")
    K1_HELD_BY.add("k1_bwd")
    return max_err, dict(ms=sum(step.values()), library_ms=library,
                         bound_ms=sum(bound.values()), shape="one mesh-paper train step's"
                         " 75 products at M = 4096 (25 bf16 forward, 50 f32 backward) on 128^3"
                         " blocks", planner_blocks={
                             str(m): {k: (v if k != "blocks" else {lb: list(b) for lb, b in
                                                                  v.items()})
                                      for k, v in r.items()} for m, r in planner_step.items()})


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
    # [serve_tp]'s expert parallelism: a rank's 32 of OLMoE's 64 experts (its
    # half of the routed sizes) at the same decode and prefill rows.
    ep = OLMOE_EXPERTS // TP_RANKS
    for phase, (rpg, bm) in K5_SHAPES.items():
        edge = rng.integers(0, rpg + 1, ep).astype(np.int32)
        edge[:3] = (0, rpg, rpg // 2)
        for label, (k, n) in K5_GEMMS.items():
            for how, sizes in (("edge sizes", edge), ("routed", routed[phase][ep:])):
                cases.append((f"EP rank {phase} {label} {how}", ep, rpg, bm, k, n, sizes,
                              torch.bfloat16, {}))
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
        kw = dict(kw, block_m=bm, block_n=128, block_k=128)
        sizes = torch.as_tensor(sizes_np, device="cuda")
        tokens, w = rnd(grp * rpg, k, dtype=dtype), rnd(grp, k, n, dtype=dtype)
        if kw.pop("bias", False):
            kw["bias"] = rnd(grp, n, dtype=dtype)
        if kw.pop("residual", False):
            kw["residual"] = rnd(grp * rpg, n, dtype=dtype)
        err, bad, line = _k5_case(torch, "K5", f"{label:30s}", tokens, sizes, w, kw)
        log(line)
        if bad:
            failed.append(f"{label} {dtype}: {'; '.join(bad)}")
        max_err = max(max_err, err)
        del tokens, w, kw
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


def _k5_case(torch, tag, label, tokens, sizes, w, kw):
    """One launch of K5 (grouped_mesh_matmul(tokens, sizes, w, **kw))
    against grouped_mesh_matmul_torch: (max |d|, the failures, a log
    line)."""
    from repro_torch.kernels import grouped as gr
    from repro_torch.kernels.grouped import grouped_mesh_matmul, grouped_mesh_matmul_torch

    grp, k, n = w.shape
    rpg, dtype, bm = tokens.shape[0] // grp, tokens.dtype, kw["block_m"]
    want = gr.tile_config(n, k, bm, kw["block_n"], kw["block_k"], dtype)
    before = dict(grouped_mesh_matmul.launches_by_config)
    out = grouped_mesh_matmul(tokens, sizes, w, **kw)
    ran = [c for c, x in grouped_mesh_matmul.launches_by_config.items() if x != before.get(c, 0)]
    ref = grouped_mesh_matmul_torch(tokens, sizes, w, **kw)
    torch.cuda.synchronize()
    valid = torch.arange(rpg, device="cuda")[None, :] < sizes[:, None]  # (G, rpg)
    nonzero = int(torch.count_nonzero(out.reshape(grp, rpg, n)[~valid]))
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
    line = (f"[{tag}] {label} {str(dtype)[6:]:8s} G={grp} rpg={rpg} bm={bm} K={k} N={n}"
        f" on {want}: non-empty={int((sizes > 0).sum())} masked rows nonzero={nonzero}"
        f" err={err:.3e} tol={tol:.3e} ({why}): " + ("FAIL " + "; ".join(bad) if bad else "ok"))
    return err, bad, line


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


def _flash_work(b, t, h, kvh, hd, size, causal=True):
    """(bytes, FLOPs) K6 needs: Q, K, V read and O written once; two
    hd-long products per (query, key) pair the mask keeps, t (t + 1) / 2 a
    head when causal, t^2 when not."""
    pairs = t * (t + 1) // 2 if causal else t * t
    return size * (2 * b * t * h * hd + 2 * b * t * kvh * hd), 4 * b * h * hd * pairs


def phase_k6(torch):
    """K6 (flash_attention_cuda) against flash_attention_torch at the shapes
    the serving and training paths give it, in bf16 (as they run: the
    tensor-core kernel) and f32 (the SIMT kernel, where the two agree to
    summation order), and causal with Tq != Tk (the reference's top-left
    mask), causal at a query offset (a context-parallel rank's block of
    rows: [serve_tp]'s Qwen2-7B rank 1, and ragged offsets), and non-causal
    at Whisper's encoder shape, then timings: the
    kernel (CUDA events and profiler device time), the plain version, SDPA
    (causal or full, GQA; timed here only) and the bound.
    Every case is checked before a failure is raised, so one run shows which
    cases a fault breaks."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_torch

    g = torch.Generator(device="cuda").manual_seed(7)
    h, kvh, hd = QWEN_HEADS
    bf16, f32 = torch.bfloat16, torch.float32
    blocks = (QWEN_CHUNK, QWEN_CHUNK)
    qwen, mesh = (1, 2048, h, kvh, hd), (TRAIN_BATCH, TRAIN_SEQ, 16, 16, 128)
    whisper, zamba = (2, WHISPER_FRAMES, 16, 16, 64), (2, ZAMBA_PROMPT, 32, 32, 64)
    # label, (B, Tq, H, KV, hd), Tk (None: Tq), causal, dtype, (block_q, block_k)
    # [, q_offset]
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
        # The other families' shapes: Whisper's encoder (full attention, no
        # causal mask) and Zamba2's shared block (causal, rep 1, hd 64).
        ("whisper encoder T=2048", whisper, None, False, bf16, blocks),
        ("whisper encoder T=2048", whisper, None, False, f32, blocks),
        ("zamba shared block T=2048", zamba, None, True, bf16, blocks),
        # Pixtral-12B's prefill (prompt + patches 2048-4096, rep 4, hd 128).
        ("pixtral prefill T=2048", (1, 2048, *PIXTRAL_HEADS), None, True, bf16, blocks),
        ("pixtral prefill T=2048", (1, 2048, *PIXTRAL_HEADS), None, True, f32, blocks),
        ("pixtral prefill T=4096", (1, 4096, *PIXTRAL_HEADS), None, True, bf16, blocks),
        ("pixtral prefill T=4096", (1, 4096, *PIXTRAL_HEADS), None, True, f32, blocks),
        # [serve_tp]'s context-parallel Qwen2-7B prefill: rank 1's rows
        # [1024, 2048) over all 28 heads against keys [0, 2048).
        ("qwen2-7b seq_attn rank 1", (1, TP_QWEN_PROMPT // TP_RANKS, h, kvh, hd),
         TP_QWEN_PROMPT, True, bf16, blocks, TP_QWEN_PROMPT // TP_RANKS),
        ("qwen2-7b seq_attn rank 1", (1, TP_QWEN_PROMPT // TP_RANKS, h, kvh, hd),
         TP_QWEN_PROMPT, True, f32, blocks, TP_QWEN_PROMPT // TP_RANKS),
        ("q_offset 100 rep=3 ragged", (1, 200, 6, 2, 64), 300, True, bf16, (8, 50), 100),
        ("q_offset 100 rep=3 ragged", (1, 200, 6, 2, 64), 300, True, f32, (8, 50), 100),
        ("q_offset 37 rep=1 past Tk", (2, 96, 8, 8, 128), 64, True, bf16, (32, 32), 37),
    ]
    max_err, failed = 0.0, []
    for label, (b, t, hq, kv, d), tk, causal, dtype, (bq, bk), *offset in cases:
        tk, off = (t if tk is None else tk), (offset or [0])[0]
        q = torch.randn(b, t, hq, d, generator=g, device="cuda").to(dtype)
        k, v = (torch.randn(b, tk, kv, d, generator=g, device="cuda").to(dtype) for _ in "kv")
        out = flash_attention_cuda(q, k, v, causal=causal, q_offset=off)
        ref = flash_attention_torch(q, k, v, causal=causal, block_q=bq, block_k=bk, q_offset=off)
        torch.cuda.synchronize()
        got = disagreement(torch, out, ref)
        lim = K6_LIMITS[str(dtype).removeprefix("torch.")]
        bad = [f"{name} {got[name]:.3e} > {x:.3e}" for name, x in lim.items()
               if not got[name] <= x]
        if not bool(torch.isfinite(out.float()).all()):
            bad.append("non-finite output")
        kernel = "mma.sync" if dtype == bf16 else "SIMT f32"
        log(f"[K6] {label:30s} {str(dtype)[6:]:8s} Tq={t} Tk={tk} causal={causal}"
            f" q_offset={off} blocks=({bq},{bk}) on {kernel}: "
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
    timed = (("qwen2 T=2048", qwen, True), ("qwen2 T=4096", (1, 4096, h, kvh, hd), True),
             ("mesh-paper train", mesh, True), ("whisper encoder", whisper, False),
             ("zamba shared block", zamba, True))
    for label, (b, t, hq, kv, d), causal in timed:
        q = torch.randn(b, t, hq, d, generator=g, device="cuda").to(bf16)
        k, v = (torch.randn(b, t, kv, d, generator=g, device="cuda").to(bf16) for _ in "kv")
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        gqa = dict(enable_gqa=True) if hq != kv else {}
        call = [lambda: flash_attention_cuda(q, k, v, causal=causal)]
        ms = time_ms(torch, call, 10)
        dev = device_ms(torch, call, 10)
        plain = time_ms(torch, [lambda: flash_attention_torch(
            q, k, v, causal=causal, block_q=QWEN_CHUNK, block_k=QWEN_CHUNK)], 3, warmup=1)
        lib_call = [lambda: sdpa(qt, kt, vt, is_causal=causal, **gqa)]
        lib = time_ms(torch, lib_call, 20)
        lib_dev = device_ms(torch, lib_call, 20)
        nbytes, flops = _flash_work(b, t, hq, kv, d, 2, causal)
        bms, by = bound_ms(nbytes, flops, "bfloat16")
        mask = "causal" if causal else "full"
        per[label] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by,
                          device_ms=dev, library_device_ms=lib_dev,
                          shape=f"B={b} T={t} H={hq} KV={kv} hd={d} bf16 {mask}")
        log(f"[K6] time {label:18s} B={b} T={t} H={hq} KV={kv} hd={d} bf16 {mask}:"
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
                   same_routing: bool = False, steps=None):
    """Teacher-forced decode of the server's tokens `served[:7]` after a
    `t_prompt`-token prefill's `caches`: paged (K4) against dense (`_sdpa`).
    With `same_routing`, each paged step replays the dense step's MoE
    routing, so the two differ in the attentions' roundings only.  Returns
    the largest |dlogit|, the largest gap of a server token below the dense
    argmax, and the largest dense |logit|; each step's largest |dlogit| is
    appended to the list `steps` where one is given."""
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
            diff = (lg_d - lg_p).abs().max().item()
            worst_diff = max(worst_diff, diff)
            if steps is not None:
                steps.append(diff)
            worst_gap = max(worst_gap, (lg_d.max() - lg_d[served[i + 1]]).item())
            scale = max(scale, lg_d.abs().max().item())
    return worst_diff, worst_gap, scale


def profile_window(torch, model, params, scfg, prompts, tag: str = "profile",
                   new_tokens: int = NEW_TOKENS) -> None:
    """Where the serving time goes: one more run (4 requests, one wave of
    prefills then decode ticks) under torch.profiler, reporting device time
    by kernel and the device-busy share of the window's wall time.  The
    profiler's own host cost makes the busy share a lower bound."""
    from repro_torch.launch.scheduler import ContinuousBatchingServer, Request

    server = ContinuousBatchingServer(model, params, scfg, device="cuda")
    reqs = [Request(rid=f"prof{i}", prompt=p, max_new_tokens=new_tokens)
            for i, p in enumerate(prompts)]
    profile_call(torch, lambda: server.run(reqs), tag,
                 lambda: f"{len(reqs)} requests x {new_tokens} tokens,"
                         f" {server.counters['ticks']} ticks")


def profile_call(torch, fn, tag: str, what) -> None:
    """`fn()` under torch.profiler: device time by kernel and by class, and
    the device-busy share of the window's wall time (a lower bound: the
    profiler adds host cost).  `what()` names the window in the log."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    rows = kernel_rows(prof)
    busy_us = sum(r[0] for r in rows)
    log(f"[{tag}] {what()}: wall={wall_us / 1e3:.1f} ms device busy={busy_us / 1e3:.1f} ms "
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
    profile_window(torch, model, params, scfg, prompts[:SLOTS], tag="profile serve_moe",
                   new_tokens=PROFILE_TOKENS)
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
    # requests, free-running (each path routes for itself: held at the
    # steps with no flipped routing set, and the flips counted) and on the
    # dense step's routing (the attentions' roundings only).
    worst = {"free": 0.0, "gap": 0.0, "same": 0.0}
    flipped, clean_steps = 0, 0
    for i in range(QMOE_CHECKED):
        tokens_i = results[f"req{i}"].tokens
        with torch.inference_mode():
            prompt_i = torch.as_tensor(prompts[i], device="cuda")[None]
            _, caches = prefill(params, {"tokens": prompt_i})
        per_step = []
        with routing() as routes:
            free, gap, scale = paged_vs_dense(torch, model, params, caches, tokens_i, PROMPT,
                                              steps=per_step)
        flips = routing_flips(torch, routes, QMOE_LAYERS)
        clean = [d for d, f in zip(per_step, flips) if f == 0]
        same, _, _ = paged_vs_dense(torch, model, params, caches, tokens_i, PROMPT,
                                    same_routing=True)
        del caches
        flipped += sum(flips)
        clean_steps += len(clean)
        worst = {"free": max([worst["free"], *clean]), "gap": max(worst["gap"], gap),
                 "same": max(worst["same"], same)}
        log(f"[serve_qwen2_moe] req{i} teacher-forced paged-vs-dense max |dlogit|: free-running"
            f" {max(clean, default=0.0):.4f} at the {len(clean)} of {len(flips)} steps with no"
            f" flipped routing set (tol {QMOE_LOGIT_TOL}; every step {free:.4f}, not held;"
            f" per step {[round(d, 4) for d in per_step]}; (step, layer) routing sets that"
            f" differ: {flips} of {QMOE_LAYERS} per step), on the dense routing {same:.4f} (tol"
            f" {QMOE_SAME_ROUTING_TOL}); max |logit| {scale:.3f}; worst server-token gap to the"
            f" dense argmax {gap:.4f} (tol {QMOE_LOGIT_TOL})")
    log(f"[serve_qwen2_moe] free-running: {flipped} of {QMOE_CHECKED * 7 * QMOE_LAYERS}"
        f" (step, layer) routing sets flipped (tol {QMOE_FLIP_TOL}); {clean_steps} steps with"
        f" none, max |dlogit| there {worst['free']:.4f} (tol {QMOE_LOGIT_TOL})")
    check(clean_steps > 0, "no teacher-forced step without a flipped routing set")
    check(flipped <= QMOE_FLIP_TOL, f"{flipped} routing sets flipped (tol {QMOE_FLIP_TOL})")
    check(worst["free"] <= QMOE_LOGIT_TOL, f"paged vs dense logits differ by {worst['free']}")
    check(worst["gap"] <= QMOE_LOGIT_TOL, f"server token {worst['gap']} below the dense argmax")
    check(worst["same"] <= QMOE_SAME_ROUTING_TOL,
          f"paged vs dense logits on the same routing differ by {worst['same']}")
    del server
    _free(torch)
    profile_window(torch, model, params, scfg, prompts[:PROFILE_REQUESTS],
                   tag="profile serve_qwen2_moe", new_tokens=PROFILE_TOKENS)
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
    nk, nt, nr = norm(gk), norm(gt), norm(gr)

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
        f" ({100 * abs(nk - nt) / nt:.4f} %, free-running: tol {100 * MOE_TRAIN_FREE_NORM_TOL:g} %);"
        f" per-parameter ||d||/||g||"
        f" largest: {top}")
    # A pair routed elsewhere moves every later pair's rank in two experts,
    # so which pairs the capacity drops changes too: the grad norm and the
    # per-parameter gradients are held with the torch step replaying the
    # kernel step's routing, where only the GEMMs' roundings differ; the
    # free-running grad norm is held at MOE_TRAIN_FREE_NORM_TOL.
    log(f"[train_moe] the same, the torch step on the kernel step's routing: grad norm"
        f" {nk:.5f} vs {nr:.5f} ({100 * abs(nk - nr) / nr:.4f} %, tol 0.1 %); per-parameter"
        f" ||d||/||g|| largest: {top_same} (tol 0.05)")
    check(sum(dropped) > 0, "no pair was dropped: the capacity path did not run")
    check(abs(float(lk) - float(lt)) <= 1e-3, f"kernel loss {float(lk)} vs torch {float(lt)}")
    check(abs(nk - nr) <= 1e-3 * nr, f"kernel grad norm {nk} vs torch on its routing {nr}")
    check(abs(nk - nt) <= MOE_TRAIN_FREE_NORM_TOL * nt,
          f"free-running kernel grad norm {nk} vs torch {nt} (tol {MOE_TRAIN_FREE_NORM_TOL})")
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

    # MOE_TRAIN_STEPS steps through train_loop with the asynchronous writer
    # every 2 steps.  Each submit runs under the sync debug mode and is
    # timed, with the part it waited for the previous write (`waited_s`);
    # just before the step-MOE_HELD_CKPT submit a synchronous .cpu() copy of
    # the state is taken.  Before the last step (whose save lets the manager
    # drop the held one: keep_n=1 bounds the disk), the phase waits for the
    # held write and restores it.
    per_step, sync_copy, restored, submits = [], {}, {}, []
    del state, step_fn, data
    _free(torch)
    cfg = dataclasses.replace(cfg, num_layers=MOE_CKPT_LAYERS)
    step_fn, state, data = build_trainer(cfg, **kw)
    log(f"[train_moe] the steps and checkpoints below at {MOE_CKPT_LAYERS} of its layers: train"
        f" state {sum(t.numel() * t.element_size() for t in tree_leaves(state)) / 2**30:.2f}"
        " GiB a write")

    def submit(step, tree, meta=None):
        if step != MOE_HELD_CKPT:  # one write, the held one (MOE_CKPT_LAYERS)
            return
        sync_copy.update(tree_map(lambda t: t.detach().to("cpu", copy=True), tree))
        t0 = time.monotonic()
        no_host_sync(torch, lambda: shipped_submit(step, tree, meta))
        submits.append((step, time.monotonic() - t0, writer.waited_s))

    def timed(st, b):
        if len(per_step) == MOE_TRAIN_STEPS - 1:
            writer.wait()
            restored.update(ckpt.restore(MOE_HELD_CKPT, sync_copy))
            restored["data_step"] = ckpt.meta(MOE_HELD_CKPT)["data_step"]
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
        state = train_loop(timed, state, data, LoopConfig(total_steps=MOE_TRAIN_STEPS,
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
        log(f"[train_moe] {MOE_TRAIN_STEPS} steps: wall={wall:.3f} s with the writes (the last"
            f" write's wait {time.monotonic() - t_close:.1f} s); checkpoints kept"
            f" {ckpt.all_steps()}")
        for step, dt, waited in submits:
            log(f"[train_moe] submit at step {step} under set_sync_debug_mode('error'), 0 host"
                f" syncs: {1e3 * dt:.1f} ms, of which {1e3 * waited:.1f} ms waiting for the"
                f" previous write, {1e3 * (dt - waited):.1f} ms the snapshot"
                + (" (the first: pinned buffers allocated)" if step == 2 else ""))
        check(len(losses) == MOE_TRAIN_STEPS and all(math.isfinite(x) for x in losses),
              f"non-finite or missing losses: {losses}")
        check(losses[-1] < losses[0], f"loss did not fall: {losses}")
        want_k1 = 3 * (4 * cfg.num_layers + 1)
        want_k5 = 3 * 2 * cfg.num_layers
        check(all((k1, k5) == (want_k1, want_k5) for _, k1, k5 in per_step),
              f"per-step launches {per_step}, want K1 {want_k1} K5 {want_k5} under dots")

    # The held checkpoint restores equal, bit for bit, to the copy taken at
    # its submit; resuming from it gives the later steps' losses.
    del state
    _free(torch)
    data_step = restored.pop("data_step")
    unequal = [p for (p, a), (_, b) in zip(tree_paths(restored), tree_paths(sync_copy))
               if not (a.dtype == b.dtype and torch.equal(a, b))]
    check(not unequal, f"step-{MOE_HELD_CKPT} checkpoint differs from the state at its"
                       f" submit: {unequal}")
    sync_copy.clear()
    resumed = tree_map(lambda t: t.to("cuda"), restored)
    restored.clear()
    data.restore(data_step)
    relog = MetricsLogger()
    train_loop(step_fn, resumed, data, LoopConfig(total_steps=MOE_TRAIN_STEPS, log_every=1),
               logger=relog)
    again = [h["loss"] for h in relog.history]
    later = losses[MOE_HELD_CKPT:]
    gaps = [abs(a - b) for a, b in zip(again, later)]
    log(f"[train_moe] step-{MOE_HELD_CKPT} checkpoint restores bit for bit; resumed steps"
        f" {MOE_HELD_CKPT + 1}-{MOE_TRAIN_STEPS} losses {[round(x, 6) for x in again]} vs"
        f" {[round(x, 6) for x in later]} (|d| {gaps}, tol 1e-3)")
    check(len(again) == len(later) and max(gaps) <= 1e-3, f"resumed losses {again} vs {later}")
    profile_train_step(torch, step_fn, resumed, data, tag="profile train_moe")
    del resumed, step_fn
    _free(torch)

    # Each policy's step: time, peak memory and launches.
    cfg = dataclasses.replace(cfg, num_layers=MOE_TRAIN_LAYERS)
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
        return loss.detach(), torch.autograd.grad(loss, tree_leaves(ps), allow_unused=True,
                                                  materialize_grads=True)


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

        def capture(p, x, cfg_, *ctx):
            seen.append(x)
            return original(p, x, cfg_, *ctx)

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


# -- the other four families (RWKV-6, Pixtral, Zamba2, Whisper) ---------------

# RWKV-6 1.6B through tuned() on the kernel path: K1 runs every projection
# (8 a layer: wr, wk, wv, wg with silu, wo; cm_wk with relu, cm_wv, cm_wr
# with sigmoid) and the head, in a prefill and in a decode step alike.
RWKV_LAYERS = 24
RWKV_STEP_LAUNCHES = 8 * RWKV_LAYERS + 1
# The GEMMs of the three kernel-path phases, label: (K, N, fused epilogue,
# the M each runs at), for [K1]'s cases.  RWKV-6: M = 1 (the 1-slot server
# and generate), SLOTS (the 4-slot decode) and PROMPT (a prefill).
RWKV_GEMMS = {
    "wr|wk|wv|wo": (2048, 2048, {}, (1, SLOTS, PROMPT)),
    "wg silu": (2048, 2048, dict(activation="silu"), (1, SLOTS, PROMPT)),
    "cm_wk relu": (2048, 7168, dict(activation="relu"), (1, SLOTS, PROMPT)),
    "cm_wv": (7168, 2048, {}, (1, SLOTS, PROMPT)),
    "cm_wr sigmoid": (2048, 2048, dict(activation="sigmoid"), (1, SLOTS, PROMPT)),
    "head": (2048, 65536, {}, (1, SLOTS, PROMPT)),
}
# Pixtral-12B through tuned() (the `torch` backend, as published), served
# on pages: prompt + 256 stub patches is 2048, 3072 or 4096, a multiple of
# attn_chunk 1024, so every prefill takes K6; decode runs K4 at GQA rep 4.
PIXTRAL_LAYERS, PIXTRAL_PATCHES, PIXTRAL_NEW_TOKENS = 40, 256, 16
PIXTRAL_PROMPTS = (1792, 2816, 3840, 3840)
PIXTRAL_HEADS = (32, 8, 128)  # query heads, KV heads, head dim
# [K4]'s case at its decode: (slots, heads, KV heads, head dim), contexts
# of prompt + patches + 8 tokens, as in the middle of the phase's decode.
PIXTRAL_DECODE = (SLOTS, *PIXTRAL_HEADS)
PIXTRAL_LIVE = [t + PIXTRAL_PATCHES + 8 for t in PIXTRAL_PROMPTS]
# Zamba2-1.2B through tuned() on the kernel path, served through `generate`
# (the family is not schedulable): 38 Mamba2 layers (in_proj, out_proj on
# K1), 38 // 6 = 6 applications of the shared block (q, k, v, o, wi, wo on
# K1; its attention on K6 in a 2048-token prefill) and a 2-layer tail.
ZAMBA_LAYERS, ZAMBA_APPS, ZAMBA_PROMPT, ZAMBA_NEW_TOKENS = 38, 6, 2048, 16
ZAMBA_STEP_LAUNCHES = 2 * ZAMBA_LAYERS + 6 * ZAMBA_APPS + 1
# Zamba2's: M = 2 (a decode step of 2 prompts) and 2 x 2048 (the prefill);
# in_proj's N = 2 d_in + 2 n + heads = 8384 is not a multiple of 128.
ZAMBA_MS = (2, 2 * ZAMBA_PROMPT)
ZAMBA_GEMMS = {
    "in_proj": (2048, 8384, {}, ZAMBA_MS),
    "out_proj": (4096, 2048, {}, ZAMBA_MS),
    "shared wq|wk|wv|wo": (2048, 2048, {}, ZAMBA_MS),
    "shared wi": (2048, 2 * 8192, {}, ZAMBA_MS),
    "shared wo": (8192, 2048, {}, ZAMBA_MS),
    "head": (2048, 32000, {}, ZAMBA_MS),
}
# Whisper-medium through tuned() on the kernel path: 2 x 2048 seeded frames
# (the encoder's full attention on K6, non-causal, once a layer) and a
# 256-token decoder prompt.  K1: the encoder's frame_proj and 6 a layer; the
# decoder's 10 a layer (self q, k, v, o; cross q, o; cross k, v from enc_out,
# recomputed every step as in the reference; wi, wo) and the head.
WHISPER_LAYERS, WHISPER_FRAMES, WHISPER_PROMPT, WHISPER_NEW_TOKENS = 24, 2048, 256, 16
WHISPER_ENC_LAUNCHES = 1 + 6 * WHISPER_LAYERS
WHISPER_DEC_LAUNCHES = 10 * WHISPER_LAYERS + 1
# Whisper's: the encoder's at M = 2 x 2048 frames (frame_proj, attention,
# MLP, and every decode step's cross K/V), the decoder's at M = 2 x 256 (the
# prefill) and 2 (a decode step).
WHISPER_MS = (2, 2 * WHISPER_PROMPT, 2 * WHISPER_FRAMES)
WHISPER_GEMMS = {
    "frame_proj|wq|wk|wv|wo": (1024, 1024, {}, WHISPER_MS),
    "wi": (1024, 2 * 4096, {}, WHISPER_MS),
    "wo": (4096, 1024, {}, WHISPER_MS),
    "head": (1024, 51968, {}, WHISPER_MS[:2]),
}
# [train_rwkv]'s forward: RWKV-6's GEMMs at M = 2 x 2048 ([train_zamba]'s
# are ZAMBA_GEMMS' prefill M).
RWKV_TRAIN_GEMMS = {label: (k, n, kw, (TRAIN_BATCH * TRAIN_SEQ,))
                    for label, (k, n, kw, _) in RWKV_GEMMS.items()}
K1_PATH_GEMMS = {"serve_rwkv": RWKV_GEMMS, "serve_zamba": ZAMBA_GEMMS,
                 "train_rwkv": RWKV_TRAIN_GEMMS, "train_zamba": ZAMBA_GEMMS,
                 "serve_whisper": WHISPER_GEMMS}
# New tokens in the four phases' profiled windows.
PROFILE_TOKENS = 8
# The profiler's processing of an eager window grows with its host events:
# [serve_moe]'s and [serve_qwen2_moe]'s windows (32 tokens before) took
# 55 s and about 85 s of their phases, [serve_rwkv]'s 8-token one 36 s; the
# windows are cut to PROFILE_TOKENS and RWKV_PROFILE_TOKENS tokens a request,
# and [serve_qwen2_moe]'s and [serve_rwkv]'s to PROFILE_REQUESTS requests
# (SLOTS before: their 4 eager prefills' events still took 36 and 31 s).
RWKV_PROFILE_TOKENS = 4
PROFILE_REQUESTS = 2
# Limits of the four phases' logit checks, each about 3x its first reading
# (bf16 unless named f32).  RWKV's chunked WKV against the scan at T = 128:
# 0.2622 on logits up to 4.59 in bf16 (the two forms round the state
# differently, over 24 layers); 2.663e-04 with f32 weights.  Pixtral's K6
# prefill against the plain chunked path:
# 0.5703 on logits up to 8.19 (40 layers; Qwen2-7B's 28 read 0.35); its
# paged decode against dense 0.3838.  Zamba2's prefill and decode against
# forward: 0.0977 and 0.1016.  Whisper's: 0.0635 and 0.0664.  Zamba2's
# ssd_chunked against ssd_scan in f32 keeps tests/test_ssd.py's limit.
RWKV_CHUNKED_TOL, RWKV_CHUNKED_F32_TOL = 0.8, 8e-4
# Tokens of each 4-slot request held against its own teacher-forced decode
# (8 until the run needed the time for [train_sp]; every request is still
# held, req4-7 on reused slots).
RWKV_CHECKED_TOKENS = 4
PIXTRAL_K6_CHUNKED_TOL, PIXTRAL_LOGIT_TOL = 1.7, 1.15
ZAMBA_LOGIT_TOL, ZAMBA_SSD_F32_TOL = 0.3, 2e-4
WHISPER_LOGIT_TOL = 0.2


def _init_full_width(torch, tag, cfg):
    """The model of `cfg` with random weights from seed 0 on the card, its
    parameter count and memory logged."""
    from repro_torch.models import get_model
    from repro_torch.tree import tree_leaves

    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    model = get_model(cfg)
    t0 = time.monotonic()
    params = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"[{tag}] {cfg.arch_id} init: {n_params / 1e9:.3f} B parameters,"
        f" {torch.cuda.memory_allocated() / 2**30:.2f} GiB, {time.monotonic() - t0:.1f} s")
    return model, params


def _max_diff(torch, a, b, vocab: int) -> float:
    """max |a - b| over the real vocab rows (padded rows read -1e30 on both)."""
    return (a[..., :vocab].float() - b[..., :vocab].float()).abs().max().item()


def phase_serve_rwkv(torch):
    """Full-width RWKV-6 1.6B on the kernel path through the server's
    stacked-state path: the serve phase's requests, K1's launches against
    the server's counters, 0 host syncs in a decode step, the tokens of a
    1-slot server against `generate`, and the chunked WKV's prefill logits
    against the scan's, in bf16 and with f32 weights."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.mesh_matmul import mesh_matmul
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    from repro_torch.launch.scheduler import ContinuousBatchingServer, Request, ServeConfig
    from repro_torch.launch.serve import generate
    from repro_torch.models import get_model
    from repro_torch.tree import tree_map

    published = get_config("rwkv6-1.6b")
    cfg = dataclasses.replace(published.tuned(), use_mesh_kernel=True)
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.head_dim_, cfg.d_ff, cfg.vocab_size,
           cfg.wkv_chunked, cfg.wkv_chunk, cfg.attn_chunk, cfg.param_dtype)
          == (RWKV_LAYERS, 2048, 32, 64, 7168, 65536, True, 16, 0, "bfloat16"),
          f"unexpected RWKV-6 config {cfg}")
    model, params = _init_full_width(torch, "serve_rwkv", cfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, PROMPT).astype(np.int32) for _ in range(REQUESTS)]
    scfg = ServeConfig(max_slots=SLOTS, queue_capacity=REQUESTS, warmup_prompt_lens=(PROMPT,))

    reset_k1(mesh_matmul)
    flash_attention.launches = paged_attention_cuda.launches = 0
    server = ContinuousBatchingServer(model, params, scfg, device="cuda")
    check(server.pools is None and server.state["wkv"].shape == (RWKV_LAYERS, SLOTS, 32, 64, 64),
          "the RWKV server is not on its stacked-state path")
    server.warmup()
    reqs = [Request(rid=f"req{i}", prompt=p, max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with k1_products("serve_rwkv"):
        results = server.run(reqs)
        torch.cuda.synchronize()
    wall = time.monotonic() - t0
    check_main_path_tiles("serve_rwkv", tile_counts(mesh_matmul), canary=True)
    for r in reqs:
        res = results[r.rid]
        check(res.status == "ok" and len(res.tokens) == NEW_TOKENS,
              f"{r.rid}: {res.status} with {len(res.tokens)} tokens ({res.reason})")
    c = server.counters
    launches = {"mesh_matmul": mesh_matmul.launches,
                "flash_attention": flash_attention.launches,
                "paged_attention": paged_attention_cuda.launches}
    want = {"mesh_matmul": RWKV_STEP_LAUNCHES * (c["prefills"] + c["decode_steps"]) + 2,
            "flash_attention": 0, "paged_attention": 0}
    generated = sum(len(results[r.rid].tokens) for r in reqs)
    log(f"[serve_rwkv] {REQUESTS} requests x {NEW_TOKENS} tokens on {SLOTS} slots: wall="
        f"{wall:.3f} s tokens/s={generated / wall:.1f} ticks={c['ticks']} prefills="
        f"{c['prefills']} decode steps={c['decode_steps']} (warmup included) launches="
        f"{launches} expected={want} ({RWKV_STEP_LAUNCHES} a step, +2 the canary); peak"
        f" device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(launches == want, f"launches {launches} != {want} from the server's counters")

    # No host sync in one decode step of the stacked state.
    zeros = torch.zeros((SLOTS, 1), dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        no_host_sync(torch, lambda: model.decode(params, zeros, server.state, 0))
    log("[serve_rwkv] host syncs in one decode step: 0 (sync debug mode 'error')")

    # The tokens of a 1-slot server (the shapes `generate` runs: a B = 1
    # prefill, M = 1 decode steps) equal generate's exactly.  The 4-slot
    # run's M = 4 products may take other blocks than M = 1's, so its
    # tokens are held against a teacher-forced decode on the same shapes.
    one = ContinuousBatchingServer(model, params, dataclasses.replace(scfg, max_slots=1),
                                   device="cuda")
    prompt = torch.as_tensor(prompts[0], device="cuda")[None]
    with k1_products("serve_rwkv"):
        single = one.run([Request(rid="one", prompt=prompts[0], max_new_tokens=NEW_TOKENS)])
        ref_tokens, steps_s = generate(model, params, prompt, gen_len=NEW_TOKENS)
    ref_tokens = ref_tokens[0].tolist()
    check(single["one"].tokens == ref_tokens,
          f"1-slot server {single['one'].tokens} != generate's {ref_tokens}")
    served = results["req0"].tokens
    check(served[0] == ref_tokens[0], f"first token {served[0]} != generate's {ref_tokens[0]}")
    # Every request of the 4-slot window (req4-7 reuse freed slots): its
    # B = 1 prefill's state copied into all SLOTS rows, then its served
    # tokens teacher-forced through M = 4 decode steps, the server's
    # products row for row.  Each served token must be that decode's argmax
    # exactly: a fault in the slot insert or in slot reuse breaks it.  The
    # gap below a B = 1 (M = 1) decode's argmax, and the two decodes' max
    # |dlogit|, are logged beside it.
    wrong, gaps, diffs, scale = {}, {}, {}, 0.0
    with torch.inference_mode():
        for r in reqs:
            toks = results[r.rid].tokens
            lg1, st1 = model.prefill(
                params, {"tokens": torch.as_tensor(r.prompt, device="cuda")[None]})
            st4 = {k: v.expand(v.shape[0], SLOTS, *v.shape[2:]).contiguous()
                   for k, v in st1.items()}
            row4 = lg1[0, -1]
            wrong[r.rid], gaps[r.rid], diffs[r.rid] = [], 0.0, 0.0
            for i in range(RWKV_CHECKED_TOKENS):
                row1 = lg1[0, -1].float()
                if int(row4.argmax()) != toks[i]:
                    wrong[r.rid].append(i)
                gaps[r.rid] = max(gaps[r.rid], (row1.max() - row1[toks[i]]).item())
                diffs[r.rid] = max(diffs[r.rid], (row4.float() - row1).abs().max().item())
                scale = max(scale, row1.abs().max().item())
                tok = torch.full((SLOTS, 1), toks[i], dtype=torch.int32, device="cuda")
                lg1, st1 = model.decode(params, tok[:1], st1, 0)
                lg4, st4 = model.decode(params, tok, st4, 0)
                row4 = lg4[0, -1]
    exact = sum(a == b for a, b in zip(served, ref_tokens))
    log(f"[serve_rwkv] 1-slot server == generate: {NEW_TOKENS}/{NEW_TOKENS} tokens"
        f" (generate {steps_s:.2f} steps/s at B=1); 4-slot req0 equals generate at"
        f" {exact}/{NEW_TOKENS}.  First {RWKV_CHECKED_TOKENS} tokens of each 4-slot request"
        f" against its teacher-forced M={SLOTS} decode: positions off its argmax {wrong};"
        f" gap below the M=1 decode's argmax {gaps}; M={SLOTS} vs M=1 max |dlogit| {diffs}"
        f" (max |logit| {scale:.3f})")
    check(not any(wrong.values()),
          f"4-slot tokens off their teacher-forced M={SLOTS} argmax: {wrong}")
    # Profiled windows are short: the profiler's processing of an eager
    # model's host events takes seconds per thousand ops.
    profile_window(torch, model, params, scfg, prompts[:PROFILE_REQUESTS],
                   tag="profile serve_rwkv", new_tokens=RWKV_PROFILE_TOKENS)

    # Chunked WKV (tuned) against the scan (untuned) prefill on the same
    # weights, in bf16 and with f32 weights and activations.
    del server, one
    scan_model = get_model(dataclasses.replace(cfg, wkv_chunked=False))
    out = {}
    with torch.inference_mode():
        for dtype in ("bfloat16", "float32"):
            if dtype == "float32":
                params = tree_map(lambda t: t.float(), params)
                _free(torch)
            kw = dict(param_dtype=dtype, activation_dtype=dtype)
            m_c = get_model(dataclasses.replace(cfg, **kw))
            m_s = get_model(dataclasses.replace(scan_model.cfg, **kw))
            lc, sc = m_c.prefill(params, {"tokens": prompt})
            ls, ss = m_s.prefill(params, {"tokens": prompt})
            out[dtype] = (_max_diff(torch, lc, ls, cfg.vocab_size),
                          (ss["wkv"] - sc["wkv"]).abs().max().item()
                          / ss["wkv"].abs().max().item(),
                          ls.float().abs().max().item(),
                          (lc.argmax(-1) == ls.argmax(-1)).float().mean().item())
            check(bool(torch.isfinite(lc.float()).all()), f"{dtype} chunked logits not finite")
    for dtype, tol in (("bfloat16", RWKV_CHUNKED_TOL), ("float32", RWKV_CHUNKED_F32_TOL)):
        d, ds, sc, same = out[dtype]
        log(f"[serve_rwkv] {dtype} prefill T={PROMPT}, chunked WKV vs scan: max |dlogit|="
            f"{d:.4e} (max |logit| {sc:.3f}, tol {tol}), argmax equal at {100 * same:.2f} %,"
            f" final wkv state max |d| / max |state| {ds:.3e}")
        check(d <= tol, f"{dtype} chunked vs scan prefill logits differ by {d}")
    return launches


def phase_serve_pixtral(torch):
    """Full-width Pixtral-12B through the server's paged path: every prefill
    (prompt + 256 stub patches) through K6, every decode step through K4 at
    rep 4, both against the server's counters; K6 prefill logits against the
    plain chunked path, paged decode against dense."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    from repro_torch.launch.scheduler import ContinuousBatchingServer, Request, ServeConfig
    from repro_torch.launch.serve import generate

    cfg = get_config("pixtral-12b").tuned()
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_,
           cfg.d_ff, cfg.vocab_size, cfg.num_stub_patches, cfg.attn_chunk, cfg.use_mesh_kernel,
           cfg.param_dtype)
          == (PIXTRAL_LAYERS, 5120, *PIXTRAL_HEADS, 14336, 131072, PIXTRAL_PATCHES, 1024,
              False, "bfloat16"), f"unexpected Pixtral config {cfg}")
    check(cfg.num_heads * cfg.head_dim_ != cfg.d_model, "heads x hd == d_model")
    model, params = _init_full_width(torch, "serve_pixtral", cfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, t).astype(np.int32) for t in PIXTRAL_PROMPTS]
    pages = [-(-(t + PIXTRAL_PATCHES + PIXTRAL_NEW_TOKENS) // PAGE) for t in PIXTRAL_PROMPTS]
    scfg = ServeConfig(
        max_slots=SLOTS, page_size=PAGE, num_pages=1 + sum(pages), max_pages_per_seq=max(pages),
        queue_capacity=len(prompts), warmup_prompt_lens=(PIXTRAL_PROMPTS[0],))

    flash_attention.launches = paged_attention_cuda.launches = 0
    server = ContinuousBatchingServer(model, params, scfg, device="cuda")
    server.warmup()
    reqs = [Request(rid=f"req{i}", prompt=p, max_new_tokens=PIXTRAL_NEW_TOKENS)
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    results = server.run(reqs)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    for r in reqs:
        res = results[r.rid]
        check(res.status == "ok" and len(res.tokens) == PIXTRAL_NEW_TOKENS,
              f"{r.rid}: {res.status} with {len(res.tokens)} tokens ({res.reason})")
    c = server.counters
    lengths = [t + PIXTRAL_PATCHES for t in (*scfg.warmup_prompt_lens, *PIXTRAL_PROMPTS)]
    check(all(t > 1024 and t % 1024 == 0 for t in lengths) and len(lengths) == c["prefills"],
          f"prefill lengths {lengths}, {c['prefills']} prefills")
    launches = {"flash_attention": flash_attention.launches,
                "paged_attention": paged_attention_cuda.launches}
    want = {"flash_attention": PIXTRAL_LAYERS * c["prefills"],
            "paged_attention": PIXTRAL_LAYERS * c["decode_steps"]}
    generated = sum(len(results[r.rid].tokens) for r in reqs)
    log(f"[serve_pixtral] {len(reqs)} requests (prompts {list(PIXTRAL_PROMPTS)} + "
        f"{PIXTRAL_PATCHES} patches) x {PIXTRAL_NEW_TOKENS} tokens: wall={wall:.3f} s"
        f" tokens/s={generated / wall:.1f} ticks={c['ticks']} prefills={c['prefills']}"
        f" decode steps={c['decode_steps']} (warmup included) launches={launches}"
        f" expected={want}; peak device memory"
        f" {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(launches == want, f"launches {launches} != {want} from the server's counters")

    # K6 prefill logits against the plain chunked path on the first request
    # (1792 + 256 = 2048 positions), then paged decode (K4) against dense.
    prompt = torch.as_tensor(prompts[0], device="cuda")[None]
    batch = {"tokens": prompt, "patches": torch.zeros((1, PIXTRAL_PATCHES, cfg.d_model),
                                                      dtype=cfg.adtype, device="cuda")}
    with torch.inference_mode():
        before = flash_attention.launches
        lg_k6, caches = model.prefill(params, batch)
        check(flash_attention.launches - before == PIXTRAL_LAYERS, "the prefill skipped K6")
        with plain_flash():
            lg_plain = model.prefill(params, batch)[0]
        d = _max_diff(torch, lg_k6, lg_plain, cfg.vocab_size)
        same = (lg_k6.argmax(-1) == lg_plain.argmax(-1)).float().mean().item()
        scale = lg_plain.float().abs().max().item()
        del lg_k6, lg_plain
    log(f"[serve_pixtral] bf16 prefill logits over {PIXTRAL_PROMPTS[0]} text positions"
        f" ({PIXTRAL_PROMPTS[0] + PIXTRAL_PATCHES} with patches), K6 vs plain chunked: max"
        f" |d|={d:.4f} (max |logit| {scale:.3f}, tol {PIXTRAL_K6_CHUNKED_TOL}), argmax equal"
        f" at {100 * same:.2f} %")
    check(d <= PIXTRAL_K6_CHUNKED_TOL, f"K6 vs plain chunked prefill logits differ by {d}")
    served = results["req0"].tokens
    ref_tokens, _ = generate(model, params, prompt, gen_len=8)
    ref_tokens = ref_tokens[0].tolist()
    check(served[0] == ref_tokens[0], f"first token {served[0]} != generate's {ref_tokens[0]}")
    worst_diff, worst_gap, scale = paged_vs_dense(
        torch, model, params, caches, served, PIXTRAL_PROMPTS[0] + PIXTRAL_PATCHES)
    exact = sum(a == b for a, b in zip(served[:8], ref_tokens))
    log(f"[serve_pixtral] req0 first 8 tokens: server={served[:8]} generate={ref_tokens}"
        f" (equal: {exact}/8); teacher-forced paged-vs-dense max |dlogit|={worst_diff:.4f}"
        f" (max |logit| {scale:.3f}), worst server-token gap to dense argmax={worst_gap:.4f}"
        f" (tol {PIXTRAL_LOGIT_TOL})")
    check(worst_diff <= PIXTRAL_LOGIT_TOL, f"paged vs dense logits differ by {worst_diff}")
    check(worst_gap <= PIXTRAL_LOGIT_TOL, f"server token {worst_gap} below the dense argmax")
    del caches, server
    profile_window(torch, model, params, scfg, prompts, tag="profile serve_pixtral",
                   new_tokens=PROFILE_TOKENS)
    del params
    _free(torch)
    return launches


def _teacher_forced(torch, model, params, batch, t_prompt, new_tokens):
    """Greedy prefill then `new_tokens - 1` decode steps with the caches
    `generate` grows for the family padded by new_tokens: (tokens (B,
    new_tokens), prefill logits, [decode logits (B, V)], prefill s, decode
    steps/s)."""
    from repro_torch.launch.serve import _GROWN_CACHES

    grown = _GROWN_CACHES[model.cfg.family]
    with torch.inference_mode():
        t0 = time.monotonic()
        lg_pre, state = model.prefill(params, batch)
        state = {k: (torch.nn.functional.pad(v, (0, 0, 0, 0, 0, new_tokens))
                     if grown is None or k in grown else v) for k, v in state.items()}
        tok = lg_pre[:, -1].argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        t1 = time.monotonic()
        toks, decoded = [tok], []
        for i in range(new_tokens - 1):
            lg, state = model.decode(params, tok[:, None], state, t_prompt + i)
            decoded.append(lg[:, 0])
            tok = lg[:, 0].argmax(-1).to(torch.int32)
            toks.append(tok)
        torch.cuda.synchronize()
        t2 = time.monotonic()
    return torch.stack(toks, dim=1), lg_pre, decoded, t1 - t0, (new_tokens - 1) / (t2 - t1)


def _against_forward(torch, tag, lg_fwd, lg_pre, decoded, t_prompt, vocab, tol):
    """Prefill logits against forward's first t_prompt positions, decode
    step i against forward's position t_prompt + i."""
    d_pre = _max_diff(torch, lg_pre, lg_fwd[:, :t_prompt], vocab)
    d_dec = max(_max_diff(torch, lg, lg_fwd[:, t_prompt + i], vocab)
                for i, lg in enumerate(decoded))
    scale = lg_fwd[..., :vocab].float().abs().max().item()
    log(f"[{tag}] teacher-forced against forward: prefill max |dlogit|={d_pre:.4f}, decode"
        f" max |dlogit|={d_dec:.4f} (max |logit| {scale:.3f}, tol {tol})")
    check(d_pre <= tol and d_dec <= tol,
          f"{tag}: prefill / decode logits differ from forward by {d_pre} / {d_dec}")


def phase_serve_zamba(torch):
    """Full-width Zamba2-1.2B on the kernel path through `generate`: K6 once
    per shared-block application in the prefill, K1 per step against the
    count from the code; prefill and decode logits against `forward`; one
    layer's `ssd_chunked` against `ssd_scan` at full width in f32."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.mesh_matmul import mesh_matmul
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    from repro_torch.launch.serve import generate
    from repro_torch.models.ssm import ssd_chunked, ssd_scan

    cfg = dataclasses.replace(get_config("zamba2-1.2b").tuned(), use_mesh_kernel=True)
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_,
           cfg.d_ff, cfg.vocab_size, cfg.ssm_num_heads, cfg.ssm_state_size,
           cfg.shared_attn_period, cfg.attn_chunk, cfg.param_dtype)
          == (ZAMBA_LAYERS, 2048, 32, 32, 64, 8192, 32000, 64, 64, 6, 1024, "bfloat16"),
          f"unexpected Zamba2 config {cfg}")
    model, params = _init_full_width(torch, "serve_zamba", cfg)
    check("mamba_tail" in params and params["mamba_tail"]["in_proj"].shape == (2, 2048, 8384),
          "Zamba2's 2-layer tail or its 8384-wide in_proj is missing")
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, ZAMBA_PROMPT)).astype(np.int32), device="cuda")

    reset_k1(mesh_matmul)
    flash_attention.launches = paged_attention_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with k1_products("serve_zamba"):
        tokens, steps_s = generate(model, params, prompts, gen_len=ZAMBA_NEW_TOKENS)
        torch.cuda.synchronize()
    wall = time.monotonic() - t0
    check_main_path_tiles("serve_zamba", tile_counts(mesh_matmul), canary=False)
    launches = {"mesh_matmul": mesh_matmul.launches,
                "flash_attention": flash_attention.launches,
                "paged_attention": paged_attention_cuda.launches}
    want = {"mesh_matmul": ZAMBA_STEP_LAUNCHES * ZAMBA_NEW_TOKENS,
            "flash_attention": ZAMBA_APPS, "paged_attention": 0}
    log(f"[serve_zamba] generate 2 x {ZAMBA_PROMPT}-token prompts x {ZAMBA_NEW_TOKENS} tokens:"
        f" wall={wall:.3f} s ({2 * ZAMBA_NEW_TOKENS / wall:.1f} tokens/s with the prefill;"
        f" decode {steps_s:.2f} steps/s, {2 * steps_s:.1f} tokens/s) launches={launches}"
        f" expected={want} ({ZAMBA_STEP_LAUNCHES} K1 a step); peak device memory"
        f" {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(launches == want, f"launches {launches} != {want} from the code's counts")

    # The same greedy run with logits, then forward over prompt + tokens.
    got, lg_pre, decoded, _, _ = _teacher_forced(
        torch, model, params, {"tokens": prompts}, ZAMBA_PROMPT, ZAMBA_NEW_TOKENS)
    check(torch.equal(got, tokens), "generate's tokens differ from the same greedy run")
    profile_call(torch, lambda: generate(model, params, prompts, gen_len=PROFILE_TOKENS),
                 "profile serve_zamba", lambda: f"generate 2 x {ZAMBA_PROMPT} x {PROFILE_TOKENS}")
    full = torch.cat([prompts, tokens[:, :-1]], dim=1)
    with torch.inference_mode():
        lg_fwd, _ = model.forward(params, {"tokens": full})
    _against_forward(torch, "serve_zamba", lg_fwd, lg_pre, decoded, ZAMBA_PROMPT,
                     cfg.vocab_size, ZAMBA_LOGIT_TOL)
    del lg_fwd, lg_pre, decoded, params
    _free(torch)

    # ssd_chunked against ssd_scan at one layer's full width, in f32.
    g = torch.Generator(device="cuda").manual_seed(3)
    h, p, n = cfg.ssm_num_heads, cfg.ssm_expand * cfg.d_model // cfg.ssm_num_heads, 64
    x = torch.randn(2, ZAMBA_PROMPT, h, p, generator=g, device="cuda")
    dt = torch.nn.functional.softplus(torch.randn(2, ZAMBA_PROMPT, h, generator=g,
                                                  device="cuda") - 1)
    a_log = torch.randn(h, generator=g, device="cuda") * 0.5
    b, c = (torch.randn(2, ZAMBA_PROMPT, n, generator=g, device="cuda") for _ in "bc")
    d_skip = torch.randn(h, generator=g, device="cuda")
    h0 = torch.zeros(2, h, p, n, device="cuda")
    with torch.inference_mode():
        y_c, h_c = ssd_chunked(x, dt, a_log, b, c, d_skip, h0)
        y_s, h_s = ssd_scan(x, dt, a_log, b, c, d_skip, h0)
    bad = [f"{name} max |d|={(u - v).abs().max().item():.3e}"
           for name, u, v in (("y", y_c, y_s), ("h", h_c, h_s))
           if not torch.allclose(u, v, rtol=ZAMBA_SSD_F32_TOL, atol=ZAMBA_SSD_F32_TOL)]
    log(f"[serve_zamba] ssd_chunked vs ssd_scan, f32, B=2 T={ZAMBA_PROMPT} H={h} P={p} N={n}:"
        f" y max |d|={(y_c - y_s).abs().max().item():.3e} (max |y| {y_s.abs().max().item():.3f}),"
        f" h max |d|={(h_c - h_s).abs().max().item():.3e} (rtol = atol = {ZAMBA_SSD_F32_TOL},"
        f" tests/test_ssd.py's limit)")
    check(not bad, f"ssd_chunked vs ssd_scan: {bad}")
    return launches


def phase_serve_whisper(torch):
    """Full-width Whisper-medium on the kernel path: 2 x 2048 frames through
    the encoder (K6 non-causal once a layer), a 256-token decoder prompt and
    16 decode steps through `model.prefill` / `model.decode`, K1 per step
    against the count from the code, logits against `forward`."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.mesh_matmul import mesh_matmul
    from repro_torch.models.layers import padded_vocab

    cfg = dataclasses.replace(get_config("whisper-medium").tuned(), use_mesh_kernel=True)
    check((cfg.enc_layers, cfg.dec_layers, cfg.d_model, cfg.num_heads, cfg.head_dim_, cfg.d_ff,
           padded_vocab(cfg), cfg.attn_chunk, cfg.param_dtype)
          == (WHISPER_LAYERS, WHISPER_LAYERS, 1024, 16, 64, 4096, 51968, 1024, "bfloat16"),
          f"unexpected Whisper config {cfg}")
    model, params = _init_full_width(torch, "serve_whisper", cfg)
    rng = np.random.default_rng(0)
    frames = torch.as_tensor(rng.normal(size=(2, WHISPER_FRAMES, cfg.d_model)).astype(np.float32),
                             device="cuda")
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, WHISPER_PROMPT)).astype(np.int32),
                             device="cuda")
    batch = {"frames": frames, "tokens": prompt}

    reset_k1(mesh_matmul)
    flash_attention.launches = 0
    counts = []

    def counted(fn):
        def run(*args):
            k1, k6 = mesh_matmul.launches, flash_attention.launches
            out = fn(*args)
            counts.append((mesh_matmul.launches - k1, flash_attention.launches - k6))
            return out
        return run

    step_model = dataclasses.replace(model, _prefill=counted(model._prefill),
                                     _decode=counted(model._decode))
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with k1_products("serve_whisper"):
        tokens, lg_pre, decoded, prefill_s, steps_s = _teacher_forced(
            torch, step_model, params, batch, WHISPER_PROMPT, WHISPER_NEW_TOKENS)
        torch.cuda.synchronize()
    wall = time.monotonic() - t0
    check_main_path_tiles("serve_whisper", tile_counts(mesh_matmul), canary=False)
    want = ([(WHISPER_ENC_LAUNCHES + WHISPER_DEC_LAUNCHES, WHISPER_LAYERS)]
            + [(WHISPER_DEC_LAUNCHES, 0)] * (WHISPER_NEW_TOKENS - 1))
    launches = {"mesh_matmul": mesh_matmul.launches, "flash_attention": flash_attention.launches}
    log(f"[serve_whisper] 2 x {WHISPER_FRAMES} frames, {WHISPER_PROMPT}-token prompt x"
        f" {WHISPER_NEW_TOKENS} tokens: wall={wall:.3f} s"
        f" ({2 * WHISPER_NEW_TOKENS / wall:.1f} tokens/s with the prefill; prefill"
        f" {prefill_s:.3f} s, decode {steps_s:.2f} steps/s, {2 * steps_s:.1f} tokens/s)"
        f" launches={launches};"
        f" (K1, K6) per step {counts[:2]}..., expected {want[:2]}...; peak device memory"
        f" {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(counts == want, f"(K1, K6) launches per step {counts} != {want}")
    profile_call(torch, lambda: _teacher_forced(torch, model, params, batch, WHISPER_PROMPT,
                                                PROFILE_TOKENS),
                 "profile serve_whisper",
                 lambda: f"prefill 2 x {WHISPER_FRAMES} frames + {PROFILE_TOKENS - 1} steps")
    with torch.inference_mode():
        lg_fwd, _ = model.forward(params, {"frames": frames,
                                           "tokens": torch.cat([prompt, tokens[:, :-1]], 1)})
    _against_forward(torch, "serve_whisper", lg_fwd, lg_pre, decoded, WHISPER_PROMPT,
                     cfg.vocab_size, WHISPER_LOGIT_TOL)
    check(bool((lg_pre.argmax(-1) < cfg.vocab_size).all()), "a padded vocab row won")
    del params, lg_fwd
    _free(torch)
    return launches


# The paper's sizes (`benchmarks/bench_stepcounts.py`) and one at full scale.
# [train_rwkv] and [train_zamba]: 2 AdamW steps at 2 x 2048 tokens, full
# width (RWKV-6 at RWKV_STEP_LAYERS of its depth).  K1 per step: each forward product once, its dA and dB
# (`mm_backward`), and once more for each fused activation's recomputed
# pre-activation: RWKV's silu, relu and sigmoid (3 a layer); Zamba2 fuses
# none.  K6: Zamba2's 6 shared-block attentions forward (the backward
# recomputes the plain chunked path).
FAMILY_TRAIN_STEPS = 2  # 3 until the whole run outgrew its time
# RWKV-6's gradient at random init is chaotic in depth: two plain paths
# that only round differently (the `torch` backend, and the same step with
# the `ref` forward's f32 products) read per-parameter ||d||/||g|| of 0.026
# at 2 layers, 0.28 at 4, 4.3 at 12 and 1.6 at 24, and the kernel path 0.025,
# 0.22, 1.45 and 4.6 (tools/grad_depth.py on an H100 80GB HBM3), so
# [train]'s per-parameter limit is held at 2 layers of the full-width model;
# deeper, the loss (within 1e-3) and finite gradients are, at
# RWKV_COMPARED_LAYERS (the full 24 until the whole run outgrew its time
# with [train_tp]: three 24-layer gradients took about 45 s).
RWKV_HELD_LAYERS = 2
# Without the chunk checkpoint a full-depth RWKV-6 step does not fit the
# card's 80 GB (12 layers peak at 47.17 GiB without it, 26.81 with it, on an
# H100 80GB HBM3), so that reading is taken at a quarter of the depth (half
# until the whole run outgrew its time), both ways.
RWKV_MEMORY_LAYERS = RWKV_LAYERS // 4
RWKV_COMPARED_LAYERS = RWKV_LAYERS // 4
# The steps through train_loop run at a quarter of the depth, full width
# (the full 24 layers until the run needed the time for [dryrun], 30-37 s a
# step; 12 until a whole run took 1123.5 s on an H100 80GB HBM3 at 700 W,
# 17.1 s a step); each layer's 8 products, their dA and dB and 3
# recomputed activations, and the head's product.
RWKV_STEP_LAYERS = RWKV_LAYERS // 4
RWKV_TRAIN_LAUNCHES = {"mesh_matmul": 3 * (8 * RWKV_STEP_LAYERS + 1) + 3 * RWKV_STEP_LAYERS,
                       "flash_attention": 0}
ZAMBA_TRAIN_LAUNCHES = {"mesh_matmul": 3 * ZAMBA_STEP_LAUNCHES, "flash_attention": ZAMBA_APPS}


def phase_train_rwkv(torch):
    """Full-width RWKV-6 1.6B through `tuned()` (the chunked WKV, its chunk
    checkpoint on) on the kernel path."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("rwkv6-1.6b").tuned(), use_mesh_kernel=True)
    check((cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.wkv_chunked, cfg.wkv_chunk)
          == (RWKV_LAYERS, 2048, 7168, True, 16), f"unexpected RWKV-6 config {cfg}")
    return _train_family(torch, "train_rwkv", cfg, RWKV_TRAIN_LAUNCHES,
                         held_layers=RWKV_HELD_LAYERS, compared_layers=RWKV_COMPARED_LAYERS,
                         step_layers=RWKV_STEP_LAYERS)


def phase_train_zamba(torch):
    """Full-width Zamba2-1.2B through `tuned()` on the kernel path: the
    chunked SSD, and the shared block's attention through K6."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("zamba2-1.2b").tuned(), use_mesh_kernel=True)
    check((cfg.num_layers, cfg.d_model, cfg.attn_chunk) == (ZAMBA_LAYERS, 2048, 1024)
          and TRAIN_SEQ % cfg.attn_chunk == 0, f"unexpected Zamba2 config {cfg}")
    return _train_family(torch, "train_zamba", cfg, ZAMBA_TRAIN_LAUNCHES)


def _first_layers(tree, depth):
    """A parameter (or moment) tree with its stacked 'blocks' cut to their
    first `depth` layers, as copies (the rest is freed)."""
    from repro_torch.tree import tree_map

    return {k: (tree_map(lambda t: t[:depth].clone(), v) if k == "blocks" else v)
            for k, v in tree.items()}


def _train_family(torch, tag, cfg, per_step, held_layers=None, compared_layers=None,
                  step_layers=None):
    """One family's training through `build_trainer` and `train_loop`:

    (a) the kernel path's loss and gradients against the `torch` backend's
        on the same state and batch (`_against_torch`), with [train]'s limits
        (loss within 1e-3, grad norm within 0.1 %, each parameter's gradient
        within 0.05 relative; the next batch's torch gradient must fail the
        last) at `held_layers` of the model's layers (all unless given), and
        at `compared_layers` (the full depth unless given) the loss and
        finite gradients;
    (b) FAMILY_TRAIN_STEPS steps (of the full model's first `step_layers`
        layers where given): losses finite, launches per step equal to
        `per_step`, wall ms and tokens/s, peak device memory;
    (c) RWKV: one step's peak device memory with the WKV chunk checkpoint
        and one without it, from the same state, at RWKV_MEMORY_LAYERS.

    Every K1 call of the phase, forward and backward, is recorded
    (`k1_calls`) and must be one [K1] / [K1 train] held on its blocks
    (`check_k1_held`).
    """
    with k1_calls() as seen:
        out = _train_family_work(torch, tag, cfg, per_step, held_layers, compared_layers,
                                 step_layers)
    check_k1_held(tag, seen)
    return out


def _train_family_work(torch, tag, cfg, per_step, held_layers, compared_layers, step_layers):
    """_train_family's work, every K1 call of it recorded by the caller."""
    import dataclasses

    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.mesh_matmul import mesh_matmul
    from repro_torch.launch.train import build_trainer
    from repro_torch.models import rwkv
    from repro_torch.train.loop import LoopConfig, train_loop
    from repro_torch.train.metrics import MetricsLogger
    from repro_torch.tree import tree_leaves, tree_map

    _free(torch)
    kw = dict(batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=TRAIN_LR, total_steps=FAMILY_TRAIN_STEPS,
              seed=0, device="cuda")
    step_fn, state, data = build_trainer(cfg, **kw)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    state_gib = sum(t.numel() * t.element_size() for t in tree_leaves(state)) / 2**30
    log(f"[{tag}] {cfg.arch_id} through tuned(), full width: {n_params / 1e9:.3f} B parameters"
        f" ({cfg.param_dtype}), train state {state_gib:.2f} GiB; {tokens} tokens a step")

    # (a) the kernel path against the torch backend, same state and batch,
    # beside two readings of the size of rounding: the torch step with the
    # `ref` forward (f32 products of the upcast operands: the same function
    # rounded otherwise, no K1) and the next batch's torch step (a wrong
    # gradient of the right size).  Held at `held_layers` (the full depth
    # unless stated); at `compared_layers` also the loss and finite gradients.
    stream = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                    global_batch=TRAIN_BATCH, seed=0))
    batch, next_batch = stream._host_batch(0), stream._host_batch(1)
    for depth in sorted({held_layers or cfg.num_layers, compared_layers or cfg.num_layers}):
        c = dataclasses.replace(cfg, num_layers=depth)
        params = state["params"]
        if depth != cfg.num_layers:  # the full model's first `depth` layers
            params = {k: (tree_map(lambda t: t[:depth], v) if k == "blocks" else v)
                      for k, v in params.items()}
        held = depth == (held_layers or cfg.num_layers)
        readings = _against_torch(torch, tag, c, params, batch, next_batch if held else None)
        lk, lt = readings["loss"]
        if held:
            nk, nt = readings["grad_norm"]
            (hi, at), (lo, lo_at) = readings["kernel"][-1], readings["next batch"][0]
            check(abs(lk - lt) <= 1e-3, f"kernel loss {lk} vs torch {lt} at {depth} layers")
            check(abs(nk - nt) <= 1e-3 * nt, f"kernel grad norm {nk} vs torch {nt}")
            check(hi <= 0.05, f"kernel gradient of {at} differs by {hi} at {depth} layers")
            check(lo > 0.05, f"a wrong gradient of {lo_at} passes ({lo})")
        check(math.isfinite(lk) and abs(lk - lt) <= 1e-3 and readings["finite"],
              f"kernel loss {lk} vs torch {lt}, finite gradients {readings['finite']}")
        del params, readings

    # (b) the steps through train_loop, on the full model's first
    # `step_layers` layers where given (its init, so (a)'s readings and
    # these steps share the weights' scales).
    if step_layers is not None:
        state = {"params": _first_layers(state["params"], step_layers),
                 "opt": {**{k: _first_layers(state["opt"][k], step_layers) for k in ("m", "v")},
                         "count": state["opt"]["count"]},
                 "step": state["step"]}
        _free(torch)
        step_fn, _, data = build_trainer(dataclasses.replace(cfg, num_layers=step_layers), **kw)
        _free(torch)
    per, logger = [], MetricsLogger()

    def timed(st, b):
        k1, k6 = mesh_matmul.launches, flash_attention.launches
        t0 = time.monotonic()
        st, met = step_fn(st, b)
        torch.cuda.synchronize()
        per.append((time.monotonic() - t0, {"mesh_matmul": mesh_matmul.launches - k1,
                                            "flash_attention": flash_attention.launches - k6}))
        return st, met

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_k1(mesh_matmul)
    flash_attention.launches = 0
    state = train_loop(timed, state, data, LoopConfig(total_steps=FAMILY_TRAIN_STEPS,
                                                      log_every=1), logger=logger)
    torch.cuda.synchronize()
    launches = {"mesh_matmul": mesh_matmul.launches, "flash_attention": flash_attention.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    check_main_path_tiles(tag, tile_counts(mesh_matmul), canary=False)
    losses = [h["loss"] for h in logger.history]
    for i, (h, (dt, got)) in enumerate(zip(logger.history, per)):
        log(f"[{tag}] step {i + 1}: loss={h['loss']:.5f} grad_norm={h['grad_norm']:.5f}"
            f" lr={h['lr']:.3e} wall={dt * 1e3:.1f} ms tokens/s={tokens / dt:.1f}"
            f" launches K1={got['mesh_matmul']} K6={got['flash_attention']}")
    steady = min(dt for dt, _ in per[1:])
    log(f"[{tag}] {FAMILY_TRAIN_STEPS} steps: {tokens / steady:.1f} tokens/s at the fastest"
        f" later step ({steady * 1e3:.1f} ms), peak device memory {peak:.2f} GiB (the train"
        f" state {state_gib:.2f} GiB included), launches {launches}, per step want {per_step}")
    check(len(losses) == FAMILY_TRAIN_STEPS and all(math.isfinite(x) for x in losses),
          f"non-finite or missing losses: {losses}")
    check(all(got == per_step for _, got in per), f"launches per step {per}, want {per_step}")
    out = {**launches, "ms_per_step": steady * 1e3, "tokens_s": tokens / steady,
           "peak_gib": peak}

    # (c) the WKV chunk checkpoint's memory: one step each way from the same
    # state, at RWKV_MEMORY_LAYERS (the full depth does not fit without it).
    if cfg.family == "ssm":
        del state, step_fn
        _free(torch)
        depth = RWKV_MEMORY_LAYERS
        step_fn, state, _ = build_trainer(dataclasses.replace(cfg, num_layers=depth), **kw)
        got = {}
        for on in (True, False):
            _free(torch)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.monotonic()
            with rwkv.chunk_checkpoint(on):
                _, met = step_fn(state, batch)
            torch.cuda.synchronize()
            got["on" if on else "off"] = dict(
                ms=(time.monotonic() - t0) * 1e3, loss=float(met["loss"]),
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)
            del met
        out["checkpoint"] = dict(layers=depth, **got)
        for way, r in got.items():
            log(f"[{tag}] one step with the WKV chunk checkpoint {way}: {depth} of"
                f" {cfg.num_layers} layers (cut: the full depth runs out of memory without"
                f" it), {r['ms']:.1f} ms, peak device memory {r['peak_gib']:.2f} GiB (train"
                f" state included), loss {r['loss']:.5f}")
        check(got["on"]["peak_gib"] < got["off"]["peak_gib"],
              f"the checkpoint did not lower the peak: {got}")
    del state, step_fn
    _free(torch)
    return out


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


def _against_torch(torch, tag, cfg, params, batch, next_batch):
    """The kernel path's loss and gradients (`cfg`) against the `torch`
    backend's at `params` on `batch`, beside the `ref` forward's (plain f32
    products: a difference of rounding only) and, given `next_batch`, the
    next batch's (a wrong gradient).  Logs them; returns {"loss": (kernel,
    torch), "grad_norm": (kernel, torch), "kernel", "ref forward" (and
    "next batch"): sorted [(||g - g_torch|| / ||g_torch||, leaf)],
    "finite"}."""
    import dataclasses

    from repro_torch.kernels import api
    from repro_torch.models import get_model
    from repro_torch.tree import tree_paths

    names = [path for path, _ in tree_paths(params)]
    plain = get_model(dataclasses.replace(cfg, use_mesh_kernel=False))
    with k1_products(tag):
        lk, gk = loss_and_grads(torch, get_model(cfg), params, batch)
    lt, gt = loss_and_grads(torch, plain, params, batch)
    norm = lambda gs: math.sqrt(sum(g.float().square().sum().item() for g in gs))  # noqa: E731

    def rel_to(grads):
        """[(||g - g_torch|| / ||g_torch||, leaf)] over the leaves the loss reaches, sorted."""
        return sorted(((x - y).float().norm().item() / y.float().norm().item(), n)
                      for n, x, y in zip(names, grads, gt) if y.float().norm().item() > 0)

    out = {"loss": (float(lk), float(lt)), "grad_norm": (norm(gk), norm(gt)),
           "kernel": rel_to(gk), "finite": all(bool(torch.isfinite(g).all()) for g in gk)}
    unreached = [n for n, x, y in zip(names, gk, gt) if not (x.any() or y.any())]
    del gk
    top = lambda rows: ", ".join(f"{n} {r:.3e}" for r, n in reversed(rows[-3:]))  # noqa: E731
    keep = api._DENSE_FORWARD["torch"]
    api._DENSE_FORWARD["torch"] = api._DENSE_FORWARD["ref"]
    try:
        _, g = loss_and_grads(torch, plain, params, batch)
    finally:
        api._DENSE_FORWARD["torch"] = keep
    out["ref forward"] = rel_to(g)
    del g
    more = f"; the ref forward {top(out['ref forward'])}"
    if next_batch is not None:
        _, g = loss_and_grads(torch, plain, params, next_batch)
        out["next batch"] = rel_to(g)
        del g
        more += (f" (tol 0.05); the next batch's smallest {out['next batch'][0][0]:.3e}"
                 f" ({out['next batch'][0][1]})")
    del gt
    (nk, nt), (lk, lt) = out["grad_norm"], out["loss"]
    log(f"[{tag}] {cfg.num_layers} layers, kernel vs torch backend: loss {lk:.5f} vs {lt:.5f}"
        f" (|d|={abs(lk - lt):.5f}, tol 0.001), grad norm {nk:.5f} vs {nt:.5f}"
        f" ({100 * abs(nk - nt) / nt:.4f} %), finite {out['finite']}; per-parameter"
        f" ||d||/||g|| largest: kernel {top(out['kernel'])}{more}; leaves the loss does not"
        f" reach: {unreached}")
    return out


# [sharded]: the planner's schedules across 4 ranks, processes that share
# the one card (and Cannon's 2 x 2 mesh), at mesh-paper's width: M = 2 x
# 2048 tokens, K = 2048, N = 8192; `expert` at OLMoE's decode shape (64
# experts x 8 rows, wi's K = N = 2048, SLOTS tokens routed top-8).
SHARD_WORLD, SHARD_MKN = 4, (TRAIN_BATCH * TRAIN_SEQ, 2048, 8192)
SHARD_BLOCKS, SHARD_EXPERT_BLOCKS = (128, 128, 128), (8, 128, 128)
SHARD_CASES = {  # name -> (mesh shape, axis names, ShardSpec axes and schedule)
    "replicated[m=x,n=y]": ((2, 2), ("x", "y"), dict(m="x", n="y", schedule="replicated")),
    "allgather_a": ((4,), ("x",), dict(m="x", schedule="allgather_a")),
    "allgather_a_overlap": ((4,), ("x",), dict(m="x", schedule="allgather_a_overlap")),
    "reduce_scatter_k": ((4,), ("x",), dict(k="x", schedule="reduce_scatter_k")),
    "reduce_scatter_k_overlap": ((4,), ("x",), dict(k="x", schedule="reduce_scatter_k_overlap")),
    "ring_k": ((4,), ("x",), dict(k="x", schedule="ring_k")),
    "ring_k_overlap": ((4,), ("x",), dict(k="x", schedule="ring_k_overlap")),
    "pipeline": ((4,), ("x",), dict(k="x", schedule="pipeline")),
}
SHARD_FAULTS = ("reduce_scatter_k_overlap", "ring_k_overlap")
SHARD_TIMEOUT_S = 300


def _spawn(code_of, world, timeout):
    """`world` processes of `python3 -c code_of(rank)` from the repository
    root, each killed at `timeout`; [(returncode, stdout, stderr)]."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    procs = [subprocess.Popen([sys.executable, "-c", code_of(r)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    out = []
    try:
        for proc in procs:
            try:
                o, e = proc.communicate(timeout=timeout)
                out.append((proc.returncode, o, e))
            except subprocess.TimeoutExpired:
                out.append((None, "", f"timed out after {timeout} s"))
                timeout = 1
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return out


def nccl_probe(rank, world, init):
    """Two NCCL ranks on the one card: one all-reduce."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{init}", rank=rank, world_size=world)
    x = torch.ones(4, device="cuda")
    dist.all_reduce(x)
    torch.cuda.synchronize()
    print("ALLREDUCE", x.tolist(), flush=True)
    dist.destroy_process_group()


def sharded_rank(rank, world, init, out_path):
    """One rank of [sharded] (run by the phase in its own process): every
    schedule of SHARD_CASES on K1 with integer-valued f32 and random bf16
    operands, the `expert` schedule on K5, Cannon on a 2 x 2 mesh and a
    planted collective fault, each against the unsharded plan on this rank.
    Its findings go to `out_path` as JSON."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import api
    from repro_torch.kernels.grouped import grouped_mesh_matmul
    from repro_torch.kernels.mesh_matmul import mesh_matmul
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.parallel.systolic import systolic_matmul
    from repro_torch.resilience import faults

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank, world_size=world)
    m, k, n = SHARD_MKN
    g = torch.Generator(device="cuda").manual_seed(11)  # the same operands on every rank
    operands = {
        "f32 integer": (torch.randint(-4, 5, (m, k), generator=g, device="cuda").float(),
                        torch.randint(-4, 5, (k, n), generator=g, device="cuda").float()),
        "bf16": (torch.randn(m, k, generator=g, device="cuda").bfloat16(),
                 torch.randn(k, n, generator=g, device="cuda").bfloat16()),
    }
    meshes = {(s, a): make_local_mesh(s, a) for s, a, _ in SHARD_CASES.values()}
    found = {"cases": {}, "faults": {}}

    def measure(name, p, a, b, want, counter, *args):
        torch.cuda.synchronize()
        before = counter.launches
        t0 = time.monotonic()
        got = p(a, b, *args)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        err = (got.float() - want.float()).abs().max().item()
        found["cases"][name] = dict(
            launches=counter.launches - before, wall_s=wall, bitwise=bool(torch.equal(got, want)),
            err=err, scale=want.float().abs().max().item(), finite=bool(torch.isfinite(got).all()),
            describe={x: p.describe()["sharding"][x] for x in (
                "schedule", "kernel_invocations", "collective_phases", "bytes_moved",
                "per_shard_mkn")})

    for dt, (a, b) in operands.items():
        want = api.plan(api.GemmSpec.from_operands(a, b, blocks=SHARD_BLOCKS), backend="cuda_mesh",
                        device="cuda")(a, b)
        for case, (shape, axes, kw) in SHARD_CASES.items():
            mesh = meshes[(shape, axes)]
            spec = api.GemmSpec.from_operands(a, b, blocks=SHARD_BLOCKS,
                                              shard=api.ShardSpec.from_mesh(mesh, **kw))
            p = api.plan(spec, backend="cuda_mesh", device="cuda", mesh=mesh)
            measure(f"{case} {dt}", p, a, b, want, mesh_matmul)
        grid = make_local_mesh((2, 2), ("data", "model"))
        torch.cuda.synchronize()
        t0 = time.monotonic()
        c = systolic_matmul(a, b, mesh=grid)
        torch.cuda.synchronize()
        found["cases"][f"cannon 2x2 {dt}"] = dict(
            wall_s=time.monotonic() - t0, bitwise=bool(torch.equal(c, want)),
            err=(c.float() - want.float()).abs().max().item(),
            scale=want.float().abs().max().item(), finite=bool(torch.isfinite(c).all()))
        if dt == "f32 integer":
            mesh = meshes[((4,), ("x",))]
            for sched in SHARD_FAULTS:
                spec = api.GemmSpec.from_operands(
                    a, b, blocks=SHARD_BLOCKS,
                    shard=api.ShardSpec.from_mesh(mesh, k="x", schedule=sched))
                res = {}
                for fallback in (False, True):
                    p = api.plan(spec, backend="cuda_mesh", device="cuda", mesh=mesh,
                                 fallback=fallback)
                    try:
                        with faults.inject({"collective.step": faults.FaultSpec(
                                times=1, match={"schedule": sched, "step": 1})}):
                            got = p(a, b)
                        res[str(fallback)] = dict(bitwise=bool(torch.equal(got, want)),
                                                  active=p._active)
                    except faults.FaultError as e:
                        res[str(fallback)] = f"raised {type(e).__name__}"
                found["faults"][sched] = res
        del want

    # expert: K5 over each rank's 16 of OLMoE's 64 experts.
    rng = np.random.default_rng(5)
    sizes = torch.as_tensor(_routed_sizes(rng, SLOTS), device="cuda")
    offsets = torch.cat([sizes.new_zeros(1), torch.cumsum(sizes, 0)]).int()
    (kk, nn), grp = K5_GEMMS["wi"], api.GroupSpec(OLMOE_EXPERTS, K5_SHAPES["decode"][0])
    mesh = meshes[((4,), ("x",))]
    for dt in ("f32 integer", "bf16"):
        if dt == "bf16":
            tok = torch.randn(grp.rows, kk, generator=g, device="cuda").bfloat16()
            w = torch.randn(OLMOE_EXPERTS, kk, nn, generator=g, device="cuda").bfloat16()
        else:
            tok = torch.randint(-4, 5, (grp.rows, kk), generator=g, device="cuda").float()
            w = torch.randint(-4, 5, (OLMOE_EXPERTS, kk, nn), generator=g, device="cuda").float()
        spec = api.GemmSpec.for_groups(grp, kk, nn, dtype_a=tok.dtype, dtype_b=w.dtype,
                                       blocks=SHARD_EXPERT_BLOCKS)
        want = api.plan(spec, backend="cuda_mesh", device="cuda")(tok, offsets, w)
        p = api.plan(dataclasses.replace(spec, shard=api.ShardSpec.from_mesh(mesh, g="x")),
                     backend="cuda_mesh", device="cuda", mesh=mesh)
        measure(f"expert {dt}", p, tok, offsets, want, grouped_mesh_matmul, w)
    with open(out_path, "w") as f:
        json.dump(found, f)
    dist.destroy_process_group()


def phase_sharded(torch):
    """The planner's collective schedules on the card: 4 ranks in processes
    that share it (NCCL refuses two ranks on one card, so the group is gloo,
    its hops staged through host memory), each schedule's output against
    the unsharded plan on every rank (integer-valued f32 bitwise, bf16
    within 2^-7·max|ref|), K1/K5 launches per rank against the code's
    count, a planted collective fault raising by default and degrading to
    replicated with the same bits under fallback=True.  Walls are printed,
    not speeds: the ranks share one card and the hops go through the host."""
    from repro_torch.parallel.systolic import phase_counts

    _free(torch)  # the ranks' memory comes from the same card
    for p in range(2, 9):
        log(f"[sharded] phase_counts({p}): {phase_counts(p)}")
    with tempfile.TemporaryDirectory() as tmp:
        probe = _spawn(lambda r: (
            "import chip_smoke; chip_smoke.nccl_probe("
            f"{r}, 2, {os.path.join(tmp, 'nccl')!r})"), 2, 90)
        said = [(rc, next((ln.strip()[:300] for ln in e.splitlines()
                           if "Error" in ln or "Duplicate" in ln), e.strip()[-300:]))
                for rc, _, e in probe]
        refused = all(rc not in (0, None) for rc, _ in said)
        log(f"[sharded] NCCL, two ranks on the one card: "
            f"{'refused' if refused else 'did not refuse'}: {said}")
        t0 = time.monotonic()
        runs = _spawn(lambda r: (
            "import chip_smoke; chip_smoke.sharded_rank("
            f"{r}, {SHARD_WORLD}, {os.path.join(tmp, 'gloo')!r},"
            f" {os.path.join(tmp, f'rank{r}.json')!r})"), SHARD_WORLD, SHARD_TIMEOUT_S)
        wall = time.monotonic() - t0
        bad = [f"rank {r}: rc={rc} {e[-2000:]}" for r, (rc, _, e) in enumerate(runs) if rc != 0]
        check(not bad, "[sharded] rank failures:\n" + "\n".join(bad))
        ranks = [json.loads(Path(tmp, f"rank{r}.json").read_text()) for r in range(SHARD_WORLD)]
    log(f"[sharded] {SHARD_WORLD} gloo ranks on one card, M K N = {SHARD_MKN}: {wall:.1f} s"
        " wall in all, process start and CUDA init included")
    failed, totals = [], {"mesh_matmul": 0, "grouped_mesh_matmul": 0}
    for name in ranks[0]["cases"]:
        for r, found in enumerate(ranks):
            c = found["cases"][name]
            integer = "integer" in name
            tol = 0.0 if integer else 2.0**-7 * c["scale"]
            ok = c["finite"] and (c["bitwise"] if integer else c["err"] <= tol)
            want_launches = (c["describe"]["kernel_invocations"] if "describe" in c else None)
            if want_launches is not None:
                ok = ok and c["launches"] == want_launches
                totals["grouped_mesh_matmul" if name.startswith("expert")
                       else "mesh_matmul"] += c["launches"]
            if not ok:
                failed.append(f"rank {r} {name}: {c}")
        c = ranks[0]["cases"][name]
        log(f"[sharded] {name:34s} " + (
            f"{c['describe']['schedule']}: launches per rank {c['launches']} (code:"
            f" kernel_invocations {c['describe']['kernel_invocations']}), phases"
            f" {c['describe']['collective_phases']}, bytes moved {c['describe']['bytes_moved']},"
            f" per-shard MKN {c['describe']['per_shard_mkn']}; " if "describe" in c else
            "Cannon, local product torch.matmul f32 (TF32 off); ")
            + f"bitwise {c['bitwise']}, max |d| {c['err']:.3e} (max|ref| {c['scale']:.3e},"
            f" tol {'0 (integer-valued)' if 'integer' in name else '2^-7 max|ref|'});"
            f" rank 0 wall {c['wall_s'] * 1e3:.1f} ms (not a speed)")
    for sched in SHARD_FAULTS:
        for r, found in enumerate(ranks):
            res = found["faults"][sched]
            ok = (res["False"] == "raised FaultError" and res["True"]["bitwise"]
                  and res["True"]["active"] == "replicated")
            if not ok:
                failed.append(f"rank {r} fault {sched}: {res}")
        log(f"[sharded] collective.step fault in {sched} at step 1: fallback=False"
            f" {ranks[0]['faults'][sched]['False']}; fallback=True {ranks[0]['faults'][sched]['True']}")
    check(not failed, "[sharded] failed:\n" + "\n".join(failed))
    return totals


# [train_dp]: data-parallel training of full-width mesh-paper on TRAIN_DP_RANKS
# ranks sharing the card (gloo; one row of the TRAIN_BATCH x TRAIN_SEQ batch a
# rank), then mesh-paper's 4 stacked blocks as the stages of a pipeline over
# TRAIN_DP_WORLD ranks, PIPE_MICRO microbatches of 1 x PIPE_TOKENS tokens.
TRAIN_DP_WORLD, TRAIN_DP_RANKS, DP_STEPS = 4, 2, 3
PIPE_MICRO, PIPE_TOKENS = 4, 256
TRAIN_DP_TIMEOUT_S = 240
# DP against the single-process steps on the same state and batch 0.  Each
# rank's row runs the same products on the same blocks as a single-process
# step on that row alone (the parent plans every shape first and hands the
# ranks its autotune cache), so the DP gradients and loss must equal, bit
# for bit, the row-weighted f32 sum of those per-row steps, cast to the
# leaf's dtype (two ranks: one exact f32 add).  Against the single-process
# step on the full batch, a row's products differ in their k order: K1's
# stagger visits tile (i, j)'s k blocks in the order (i + j + k) mod nk, and
# a row's tile index i is not the same in a 1-row and a 2-row batch.  (A
# limit of 1e-6 relative on the loss and one rounding of the leaf's dtype
# on each gradient leaf assumed the same k order; every run read a loss
# |d| of 1.984e-04, 1.834e-05 relative, and 3.854 roundings.)  The limits
# there are about 3x this comparison's readings, the same in every run:
# loss |d| 1.984e-04, each parameter's ||d|| within 0.0117 of its
# gradient's norm; the grad norm within 0.01 % (read 0.00189 %).
DP_LOSS_TOL, DP_GRAD_REL_TOL, DP_NORM_RTOL = 6e-4, 0.035, 1e-4
DP_GRAD_ROUNDING = {"torch.bfloat16": 2.0**-8, "torch.float32": 1e-5}
# The int8 error-feedback steps on one repeated batch, at the trainer's
# default lr (3e-4): at [train]'s 1e-3 the third loss rose over the second
# ([10.815, 8.597, 9.758] in the first run): Adam's sign-like first steps
# overshoot one memorised batch, with or without compression.
DP_COMP_LR = 3e-4
# K1 products of one stage (a block: wq, wk, wv, wo, mlp wi, mlp wo) and the
# ticks in which a stage holds a microbatch.
PIPE_STAGE_K1 = 6
# (rows, tokens a row) of the activations [train_dp] runs mesh-paper's GEMMs
# on: the pipeline's microbatches (forward only, no lm_head), a DP rank's
# row and the full batch (forward and backward).
DP_ROWS = ((1, PIPE_TOKENS), (1, TRAIN_SEQ), (TRAIN_BATCH, TRAIN_SEQ))


def dp_products(blocks_of):
    """[train_dp]'s K1 calls, (label, a shape, b shape, dtype, blocks):
    each mesh-paper GEMM's forward at DP_ROWS and its `_mm` backward's dA
    and dB (f32), on the blocks `blocks_of(rows, tokens, K, N)` gives the
    forward; the backward's follow from them as api.mm_backward takes
    them."""
    out = []
    for label, (k, n) in MESH_PAPER_GEMMS.items():
        for rows, t in DP_ROWS:
            if t == PIPE_TOKENS and label == "lm_head":
                continue
            m, blocks = rows * t, blocks_of(rows, t, k, n)
            bm, bn, bk = blocks or (None,) * 3
            out.append((f"{label} fwd {rows}x{t}", (m, k), (k, n), "bfloat16", blocks))
            if t != PIPE_TOKENS:
                out.append((f"{label} dA {rows}x{t}", (m, n), (n, k), "float32", (bm, bk, bn)))
                out.append((f"{label} dB {rows}x{t}", (k, m), (m, n), "float32", (bk, bn, bm)))
    return out


def family_train_products(blocks_of):
    """[train_rwkv]'s and [train_zamba]'s K1 calls as k1_key tuples: each
    GEMM's forward at M = 2 x 2048 on the blocks `blocks_of(M, K, N)` gives
    it (with its fused activation), and the `_mm` backward's f32 calls as
    api.mm_backward makes them: z recomputed where an activation is fused,
    then dA and dB."""
    keys = set()
    for table in (RWKV_TRAIN_GEMMS, ZAMBA_GEMMS):
        for k, n, kw, _ in table.values():
            m, act = TRAIN_BATCH * TRAIN_SEQ, kw.get("activation")
            bm, bn, bk = blocks_of(m, k, n)
            keys.add(((m, k), (k, n), "bfloat16", "bfloat16", (bm, bn, bk), True, False, act,
                      False, False))
            if act is not None:
                keys.add(((m, k), (k, n), "float32", "float32", (bm, bn, bk), True, False, None,
                          False, False))
            keys.add(((m, n), (n, k), "float32", "float32", (bm, bk, bn), True, False, None,
                      False, False))
            keys.add(((k, m), (m, n), "float32", "float32", (bk, bn, bm), True, False, None,
                      False, False))
    return keys


def _blocks_at_rows(rank_blocks, parent_blocks, m_rank, m_parent, kn):
    """The rank's plans at M = m_rank of the products whose (K, N) are in
    `kn` against this process's plans of the same product (structure, K,
    N, types, epilogue; the batch dims aside) at M = m_parent, where this
    process has one: (products on equal blocks, {product: (rank's, ours)}
    on others).  A data rank's decode step runs the single process's
    products on fewer rows; its rows agree bitwise only on equal blocks."""
    def split(key):
        k = json.loads(key)
        m, kk, n = (int(x) for x in k[1].split("x"))
        return m, (kk, n), json.dumps([k[0], kk, n] + k[2:4] + k[5:])

    ours = {}
    for key, blocks in parent_blocks.items():
        m, _, product = split(key)
        if m == m_parent:
            ours[product] = blocks
    same, other = 0, {}
    for key, blocks in rank_blocks.items():
        m, shape, product = split(key)
        if m != m_rank or shape not in kn:
            continue
        want = ours.get(product)
        if want == blocks:
            same += 1
        elif want is not None:
            other[key] = (blocks, want)
    return same, other


def _plan_blocks():
    """{plan key: blocks} of every cuda_mesh plan this process holds (a
    grouped plan keyed apart by its groups and rows per group)."""
    from repro_torch.kernels import api

    return {json.dumps([d["structure"], d["mkn"], d["dtypes"], d["out_dtype"], d["batch"],
                        d["epilogue"]["activation"], d.get("grouped")]): d["blocks"]
            for d in api.plan_cache_info()["plans"] if d["backend"] == "cuda_mesh"}


def _sha(torch, t) -> str:
    import hashlib

    return hashlib.sha256(t.detach().contiguous().reshape(-1).view(torch.uint8).cpu()
                          .numpy()).hexdigest()


def train_dp_rank(rank, world, init, tmp):
    """One rank of [train_dp] (run by the phase in its own process).  Ranks
    below TRAIN_DP_RANKS: the DP gradients of batch 0 against the parent's
    single-process ones, DP_STEPS steps through `train_loop` with K1/K3
    launches per step and the parameters' hashes after them, then DP_STEPS
    compressed steps on batch 0 with the error-feedback identity at step 1.
    Every rank: its stage of the pipeline.  Findings go to tmp as JSON."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank, world_size=world)
    with k1_calls() as calls:
        found = _train_dp_rank(rank, world, tmp)
    found["k1_calls"] = sorted(calls, key=str)
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(found, f)
    dist.destroy_process_group()


def _train_dp_rank(rank, world, tmp):
    """train_dp_rank's work, in its process group: its findings."""
    import io

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels.mesh_matmul import mesh_matmul
    from repro_torch.kernels.scramble import scramble_blocks_cuda
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import build_trainer
    from repro_torch.models import get_model
    from repro_torch.models.transformer import block_apply
    from repro_torch.optim import constant, global_norm
    from repro_torch.parallel.collectives import all_reduce
    from repro_torch.parallel.compression import compressed_pmean_tree
    from repro_torch.parallel.pipeline import pipeline_apply
    from repro_torch.train.loop import LoopConfig, train_loop
    from repro_torch.train.metrics import MetricsLogger
    from repro_torch.train.train_step import (
        _grads_of,
        init_dp_train_state_compressed,
        make_dp_train_step_compressed,
    )
    from repro_torch.tree import tree_leaves, tree_map

    cfg = get_config("mesh-paper")
    dp_mesh = make_local_mesh((TRAIN_DP_RANKS, 1), ("data", "model"))
    stage_mesh = make_local_mesh((world,), ("stage",))
    found = {}
    if rank < TRAIN_DP_RANKS:
        group = dp_mesh.get_group("data")
        step_fn, state, data = build_trainer(
            cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ, mesh=dp_mesh, lr=TRAIN_LR,
            total_steps=TRAIN_STEPS, seed=0, device="cuda")
        batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                       global_batch=TRAIN_BATCH, seed=0))._host_batch(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        grads, met = step_fn.grads(state["params"], batch)
        torch.cuda.synchronize()
        found["grads_wall_s"] = time.monotonic() - t0
        found["loss"], found["grad_norm"] = float(met["loss"]), float(global_norm(grads))
        rows = torch.load(os.path.join(tmp, "rows.pt"))
        found["rows_bitwise"] = [bool(torch.equal(g, w.cuda()))
                                 for g, w in zip(tree_leaves(grads), rows["grads"])]
        found["rows_loss"] = rows["loss"]
        del rows
        want = torch.load(os.path.join(tmp, "grads.pt"))
        found["leaves"] = []
        for g, w in zip(tree_leaves(grads), want["grads"]):
            w = w.cuda().float()
            d = g.float() - w
            found["leaves"].append(dict(dtype=str(g.dtype), shape=list(g.shape),
                                        err=d.abs().max().item(), scale=w.abs().max().item(),
                                        rel=d.norm().item() / max(w.norm().item(), 1e-30)))
        del grads, want, w, d
        found["grads_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30

        per_step = []

        def timed(st, b):
            k1, k3 = mesh_matmul.launches, scramble_blocks_cuda.launches
            t0 = time.monotonic()
            st, m = step_fn(st, b)
            torch.cuda.synchronize()
            per_step.append((time.monotonic() - t0, mesh_matmul.launches - k1,
                             scramble_blocks_cuda.launches - k3))
            return st, m

        logger = MetricsLogger(stream=io.StringIO())
        mesh_matmul.launches, scramble_blocks_cuda.launches = 0, 0
        torch.cuda.reset_peak_memory_stats()
        state = train_loop(timed, state, data, LoopConfig(total_steps=DP_STEPS, log_every=1),
                           logger=logger, group=group)
        found["steps"] = per_step
        found["launches"] = {"mesh_matmul": mesh_matmul.launches,
                             "scramble_blocks": scramble_blocks_cuda.launches}
        found["losses"] = [h["loss"] for h in logger.history]
        found["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        found["param_sha"] = [_sha(torch, p) for p in tree_leaves(state["params"])]
        del state, step_fn, data

        # The int8 error-feedback step, DP_STEPS times on batch 0.
        model = get_model(cfg)
        st = init_dp_train_state_compressed(model, torch.Generator(device="cuda").manual_seed(0),
                                            device="cuda")
        cstep = make_dp_train_step_compressed(model, constant(DP_COMP_LR), dp_mesh)
        mine = {k: torch.as_tensor(v[rank:rank + 1], device="cuda") for k, v in batch.items()}
        g_local, _ = _grads_of(model, st["params"], mine)
        err0 = tree_map(lambda e: e[0], st["err"])
        means, err_lib = compressed_pmean_tree(g_local, err0, ("data",), mesh=dp_mesh)
        del err0
        closs = []
        for i in range(DP_STEPS):
            st, m = cstep(st, batch)
            closs.append(float(m["loss"]))
            if i == 0:
                checks = []
                for g, mean, e_lib, e_step in zip(tree_leaves(g_local), tree_leaves(means),
                                                  tree_leaves(err_lib), tree_leaves(st["err"])):
                    # The identity, from the formula: corrected - q * scale.
                    corrected = g.float()
                    amax = all_reduce(corrected.abs().max(), dist.ReduceOp.MAX, group)
                    scale = torch.clamp(amax / 127.0, min=1e-30)
                    q = torch.clamp(torch.round(corrected / scale), -127, 127)
                    expect = corrected - q * scale
                    f32_mean = all_reduce(corrected, group=group) / TRAIN_DP_RANKS
                    d = (mean.float() - f32_mean).abs()
                    # Beside the quantization's scale/2: the mean's f32
                    # roundings and its cast to the leaf's dtype, together
                    # at most one ulp of that dtype at the mean.
                    ulp = torch.finfo(g.dtype).eps * mean.float().abs()
                    checks.append(dict(
                        identity=bool(torch.equal(e_step[0], expect)),
                        step_is_library=bool(torch.equal(e_step[0], e_lib)),
                        mean_err=d.max().item(), scale=scale.item(),
                        mean_over=(d - (scale / 2 + ulp)).max().item()))
                    del corrected, q, expect, f32_mean, d, ulp
                found["compressed_leaves"] = checks
                del g_local, means, err_lib
        found["compressed_losses"] = closs
        del st, cstep

    # The pipeline: this rank's stage of the 4 stacked blocks.
    params = get_model(cfg).init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    stage = tree_map(lambda t: t[rank:rank + 1].clone(), params["blocks"])
    del params
    pipe = torch.load(os.path.join(tmp, "pipe.pt"))
    x, want = pipe["x"].cuda(), pipe["want"].cuda()
    mesh_matmul.launches, scramble_blocks_cuda.launches = 0, 0
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.monotonic()
    with torch.no_grad():
        out = pipeline_apply(lambda p, h: block_apply(p, h, cfg)[0], stage, x, mesh=stage_mesh,
                             axis="stage")
    torch.cuda.synchronize()
    found["pipeline"] = dict(bitwise=bool(torch.equal(out, want)), wall_s=time.monotonic() - t0,
                             err=(out.float() - want.float()).abs().max().item(),
                             k1=mesh_matmul.launches, k3=scramble_blocks_cuda.launches)
    found["blocks"] = _plan_blocks()
    return found


def phase_train_dp(torch):
    """Data-parallel training on the card: TRAIN_DP_RANKS ranks in processes
    that share it (gloo, the all-reduces staged through host memory), each
    with one row of [train]'s batch: the DP gradients against the
    single-process step's, DP_STEPS steps with K1 75 and K3 4 a step on
    each rank and the ranks' parameters bitwise equal after them, the int8
    error-feedback step; then the pipeline over TRAIN_DP_WORLD stage ranks,
    bitwise equal to the 4 blocks applied in sequence in this process.
    Walls and bytes are printed, never as speeds."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.train import build_trainer
    from repro_torch.models import get_model
    from repro_torch.models.layers import softmax_xent
    from repro_torch.models.transformer import _layers, block_apply, embed_tokens
    from repro_torch.optim import global_norm
    from repro_torch.train.train_step import _grads_of
    from repro_torch.tree import tree_leaves

    cfg = get_config("mesh-paper")
    check(cfg.scramble_privacy and cfg.use_mesh_kernel and cfg.remat_policy == "dots"
          and TRAIN_SEQ == cfg.d_model and cfg.num_layers == TRAIN_DP_WORLD,
          f"[train_dp] needs mesh-paper scrambling at seq {TRAIN_SEQ} under dots: {cfg}")
    _free(torch)
    t_phase = time.monotonic()
    # The single-process kernel step's gradients of batch 0 from the seed-0
    # state ([train]'s first step), then the ranks' shapes: one row's
    # gradients and the pipeline's microbatches, so that every shape is
    # planned here and the ranks read this process's autotune cache.
    _, state, _ = build_trainer(cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=TRAIN_LR,
                                total_steps=TRAIN_STEPS, seed=0, device="cuda")
    model, params = get_model(cfg), state["params"]
    host = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH, seed=0))._host_batch(0)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in host.items()}
    leaves = tree_leaves(params)
    n_params = sum(p.numel() for p in leaves)
    grad_bytes = sum(p.numel() * p.element_size() for p in leaves)
    with k1_calls() as parent_calls:  # the ranks report theirs
        grads, met = _grads_of(model, params, batch)
        ref = {"loss": float(met["loss"]), "grad_norm": float(global_norm(grads))}
        tmp = tempfile.mkdtemp(prefix="train_dp")
        try:
            torch.save({"grads": [g.cpu() for g in tree_leaves(grads)]},
                       os.path.join(tmp, "grads.pt"))
            del grads
            # The DP step's exact value: each rank's row alone, weighted in f32.
            w = 1.0 / TRAIN_DP_RANKS
            acc, loss = None, None
            for r in range(TRAIN_DP_RANKS):
                g, m = _grads_of(model, params, {k: v[r:r + 1] for k, v in batch.items()})
                part = [x.float() * w for x in tree_leaves(g)]
                acc = part if acc is None else [a + b for a, b in zip(acc, part)]
                loss = m["loss"].float() * w if loss is None else loss + m["loss"].float() * w
                del g, part
            torch.save({"grads": [a.to(p.dtype).cpu() for a, p in zip(acc, tree_leaves(params))],
                        "loss": float(loss)}, os.path.join(tmp, "rows.pt"))
            del acc
            # Where the full-batch step differs: each row's loss in the 2-row
            # forward against the row alone.
            with torch.no_grad():
                full = model.forward(params, batch)[0]
                row_gap = []
                for r in range(TRAIN_DP_RANKS):
                    alone = model.forward(params, {k: v[r:r + 1] for k, v in batch.items()})[0]
                    row_gap.append((softmax_xent(full[r:r + 1], batch["labels"][r:r + 1])[0]
                                    - softmax_xent(alone, batch["labels"][r:r + 1])[0]).item())
                del full, alone
            tokens = batch["tokens"][0, :PIPE_MICRO * PIPE_TOKENS].reshape(
                PIPE_MICRO, 1, PIPE_TOKENS)
            with torch.no_grad():
                x = embed_tokens(params, tokens, cfg)
                want = []
                for m in range(PIPE_MICRO):
                    h = x[m]
                    for lp in _layers(params["blocks"], cfg.num_layers):
                        h = block_apply(lp, h, cfg)[0]
                    want.append(h)
            torch.save({"x": x.cpu(), "want": torch.stack(want).cpu()},
                       os.path.join(tmp, "pipe.pt"))
            parent_blocks = _plan_blocks()
            del state, params, leaves, batch, x, want, h
            _free(torch)
            log(f"[train_dp] mesh-paper {n_params / 1e6:.1f} M parameters in"
                f" {len(tree_leaves(model.specs()))} leaves; single-process step from the seed-0"
                f" state on batch 0: loss {ref['loss']:.6f}, grad norm {ref['grad_norm']:.6f};"
                f" each DP rank reckons {grad_bytes / 1e9:.3f} GB of bf16 gradients, reduced in"
                f" f32 as {2 * grad_bytes / 1e9:.3f} GB, and a peak of about 6 GiB"
                f" ({time.monotonic() - t_phase:.1f} s so far); each row's loss in the"
                f" {TRAIN_BATCH}-row forward minus the row alone: {row_gap} (0 where the k order"
                " is the same)")
            t0 = time.monotonic()
            runs = _spawn(lambda r: (
                "import chip_smoke; chip_smoke.train_dp_rank("
                f"{r}, {TRAIN_DP_WORLD}, {os.path.join(tmp, 'gloo')!r}, {tmp!r})"),
                TRAIN_DP_WORLD, TRAIN_DP_TIMEOUT_S)
            wall = time.monotonic() - t0
            bad = [f"rank {r}: rc={rc} {e[-3000:]}" for r, (rc, _, e) in enumerate(runs) if rc != 0]
            check(not bad, "[train_dp] rank failures:\n" + "\n".join(bad))
            ranks = [json.loads(Path(tmp, f"rank{r}.json").read_text())
                     for r in range(TRAIN_DP_WORLD)]
        finally:
            import shutil

            shutil.rmtree(tmp, ignore_errors=True)
    log(f"[train_dp] {TRAIN_DP_WORLD} gloo ranks on one card: {wall:.1f} s wall in all, process"
        " start, CUDA init and the parameters' init included (not a speed: the ranks share the"
        " card and every all-reduce goes through host memory)")
    rank_calls = {tuple(tuple(v) if isinstance(v, list) else v for v in key)
                  for f in ranks for key in f["k1_calls"]}
    check_k1_held("train_dp", parent_calls | rank_calls)
    failed = []
    dp = ranks[:TRAIN_DP_RANKS]
    for r, f in enumerate(dp):
        exact = sum(f["rows_bitwise"]) == len(f["rows_bitwise"]) and f["loss"] == f["rows_loss"]
        d_loss = abs(f["loss"] - ref["loss"])
        d_norm = abs(f["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"]
        worst_rel = max((lf["rel"], i) for i, lf in enumerate(f["leaves"]))
        roundings = max(lf["err"] / (DP_GRAD_ROUNDING[lf["dtype"]] * lf["scale"])
                        for lf in f["leaves"])
        log(f"[train_dp] rank {r}: DP gradients of batch 0 against the {TRAIN_DP_RANKS}"
            f" single-process rows weighted in f32: {sum(f['rows_bitwise'])} of"
            f" {len(f['rows_bitwise'])} leaves bitwise, loss {f['loss']!r} vs"
            f" {f['rows_loss']!r}; against the full-batch step: loss {f['loss']:.6f} vs"
            f" {ref['loss']:.6f} (|d| {d_loss:.3e}, relative {d_loss / abs(ref['loss']):.3e};"
            f" tol {DP_LOSS_TOL}), grad norm {f['grad_norm']:.6f} ({100 * d_norm:.5f} %, tol"
            f" {100 * DP_NORM_RTOL} %), largest ||d||/||g|| {worst_rel[0]:.3e} (leaf"
            f" {worst_rel[1]}, tol {DP_GRAD_REL_TOL}), largest max|d| {roundings:.3f} roundings"
            f" of the leaf's dtype x max|ref| (a reading); wall {f['grads_wall_s']:.2f} s, peak"
            f" {f['grads_peak_gib']:.2f} GiB")
        if not exact or d_loss > DP_LOSS_TOL or d_norm > DP_NORM_RTOL or (
                worst_rel[0] > DP_GRAD_REL_TOL):
            failed.append(f"rank {r} DP gradients: exact {exact}, loss {d_loss}, norm {d_norm},"
                          f" leaf {worst_rel}")
        for i, (dt, k1, k3) in enumerate(f["steps"]):
            log(f"[train_dp] rank {r} step {i + 1}: loss {f['losses'][i]:.5f}, wall"
                f" {dt * 1e3:.1f} ms (not a speed), launches K1={k1} K3={k3}")
        if any((k1, k3) != (STEP_LAUNCHES["mesh_matmul"], STEP_LAUNCHES["scramble_blocks"])
               for _, k1, k3 in f["steps"]) or len(f["steps"]) != DP_STEPS:
            failed.append(f"rank {r} launches per step {f['steps']}")
        if not all(math.isfinite(x) for x in f["losses"]):
            failed.append(f"rank {r} losses {f['losses']}")
        log(f"[train_dp] rank {r}: peak device memory over the {DP_STEPS} steps"
            f" {f['peak_gib']:.2f} GiB; bytes a step: {2 * grad_bytes / 1e9:.3f} GB of f32"
            f" gradients all-reduced (out and back through host memory)")
    same = [a == b for a, b in zip(dp[0]["param_sha"], dp[1]["param_sha"])]
    log(f"[train_dp] parameters after {DP_STEPS} steps: {sum(same)} of {len(same)} leaves"
        " bitwise equal across the ranks (sha256)")
    if not all(same) or len(same) != len(tree_leaves(model.specs())):
        failed.append(f"parameters differ across ranks: {same}")
    if dp[0]["losses"] != dp[1]["losses"]:
        failed.append(f"ranks' losses differ: {dp[0]['losses']} {dp[1]['losses']}")
    for r, f in enumerate(dp):
        c = f["compressed_leaves"]
        ident = sum(x["identity"] and x["step_is_library"] for x in c)
        over = max(x["mean_over"] for x in c)
        losses = f["compressed_losses"]
        log(f"[train_dp] rank {r} int8 error feedback, step 1: new_err == corrected - q*scale"
            f" bitwise on {ident} of {len(c)} leaves; max |compressed mean - f32 mean|"
            f" {max(x['mean_err'] for x in c):.3e}, the most over scale/2 (+ one ulp of the"
            f" leaf's dtype at the mean) {over:.3e} (must be <= 0); losses over {DP_STEPS} steps"
            f" on batch 0 at lr {DP_COMP_LR}: {losses}; bytes a step: {2 * grad_bytes / 1e9:.3f} GB of"
            f" int32 levels and {len(c)} f32 scales all-reduced")
        if ident != len(c) or over > 0:
            failed.append(f"rank {r} compressed step 1: {c}")
        if not (all(math.isfinite(x) for x in losses)
                and all(b < a for a, b in zip(losses, losses[1:]))):
            failed.append(f"rank {r} compressed losses {losses}")
    for r, f in enumerate(ranks):
        p = f["pipeline"]
        log(f"[train_dp] pipeline rank {r} (stage {r}): bitwise {p['bitwise']}, max |d|"
            f" {p['err']:.3e}, K1 {p['k1']} K3 {p['k3']}, wall {p['wall_s'] * 1e3:.1f} ms (not a"
            f" speed)")
        if not p["bitwise"] or p["k1"] != PIPE_MICRO * PIPE_STAGE_K1:
            failed.append(f"pipeline rank {r}: {p}")
        moved = {k: (v, parent_blocks.get(k)) for k, v in f["blocks"].items()
                 if parent_blocks.get(k) != v}
        if moved:
            failed.append(f"rank {r} planned other blocks than this process: {moved}")
    log(f"[train_dp] pipeline: {TRAIN_DP_WORLD} stages x {PIPE_MICRO} microbatches of 1 x"
        f" {PIPE_TOKENS} tokens, {PIPE_MICRO + TRAIN_DP_WORLD - 1} ticks, bubble fraction"
        f" {(TRAIN_DP_WORLD - 1) / (PIPE_MICRO + TRAIN_DP_WORLD - 1):.3f}; bytes: one"
        f" {PIPE_TOKENS * cfg.d_model * 2 / 2**20:.1f} MiB hop a tick and a"
        f" {PIPE_MICRO * PIPE_TOKENS * cfg.d_model * 2 / 2**20:.1f} MiB all-reduce; every"
        f" rank's plans on the parent's blocks: {not any('planned' in x for x in failed)}")
    check(not failed, "[train_dp] failed:\n" + "\n".join(failed))
    return {"mesh_matmul": sum(f["launches"]["mesh_matmul"] for f in dp),
            "scramble_blocks": sum(f["launches"]["scramble_blocks"] for f in dp),
            "pipeline_mesh_matmul": sum(f["pipeline"]["k1"] for f in ranks),
            "pipeline_scramble_blocks": sum(f["pipeline"]["k3"] for f in ranks)}


# [serve_tp]: tensor-parallel serving on TP_RANKS ranks that share the card
# (gloo, every collective staged through host memory): full-width
# mesh-paper through the continuous-batching server, OLMoE-1B-7B with its 64
# experts split over the ranks (expert parallelism), and Qwen2-7B's chunked
# prefill context-parallel under the 'seq_attn' rule (K6 at a query offset
# on rank 1).  The parent computes each single-process reference and plans
# every shard shape first, so the ranks read its autotune cache.
TP_RANKS, TP_TIMEOUT_S = 2, 420
# K4's (S, H, KV, hd) on a rank: mesh-paper's 16 heads split over the ranks.
TP_DECODE = (SLOTS, 16 // TP_RANKS, 16 // TP_RANKS, 128)
# mesh-paper: teacher-forced decode steps after req0's prefill, on the
# single-process greedy tokens (dense decode, then paged decode).
TP_TF_STEPS = 8
# OLMoE: one prompt and teacher-forced decode steps.
TP_MOE_PROMPT, TP_MOE_STEPS = 128, 8
# Qwen2-7B: 4 of its 28 layers (a cut: the phase's time), one 2048-token
# prompt, attn_chunk 1024, and the positions whose logits are compared
# (both sides of the ranks' boundary).
TP_QWEN_LAYERS, TP_QWEN_PROMPT = 4, 2048
TP_QWEN_POSITIONS = (0, 1023, 1024, 2047)
# Limits, each about 3x its first reading on an H100 (the readings are in
# PERF.md): mesh-paper's teacher-forced TP logits, dense and paged, against
# the single-process dense ones; OLMoE's on the single-process routing (replayed:
# the roundings only) and free-running (held at the steps where no layer's
# routing set differs; the differing (step, layer) sets counted); Qwen2-7B's
# context-parallel prefill logits against the single-process K6 prefill.
# First readings (NVIDIA H100 80GB HBM3, both ranks alike): 0.0508;
# 0.0391 replayed; 32 of 144 sets flipped, the 2 flip-free steps 0.0400
# (held at [serve_moe]'s 0.25, 3x its own first reading); 0.0547 on logits
# up to 6.03.
TP_LOGIT_TOL = 0.15
TP_MOE_REPLAY_TOL = 0.12
TP_MOE_FREE_TOL = MOE_LOGIT_TOL
TP_MOE_FLIP_TOL = 96
TP_QWEN_TOL = 0.165


def _tp_ctx(world):
    """A ShardCtx on a plain (data 1, model `world`) layout at model
    coordinate 0: the shard shapes of a rank, without ranks."""
    import numpy as np

    from repro_torch.models.layers import ShardCtx
    from repro_torch.parallel.sharding import MeshLayout

    shape = {"data": 1, "model": world}
    return ShardCtx(tuple(shape.items()), None,
                    MeshLayout(shape, {"data": 0, "model": 0},
                               np.arange(world).reshape(1, world)))


def tp_products(torch):
    """[serve_tp]'s K1 products on a rank, (label, M, K, N, out dtype):
    mesh-paper's and OLMoE's column-parallel projections (a rank's heads,
    its gate and up slices, its vocab rows) and row-parallel ones (f32
    partial sums), at each M the phase runs them."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.attention import head_layout
    from repro_torch.models.layers import padded_vocab

    ctx = _tp_ctx(TP_RANKS)
    out = []
    for name, cfg, ms in (
            ("mesh-paper", get_config("mesh-paper"), (1, SLOTS, PROMPT)),
            ("olmoe", dataclasses.replace(get_config("olmoe-1b-7b"), use_mesh_kernel=True),
             (1, TP_MOE_PROMPT))):
        d, hd = cfg.d_model, cfg.head_dim_
        lay = head_layout(cfg, ctx)
        f32 = torch.float32 if lay.q.count > 1 else None
        prods = [("wq", d, lay.q.size * hd, None), ("wk|wv", d, lay.kv.size * hd, None),
                 ("wo", lay.q.size * hd, d, f32)]
        if not cfg.is_moe:
            fp = ctx.part("mlp", cfg.d_ff)
            prods += [("mlp wi", d, 2 * fp.size, None),
                      ("mlp wo", fp.size, d, torch.float32 if fp.count > 1 else None)]
        vocab = ctx.part("vocab", padded_vocab(cfg))
        prods.append(("lm_head", d, vocab.size, None))
        for m in ms:
            out += [(f"{name} {label} M={m}", m, k, n, dt) for label, k, n, dt in prods]
    return out


def plan_products(torch, products):
    """Plans every (label, M, K, N, out dtype) of `products` on the
    cuda_mesh backend (the timed autotuner, its cache the run's): {(M, K,
    N): blocks}."""
    from repro_torch.kernels import api

    blocks = {}
    for _, m, k, n, dt in products:
        x = torch.empty(m, k, dtype=torch.bfloat16, device="cuda")
        w = torch.empty(k, n, dtype=torch.bfloat16, device="cuda")
        spec = api.GemmSpec.from_operands(x, w, epilogue=api.Epilogue(),
                                          out_dtype=dt or torch.bfloat16,
                                          blocks=(None, None, None))
        blocks[(m, k, n)] = api.plan(spec, backend="cuda_mesh", device="cuda").blocks
    return blocks


# Two f32 sums of K terms in different orders differ by a random walk of
# their roundings, which grows as sqrt(K) against max|ref|.  [K1 train]'s
# 1e-5·max|ref| was set on sums up to K = 32,768, where it reads 0.74-1.03
# on an NVIDIA H100 80GB HBM3 (lm_head's dA 0.74-0.84, Zamba2's 32,000-deep
# head dA 0.88 and 1.03; RWKV-6's 65,536-deep one 1.22 and 1.47).  The
# calls this file holds anew keep 1e-5 up to K = 16,384 and take
# 1e-5·sqrt(K / 16384) past it; the existing cases keep their limits.
F32_DEEP_K = 16384


def hold_k1_keys(torch, tag, keys):
    """Holds each K1 call in `keys` (k1_key tuples) that [K1] / [K1 train]
    did not hold in this process: the kernel against mesh_matmul_torch on
    the same blocks, random operands of the call's shapes and types, at
    [K1]'s limits (by input type: 2^-7·max|ref| for bf16, 1e-5 for f32),
    the f32 one times sqrt(K / 16384) past K = 16384 (F32_DEEP_K).
    Returns (held here, held before)."""
    from repro_torch.kernels.mesh_matmul import mesh_matmul, mesh_matmul_torch

    g = torch.Generator(device="cuda").manual_seed(11)
    here, failed = 0, []
    for key in sorted(keys, key=str):
        if key in K1_HELD:
            continue
        a_shape, b_shape, dt, out_dt, blocks, stagger, scramble, act, bias, res = key
        dtype, out_dtype = getattr(torch, dt), getattr(torch, out_dt)
        a = torch.randn(*a_shape, generator=g, device="cuda").to(dtype)
        b = torch.randn(*b_shape, generator=g, device="cuda").to(dtype)
        kw = dict(block_m=blocks[0], block_n=blocks[1], block_k=blocks[2], stagger=stagger,
                  scramble_out=scramble, activation=act, out_dtype=out_dtype)
        if bias:
            kw["bias"] = torch.randn(b_shape[-1], generator=g, device="cuda").to(dtype)
        if res:
            kw["residual"] = torch.randn(*a_shape[:-1], b_shape[-1], generator=g,
                                         device="cuda").to(dtype)
        out, ref = mesh_matmul(a, b, **kw).float(), mesh_matmul_torch(a, b, **kw).float()
        err = (out - ref).abs().max().item()
        tol = (1e-5 * max(1.0, math.sqrt(a_shape[-1] / F32_DEEP_K)) if dtype == torch.float32
               else 2.0**-7) * ref.abs().max().item()
        here += 1
        log(f"[{tag}] K1 call {a_shape}x{b_shape} {dt}->{out_dt} blocks {blocks}: err={err:.3e}"
            f" tol={tol:.3e}")
        if err <= tol and bool(torch.isfinite(out).all()):
            K1_HELD.add(key)
        else:
            failed.append(f"{a_shape}x{b_shape} {dt}->{out_dt} blocks {blocks}: {err} > {tol}")
        del a, b, out, ref
    check(not failed, f"{tag}: K1 disagrees with its plain version: {failed}")
    return here, len(keys) - here


def serve_tp_rank(rank, world, init, tmp):
    """One rank of [serve_tp] (run by the phase in its own process): its
    findings, K1, K4 and K5 calls and plans' blocks go to tmp as JSON."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank, world_size=world)
    with k1_calls() as calls, k4_k5_calls() as (k4, k5, k6):
        found = _serve_tp_rank(torch, rank, world, tmp)
    found["k1_calls"] = sorted(calls, key=str)
    found["k4_calls"], found["k5_calls"] = sorted(k4, key=str), sorted(k5, key=str)
    found["k6_calls"] = sorted(k6, key=str)
    found["blocks"] = _plan_blocks()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(found, f)
    dist.destroy_process_group()


def _tp_params(torch, model, ctx):
    """The seed-0 init on the card, cut to this rank's blocks."""
    from repro_torch.interop import shard_params

    full = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    params = shard_params(full, model, ctx)
    del full
    _free(torch)
    return params


def _serve_tp_rank(torch, rank, world, tmp):
    """serve_tp_rank's work, in its process group."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.grouped import grouped_mesh_matmul
    from repro_torch.kernels.mesh_matmul import mesh_matmul
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.scheduler import ContinuousBatchingServer, Request, ServeConfig
    from repro_torch.models import get_model
    from repro_torch.models.attention import head_layout
    from repro_torch.models.layers import ShardCtx
    from repro_torch.parallel.sharding import DEFAULT_RULES

    mesh = make_local_mesh((1, world), ("data", "model"))
    ctx = ShardCtx(mesh)
    found = {}

    def gathered(lg):
        """The last position's logits, whole on every rank."""
        return ctx.gather(lg[:, -1, :].float(), ("batch", "vocab"),
                          (lg.shape[0], lg.shape[-1] * world))[0]

    # (a) mesh-paper through the server, then req0 teacher-forced through
    # dense decode and through paged decode (K4 on the rank's pools).
    ref = torch.load(os.path.join(tmp, "mesh_paper.pt"))
    cfg = get_config("mesh-paper")
    model = get_model(cfg)
    params = _tp_params(torch, model, ctx)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, PROMPT).astype(np.int32) for _ in range(REQUESTS)]
    pages = -(-(PROMPT + NEW_TOKENS) // PAGE)
    scfg = ServeConfig(max_slots=SLOTS, page_size=PAGE, num_pages=1 + SLOTS * pages,
                       max_pages_per_seq=pages, queue_capacity=REQUESTS,
                       warmup_prompt_lens=(PROMPT,))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_k1(mesh_matmul)
    paged_attention_cuda.launches = 0
    t0 = time.monotonic()
    server = ContinuousBatchingServer(model, params, scfg, ctx, device="cuda")
    server.warmup()
    results = server.run([Request(rid=f"req{i}", prompt=p, max_new_tokens=NEW_TOKENS)
                          for i, p in enumerate(prompts)])
    torch.cuda.synchronize()
    lay = head_layout(cfg, ctx)
    found["serve"] = dict(
        wall_s=time.monotonic() - t0, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        k1=mesh_matmul.launches, k4=paged_attention_cuda.launches, tiles=tile_counts(mesh_matmul),
        counters={k: v for k, v in server.counters.items()},
        statuses=[r.status for r in results.values()],
        lengths=[len(r.tokens) for r in results.values()],
        req0=results["req0"].tokens, heads=[lay.q.size, lay.kv.size, len(lay.read)])
    del server
    reset_k1(mesh_matmul)
    diffs = []
    with torch.inference_mode():
        prompt = torch.as_tensor(prompts[0], device="cuda")[None]
        lg, state = model.prefill(params, {"tokens": prompt}, ctx)
        diffs.append((gathered(lg) - ref["logits"][0].cuda()).abs().max().item())
        state = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, TP_TF_STEPS))
                 for k, v in state.items()}
        for i in range(TP_TF_STEPS):
            tok = torch.tensor([[ref["feed"][i]]], dtype=torch.int32, device="cuda")
            lg, state = model.decode(params, tok, state, PROMPT + i, ctx)
            diffs.append((gathered(lg) - ref["logits"][i + 1].cuda()).abs().max().item())
    torch.cuda.synchronize()
    found["teacher_forced"] = dict(diffs=diffs, k1=mesh_matmul.launches)
    reset_k1(mesh_matmul)
    paged_attention_cuda.launches = 0
    diffs = []
    with torch.inference_mode():
        lg, caches = model.prefill(params, {"tokens": prompt}, ctx)
        diffs.append((gathered(lg) - ref["logits"][0].cuda()).abs().max().item())
        n_pages = -(-(PROMPT + TP_TF_STEPS) // PAGE)
        pools = {}
        for k, c in caches.items():  # (L, 1, T, kv heads, hd): the read heads, paged
            c = torch.nn.functional.pad(lay.select(c[:, 0], dim=2),
                                        (0, 0, 0, 0, 0, n_pages * PAGE - PROMPT))
            pools[k] = torch.zeros((c.shape[0], 1 + n_pages, PAGE, *c.shape[2:]),
                                   dtype=c.dtype, device="cuda")
            pools[k][:, 1:] = c.reshape(c.shape[0], n_pages, PAGE, *c.shape[2:])
        specs = model.paged_pool_specs(1 + n_pages, PAGE, ctx)
        shapes = {k: list(v.shape) for k, v in pools.items()}
        want = {k: list(shape) for k, (shape, _) in specs.items()}
        bt = torch.arange(1, 1 + n_pages, dtype=torch.int32, device="cuda")[None]
        for i in range(TP_TF_STEPS):
            tok = torch.tensor([[ref["feed"][i]]], dtype=torch.int32, device="cuda")
            pos = torch.tensor([PROMPT + i], dtype=torch.int32, device="cuda")
            lg, pools = model.paged_decode(params, tok, pools, bt, pos, ctx)
            diffs.append((gathered(lg) - ref["logits"][i + 1].cuda()).abs().max().item())
    torch.cuda.synchronize()
    found["paged_teacher_forced"] = dict(diffs=diffs, k1=mesh_matmul.launches,
                                         k4=paged_attention_cuda.launches, pools=shapes,
                                         pool_specs=want)
    del params, state, caches, pools, lg, model
    _free(torch)

    # (b) OLMoE-1B-7B, expert parallelism: 32 of 64 experts a rank.
    ref = torch.load(os.path.join(tmp, "olmoe.pt"))
    cfg = dataclasses.replace(get_config("olmoe-1b-7b"), use_mesh_kernel=True)
    model = get_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    params = _tp_params(torch, model, ctx)
    found["olmoe_init_s"] = time.monotonic() - t0
    found["olmoe_experts"] = list(params["blocks"]["moe"]["wi"].shape[:2])
    runs = {}
    for how in ("replayed", "free"):
        reset_k1(mesh_matmul)
        grouped_mesh_matmul.launches = 0
        replay = [r.cuda() for r in ref["routes"]] if how == "replayed" else None
        t0 = time.monotonic()
        with torch.inference_mode(), routing(replay) as routes:
            prompt = ref["prompt"].cuda()[None]
            lg, state = model.prefill(params, {"tokens": prompt}, ctx)
            diffs = [(gathered(lg) - ref["logits"][0].cuda()).abs().max().item()]
            state = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, TP_MOE_STEPS))
                     for k, v in state.items()}
            for i in range(TP_MOE_STEPS):
                tok = torch.tensor([[ref["feed"][i]]], dtype=torch.int32, device="cuda")
                lg, state = model.decode(params, tok, state, TP_MOE_PROMPT + i, ctx)
                diffs.append((gathered(lg) - ref["logits"][i + 1].cuda()).abs().max().item())
        torch.cuda.synchronize()
        flips = [int(not torch.equal(a.sort(-1).values, b.cuda().sort(-1).values))
                 for a, b in zip(routes, ref["routes"])]
        runs[how] = dict(diffs=diffs, flips=flips, wall_s=time.monotonic() - t0,
                         k1=mesh_matmul.launches, k5=grouped_mesh_matmul.launches,
                         routes=[_sha(torch, r) for r in routes])
        del lg, state, routes
    found["olmoe"] = dict(runs, peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    del params, model
    _free(torch)

    # (c) Qwen2-7B, 4 layers: the chunked prefill context-parallel.
    ref = torch.load(os.path.join(tmp, "qwen2.pt"))
    cfg = dataclasses.replace(get_config("qwen2-7b"), attn_chunk=QWEN_CHUNK,
                              num_layers=TP_QWEN_LAYERS)
    model = get_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    qctx = ShardCtx(mesh, DEFAULT_RULES.replace(seq_attn="model"))
    params = _tp_params(torch, model, qctx)
    offsets, launch = [], fa.flash_attention_cuda

    def recorded(q, k, v, **kw):
        offsets.append((list(q.shape), list(k.shape), kw.get("q_offset", 0)))
        return launch(q, k, v, **kw)

    fa.flash_attention_cuda = recorded
    fa.flash_attention.launches = 0
    try:
        t0 = time.monotonic()
        with torch.inference_mode():
            prompt = ref["prompt"].cuda()[None]
            lg, _ = model.prefill(params, {"tokens": prompt}, qctx)
            at = lg[:, list(TP_QWEN_POSITIONS)].float()
            at = qctx.gather(at, ("batch", None, "vocab"), (1, len(TP_QWEN_POSITIONS),
                                                            lg.shape[-1] * world))[0]
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    finally:
        fa.flash_attention_cuda = launch
    diffs = (at - ref["logits"].cuda()).abs().amax(dim=-1).tolist()
    found["qwen2"] = dict(diffs=diffs, scale=ref["logits"].abs().max().item(), offsets=offsets,
                          k6=fa.flash_attention.launches, wall_s=wall,
                          peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    return found


def phase_serve_tp(torch):
    """Tensor-parallel serving on TP_RANKS ranks sharing the card (see the
    constants above): the parent computes the single-process references
    and plans every shard shape, the ranks serve, and the parent holds
    their K1 calls, launches and logits.  Walls and memory are printed,
    never as speeds."""
    import dataclasses
    import shutil

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serving_steps
    from repro_torch.models import get_model
    from repro_torch.models.layers import NO_SHARD

    t_phase = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="serve_tp")
    try:
        with k1_calls() as parent_calls:
            planned = plan_products(torch, tp_products(torch))
            # mesh-paper: req0's single-process prefill (the server's first
            # token) and its greedy teacher-forced logits.
            cfg = get_config("mesh-paper")
            model = get_model(cfg)
            params = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
            rng = np.random.default_rng(0)
            prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, PROMPT).astype(np.int32),
                                     device="cuda")[None]
            first = int(serving_steps(model)[0](params, {"tokens": prompt})[0][0])
            logits, feed = _tf_logits(torch, model, params, {"tokens": prompt}, TP_TF_STEPS,
                                      NO_SHARD)
            torch.save({"logits": logits[:, 0], "feed": [f[0] for f in feed], "first": first},
                       os.path.join(tmp, "mesh_paper.pt"))
            del params, model
            _free(torch)
            # OLMoE: single-process kernel path, its routing recorded.
            cfg = dataclasses.replace(get_config("olmoe-1b-7b"), use_mesh_kernel=True)
            model = get_model(cfg)
            params = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
            moe_prompt = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                                           TP_MOE_PROMPT).astype(np.int32)
            with routing() as routes:
                mlogits, mfeed = _tf_logits(
                    torch, model, params,
                    {"tokens": torch.as_tensor(moe_prompt, device="cuda")[None]}, TP_MOE_STEPS,
                    NO_SHARD)
            torch.save({"logits": mlogits[:, 0], "feed": [f[0] for f in mfeed],
                        "prompt": torch.as_tensor(moe_prompt),
                        "routes": [r.cpu() for r in routes]}, os.path.join(tmp, "olmoe.pt"))
            del params, model, routes
            _free(torch)
        # Qwen2-7B (the `torch` backend, as published): the K6 prefill.
        cfg = dataclasses.replace(get_config("qwen2-7b"), attn_chunk=QWEN_CHUNK,
                                  num_layers=TP_QWEN_LAYERS)
        model = get_model(cfg)
        params = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
        q_prompt = np.random.default_rng(2).integers(0, cfg.vocab_size,
                                                     TP_QWEN_PROMPT).astype(np.int32)
        with torch.inference_mode():
            lg, _ = model.prefill(params, {"tokens": torch.as_tensor(q_prompt, device="cuda")[None]})
            qlogits = lg[0, list(TP_QWEN_POSITIONS)].float().cpu()
        torch.save({"logits": qlogits, "prompt": torch.as_tensor(q_prompt)},
                   os.path.join(tmp, "qwen2.pt"))
        del params, model, lg
        _free(torch)
        log(f"[serve_tp] single-process references and {len(planned)} shard shapes planned in"
            f" {time.monotonic() - t_phase:.1f} s; req0's first token {first}")

        t0 = time.monotonic()
        runs = _spawn(lambda r: (
            "import chip_smoke; chip_smoke.serve_tp_rank("
            f"{r}, {TP_RANKS}, {os.path.join(tmp, 'gloo')!r}, {tmp!r})"),
            TP_RANKS, TP_TIMEOUT_S)
        wall = time.monotonic() - t0
        bad = [f"rank {r}: rc={rc} {e[-3000:]}" for r, (rc, _, e) in enumerate(runs) if rc != 0]
        check(not bad, "[serve_tp] rank failures:\n" + "\n".join(bad))
        ranks = [json.loads(Path(tmp, f"rank{r}.json").read_text()) for r in range(TP_RANKS)]
        parent_blocks = _plan_blocks()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[serve_tp] {TP_RANKS} gloo ranks on one card: {wall:.1f} s wall in all, process start,"
        " CUDA init and three models' init included (not a speed: the ranks share the card and"
        " every collective goes through host memory)")

    failed = []
    per_prefill = sum(TICK_LAUNCHES.values())
    for r, f in enumerate(ranks):
        s = f["serve"]
        c = s["counters"]
        want_k1 = per_prefill * (c["prefills"] + c["decode_steps"]) + sum(CANARY_TILES.values())
        want_k4 = get_config("mesh-paper").num_layers * c["decode_steps"]
        log(f"[serve_tp] rank {r} mesh-paper server: {REQUESTS} requests x {NEW_TOKENS} tokens,"
            f" statuses {sorted(set(s['statuses']))}, wall {s['wall_s']:.2f} s (not a speed),"
            f" peak {s['peak_gib']:.2f} GiB; heads a rank (query, kv, pool) {s['heads']};"
            f" K1 {s['k1']} (want {want_k1}: {per_prefill} x ({c['prefills']} prefills +"
            f" {c['decode_steps']} decode steps) + the canary's 2), K4 {s['k4']} (want"
            f" {want_k4}), tiles {s['tiles']}; req0's first token {s['req0'][0]} (single process"
            f" {first})")
        if (s["k1"], s["k4"]) != (want_k1, want_k4):
            failed.append(f"rank {r} server launches K1 {s['k1']} K4 {s['k4']}")
        if set(s["statuses"]) != {"ok"} or set(s["lengths"]) != {NEW_TOKENS}:
            failed.append(f"rank {r} server results {s['statuses']} {s['lengths']}")
        if s["req0"][0] != first:
            failed.append(f"rank {r} req0 first token {s['req0'][0]} != {first}")
        if s["heads"][0] != 16 // TP_RANKS:
            failed.append(f"rank {r} query heads {s['heads']}")
        old = {t: n for t, n in s["tiles"].items() if t in OLD_TILES}
        if old != CANARY_TILES:
            failed.append(f"rank {r} K1 on the first SIMT tiles {old}")
        tf = f["teacher_forced"]
        log(f"[serve_tp] rank {r} req0 teacher-forced, TP against single-process logits (prefill"
            f" then {TP_TF_STEPS} dense decode steps): max |d| per step"
            f" {[round(x, 4) for x in tf['diffs']]}, largest {max(tf['diffs']):.4f} (tol"
            f" {TP_LOGIT_TOL}); K1 {tf['k1']}")
        if max(tf["diffs"]) > TP_LOGIT_TOL or tf["k1"] != per_prefill * (1 + TP_TF_STEPS):
            failed.append(f"rank {r} teacher-forced {tf}")
        pt = f["paged_teacher_forced"]
        want_k4 = get_config("mesh-paper").num_layers * TP_TF_STEPS
        log(f"[serve_tp] rank {r} req0 teacher-forced through paged decode (pools {pt['pools']['k']},"
            f" the rank's read kv heads): TP paged against single-process dense logits, max |d|"
            f" per step {[round(x, 4) for x in pt['diffs']]}, largest {max(pt['diffs']):.4f} (tol"
            f" {TP_LOGIT_TOL}); K1 {pt['k1']} K4 {pt['k4']} (want {want_k4})")
        if (max(pt["diffs"]) > TP_LOGIT_TOL or pt["k4"] != want_k4
                or pt["k1"] != per_prefill * (1 + TP_TF_STEPS) or pt["pools"] != pt["pool_specs"]
                or pt["pools"]["k"][3] != TP_DECODE[2]):
            failed.append(f"rank {r} paged teacher-forced {pt}")
        o = f["olmoe"]
        for how, run in o.items():
            if how == "peak_gib":
                continue
            steps = [run["flips"][i * OLMOE_LAYERS:(i + 1) * OLMOE_LAYERS]
                     for i in range(1 + TP_MOE_STEPS)]
            clean = [d for d, st in zip(run["diffs"], steps) if not any(st)]
            n_flips = sum(run["flips"])
            want = (MOE_STEP_LAUNCHES["mesh_matmul"] * (1 + TP_MOE_STEPS),
                    MOE_STEP_LAUNCHES["grouped_mesh_matmul"] * (1 + TP_MOE_STEPS))
            tol = TP_MOE_REPLAY_TOL if how == "replayed" else TP_MOE_FREE_TOL
            log(f"[serve_tp] rank {r} OLMoE EP ({f['olmoe_experts'][1]} experts a rank),"
                f" {how} routing: max |d| per step {[round(x, 4) for x in run['diffs']]},"
                f" held at {len(clean)} of {1 + TP_MOE_STEPS} steps (no flipped layer), largest"
                f" {max(clean, default=0.0):.4f} (tol {tol}); flipped (step, layer) sets {n_flips}"
                f" of {len(run['flips'])} (tol {TP_MOE_FLIP_TOL}); K1 {run['k1']} K5 {run['k5']}"
                f" (want {want}); wall {run['wall_s']:.2f} s (not a speed)")
            if (run["k1"], run["k5"]) != want:
                failed.append(f"rank {r} OLMoE {how} launches {run['k1']} {run['k5']}")
            if max(clean, default=0.0) > tol or n_flips > TP_MOE_FLIP_TOL:
                failed.append(f"rank {r} OLMoE {how}: {run}")
            if how == "replayed" and (n_flips or len(clean) != 1 + TP_MOE_STEPS):
                failed.append(f"rank {r} OLMoE replay flipped {n_flips}")
            if run["routes"] != ranks[0]["olmoe"][how]["routes"]:
                failed.append(f"rank {r} OLMoE {how}: its routing differs from rank 0's")
        log(f"[serve_tp] rank {r} OLMoE peak {o['peak_gib']:.2f} GiB, init {f['olmoe_init_s']:.1f} s")
        q = f["qwen2"]
        want_off = [(TP_QWEN_PROMPT // TP_RANKS) * r] * TP_QWEN_LAYERS
        log(f"[serve_tp] rank {r} Qwen2-7B ({TP_QWEN_LAYERS} of {QWEN_LAYERS} layers) {TP_QWEN_PROMPT}"
            f"-token prefill, seq_attn on 'model': K6 {q['k6']} launches at (q, k, q_offset)"
            f" {q['offsets']}; logits at positions {TP_QWEN_POSITIONS} against the"
            f" single-process K6 prefill: max |d| {[round(x, 4) for x in q['diffs']]} on logits"
            f" up to {q['scale']:.2f} (tol {TP_QWEN_TOL}); wall {q['wall_s']:.2f} s (not a"
            f" speed), peak {q['peak_gib']:.2f} GiB")
        if q["k6"] != TP_QWEN_LAYERS or [o[2] for o in q["offsets"]] != want_off:
            failed.append(f"rank {r} Qwen2 K6 {q['k6']} {q['offsets']}")
        if max(q["diffs"]) > TP_QWEN_TOL:
            failed.append(f"rank {r} Qwen2 logits {q['diffs']}")
        moved = {k: (v, parent_blocks.get(k)) for k, v in f["blocks"].items()
                 if k in parent_blocks and parent_blocks[k] != v}
        if moved:
            failed.append(f"rank {r} planned other blocks than this process: {moved}")
    calls = parent_calls | {_as_key(key) for f in ranks for key in f["k1_calls"]}
    here, before = hold_k1_keys(torch, "serve_tp", calls)
    log(f"[serve_tp] {len(calls)} distinct K1 calls of the parent and the ranks: {before} held by"
        f" [K1]/[K1 train] before, {here} held here on the same blocks")
    k4_held, k5_held, k6_held = hold_k4_k5_calls(
        torch, "serve_tp", {_as_key(x) for f in ranks for x in f["k4_calls"]},
        {_as_key(x) for f in ranks for x in f["k5_calls"]},
        {_as_key(x) for f in ranks for x in f["k6_calls"]})
    log(f"[serve_tp] the ranks' distinct K4 calls ({k4_held}: shapes, table and lengths), K5"
        f" calls ({k5_held}: shapes, blocks and group sizes) and K6 calls ({k6_held}: shapes,"
        " mask and query offset) each held against the plain version at [K4]'s, [K5]'s and"
        " [K6]'s limits")
    if not k4_held or not k5_held or not k6_held:
        failed.append(f"K4/K5/K6 calls recorded: {k4_held} {k5_held} {k6_held}")
    check(not failed, "[serve_tp] failed:\n" + "\n".join(failed))
    return {"mesh_matmul": sum(f["serve"]["k1"] + f["teacher_forced"]["k1"]
                               + f["paged_teacher_forced"]["k1"]
                               + sum(f["olmoe"][h]["k1"] for h in ("replayed", "free"))
                               for f in ranks),
            "paged_attention": sum(f["serve"]["k4"] + f["paged_teacher_forced"]["k4"]
                                   for f in ranks),
            "grouped_mesh_matmul": sum(f["olmoe"][h]["k5"] for f in ranks
                                       for h in ("replayed", "free")),
            "flash_attention": sum(f["qwen2"]["k6"] for f in ranks)}


# [serve_tp_families]: tensor-parallel serving of the other families, and the
# continuous-batching server with its slots split over 'data', on ranks that
# share the card (gloo, every collective staged through host memory).  RWKV-6
# 1.6B, Zamba2-1.2B and Whisper-medium at full width through tuned() on 1x2
# (ranks 0-1: 16 of 32 WKV heads, 32 of 64 SSM heads and 16 of 32 attention
# heads, 8 of 16 heads a rank), then mesh-paper through the server on 2x1
# (ranks 0-1, 2 of its 4 slots a data rank) and on 2x2 (all 4 ranks, 2 slots
# and 8 of 16 heads a rank).  The parent computes every single-process
# reference and plans every shard shape first, so the ranks read its
# autotune cache.
TPF_RANKS, TPF_TIMEOUT_S = 4, 600
TPF_TF_STEPS = 8  # teacher-forced decode steps after each prefill
TPF_SERVER_MESHES = ((2, 1), (2, 2))
# Zamba2's prefill logits are compared at these positions (both sides of
# K6's 1024-key chunk boundary), Whisper's at these of its decoder prompt.
TPF_ZAMBA_POSITIONS = (0, 1023, 1024, ZAMBA_PROMPT - 1)
TPF_WHISPER_POSITIONS = (0, 127, 128, WHISPER_PROMPT - 1)
# Limits of the teacher-forced TP logits against the single-process ones
# (prefill and every decode step), each about 3x its first reading (NVIDIA
# H100 80GB HBM3, both ranks alike; PERF.md): RWKV-6 0.2695 (24 layers of
# bf16 roundings, as its chunked WKV against the scan reads 0.2622),
# Zamba2 0.0901, Whisper 0.0713, mesh-paper's device steps on 2x2 0.0547.
# On 2x1 the decode step of 2 slots a rank runs the single process's
# products on the same blocks (a slot's row stays in K1's tile 0), so its
# logits and tokens are held bitwise.  RWKV-6's f32 witness: req0's
# prefill with f32 weights and activations on the `torch` backend, TP
# against single-process: 4.208e-05 at first.
TPF_TOL = {"rwkv": 0.8, "zamba": 0.27, "whisper": 0.21, "server": 0.165}
TPF_RWKV_F32_TOL = 1.3e-4


def tp_family_products(torch):
    """[serve_tp_families]' K1 products on a rank, (label, M, K, N, out
    dtype): each family's column-parallel projections (a rank's heads, its
    gate and up slices, Mamba2's [z | x | B | C | dt] of its SSM heads, its
    vocab rows), its row-parallel ones (f32 partial sums) and its replicated
    ones, at each M the phase runs them; mesh-paper's at 2 slots a data
    rank whole (2x1) and on 8 heads (2x2), and at a prefill's 128 rows."""
    from repro_torch.configs import get_config
    from repro_torch.models.attention import head_layout
    from repro_torch.models.layers import padded_vocab

    f32 = torch.float32
    out = []

    def add(name, prods, ms):
        for m in ms:
            out.extend((f"{name} {label} M={m}", m, k, n, dt) for label, k, n, dt in prods)

    def dense(cfg, ctx):
        d, hd = cfg.d_model, cfg.head_dim_
        lay, mlp = head_layout(cfg, ctx), ctx.part("mlp", cfg.d_ff)
        split = lay.q.count > 1
        return [("wq", d, lay.q.size * hd, None), ("wk|wv", d, lay.kv.size * hd, None),
                ("wo", lay.q.size * hd, d, f32 if split else None),
                ("wi", d, 2 * mlp.size, None),
                ("mlp wo", mlp.size, d, f32 if mlp.count > 1 else None)]

    def head(cfg, ctx):
        return [("head", cfg.d_model, ctx.part("vocab", padded_vocab(cfg)).size, None)]

    ctx = _tp_ctx(2)
    cfg = get_config("rwkv6-1.6b")
    d, hp, fp = cfg.d_model, ctx.part("heads", cfg.num_heads), ctx.part("mlp", cfg.d_ff)
    cols = hp.size * cfg.head_dim_
    add("rwkv", [("wr|wk|wv|wg", d, cols, None), ("wo", cols, d, f32),
                 ("cm_wk", d, fp.size, None), ("cm_wv", fp.size, d, f32), ("cm_wr", d, d, None)]
        + head(cfg, ctx), (1, SLOTS, PROMPT))
    cfg = get_config("zamba2-1.2b")
    d_in, n = cfg.ssm_expand * cfg.d_model, cfg.ssm_state_size
    hs = ctx.part("mlp", cfg.ssm_num_heads)
    p = d_in // cfg.ssm_num_heads
    add("zamba", [("in_proj", cfg.d_model, 2 * hs.size * p + 2 * n + hs.size, None),
                  ("out_proj", hs.size * p, cfg.d_model, f32)] + dense(cfg, ctx) + head(cfg, ctx),
        ZAMBA_MS)
    cfg = get_config("whisper-medium")
    add("whisper", [("frame_proj", cfg.d_model, cfg.d_model, None)] + dense(cfg, ctx)
        + head(cfg, ctx), WHISPER_MS)
    cfg = get_config("mesh-paper")
    whole = _tp_ctx(1)
    add("mesh-paper 2x1", dense(cfg, whole) + head(cfg, whole), (2, PROMPT))
    add("mesh-paper 2x2", dense(cfg, ctx) + head(cfg, ctx), (2, PROMPT))
    return out


@contextlib.contextmanager
def _counted(torch):
    """Resets K1's, K4's and K6's launch counters and the peak memory; the
    yielded dict gets, at the block's end, the launches (k1, k4, k6), the
    wall and the peak (GiB) of the block."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.mesh_matmul import mesh_matmul
    from repro_torch.kernels.paged_attention import paged_attention_cuda

    torch.cuda.synchronize()
    reset_k1(mesh_matmul)
    flash_attention.launches = paged_attention_cuda.launches = 0
    torch.cuda.reset_peak_memory_stats()
    got, t0 = {}, time.monotonic()
    yield got
    torch.cuda.synchronize()
    got.update(k1=mesh_matmul.launches, k4=paged_attention_cuda.launches,
               k6=flash_attention.launches, wall_s=time.monotonic() - t0,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)


def _tf_logits(torch, model, params, batch, steps, ctx, feed=None, positions=None):
    """`batch` prefilled, then `steps` decode steps with the caches
    `generate` grows, fed `feed` ((steps, B) tokens) or, without it, each
    step's greedy argmax; under `ctx` the logits are gathered whole.
    Returns (the prefill's logits at `positions` (default: the last) then
    each step's, (P + steps, B, V) f32 on the host; the tokens fed)."""
    from repro_torch.launch.serve import _GROWN_CACHES
    from repro_torch.models.layers import padded_vocab
    from repro_torch.train.train_step import _local_rows

    b, t = batch["tokens"].shape
    c, vocab = ctx.for_rows(b), padded_vocab(model.cfg)
    grown = _GROWN_CACHES[model.cfg.family]

    def whole(lg):  # (rows, P, vocab block) -> (B, P, V)
        return c.gather(lg.float(), ("batch", None, "vocab"), (b, lg.shape[1], vocab))

    with torch.inference_mode():
        lg, state = model.prefill(params, _local_rows(batch, c), c)
        rows = [whole(lg[:, list(positions or (t - 1,))]).transpose(0, 1)]
        last = whole(lg[:, -1:])[:, 0]
        del lg
        state = {k: (torch.nn.functional.pad(v, (0, 0, 0, 0, 0, steps))
                     if grown is None or k in grown else v) for k, v in state.items()}
        fed = []
        for i in range(steps):
            tok = (last.argmax(-1).to(torch.int32) if feed is None
                   else torch.tensor(feed[i], dtype=torch.int32, device="cuda"))
            fed.append(tok.tolist())
            lg, state = model.decode(params, _local_rows({"t": tok[:, None]}, c)["t"], state,
                                     t + i, c)
            last = whole(lg)[:, 0]
            rows.append(last[None])
    return torch.cat(rows).cpu(), fed


def _slots_tf(torch, model, params, prompts, steps, ctx, feed=None):
    """The server's device steps on [serve]'s first SLOTS prompts: each
    prefilled alone (a batch of 1, replicated under a mesh, as the server
    runs it), its caches on its own pages, then `steps` paged decode steps
    of the SLOTS slots fed `feed` ((steps, SLOTS) tokens) or their own
    greedy tokens; under `ctx` each rank runs its block of the slot rows.
    Returns ((1 + steps, SLOTS, V) f32 logits on the host, the tokens
    fed)."""
    from repro_torch.models.attention import head_layout
    from repro_torch.models.layers import padded_vocab

    cfg, vocab = model.cfg, padded_vocab(model.cfg)
    c1, c = ctx.for_rows(1), ctx.for_rows(SLOTS)
    mine, lay = c.part("batch", SLOTS), head_layout(cfg, ctx)
    n_pages = -(-(PROMPT + steps) // PAGE)
    pools = {k: torch.zeros(shape, dtype=dt, device="cuda") for k, (shape, dt)
             in model.paged_pool_specs(1 + SLOTS * n_pages, PAGE, ctx).items()}
    tables = torch.arange(1, 1 + SLOTS * n_pages, dtype=torch.int32,
                          device="cuda").reshape(SLOTS, n_pages)
    lo, hi = mine.start, mine.start + mine.size
    with torch.inference_mode():
        firsts = []
        for s in range(SLOTS):
            prompt = torch.as_tensor(prompts[s], device="cuda")[None]
            lg, caches = model.prefill(params, {"tokens": prompt}, c1)
            firsts.append(c1.gather(lg[:, -1].float(), ("batch", "vocab"), (1, vocab))[0])
            for name in ("k", "v"):  # (L, 1, T, kv, hd): the read heads on the slot's pages
                kv = torch.nn.functional.pad(lay.select(caches[name][:, 0], 2),
                                             (0, 0, 0, 0, 0, n_pages * PAGE - PROMPT))
                pools[name][:, tables[s].long()] = kv.reshape(
                    kv.shape[0], n_pages, PAGE, *kv.shape[2:]).to(pools[name].dtype)
            del lg, caches
        last = torch.stack(firsts)
        rows, fed = [last], []
        for i in range(steps):
            tok = (last.argmax(-1).to(torch.int32) if feed is None
                   else torch.tensor(feed[i], dtype=torch.int32, device="cuda"))
            fed.append(tok.tolist())
            pos = torch.full((mine.size,), PROMPT + i, dtype=torch.int32, device="cuda")
            lg, pools = model.paged_decode(params, tok[lo:hi, None], pools, tables[lo:hi], pos, c)
            last = c.gather(lg[:, -1].float(), ("batch", "vocab"), (SLOTS, vocab))
            rows.append(last)
    return torch.stack(rows).cpu(), fed


def _tf_diffs(got, want, vocab):
    """max |d| of each row of two (P + steps, B, V) logit stacks over the
    real vocab entries."""
    return (got[..., :vocab] - want[..., :vocab]).abs().amax(dim=(1, 2)).tolist()


def _family_cfgs():
    """The three families as [serve_rwkv], [serve_zamba] and [serve_whisper]
    run them: tuned(), on the kernel path."""
    import dataclasses

    from repro_torch.configs import get_config

    return {name: dataclasses.replace(get_config(arch).tuned(), use_mesh_kernel=True)
            for name, arch in (("rwkv", "rwkv6-1.6b"), ("zamba", "zamba2-1.2b"),
                               ("whisper", "whisper-medium"))}


def _family_inputs(torch, name, cfg):
    """The phases' seeded inputs: [serve_rwkv]'s prompts (a list of
    REQUESTS arrays), [serve_zamba]'s 2 x 2048 prompts, [serve_whisper]'s
    frames and 256-token prompts (as batches on the card)."""
    import numpy as np

    rng = np.random.default_rng(0)
    if name == "rwkv":
        return [rng.integers(0, cfg.vocab_size, PROMPT).astype(np.int32) for _ in range(REQUESTS)]
    if name == "zamba":
        return {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, ZAMBA_PROMPT))
                                          .astype(np.int32), device="cuda")}
    frames = rng.normal(size=(2, WHISPER_FRAMES, cfg.d_model)).astype(np.float32)
    prompt = rng.integers(0, cfg.vocab_size, (2, WHISPER_PROMPT)).astype(np.int32)
    return {"frames": torch.as_tensor(frames, device="cuda"),
            "tokens": torch.as_tensor(prompt, device="cuda")}


def _f32_model(torch, model, params):
    """The model with f32 weights and activations on the `torch` backend
    (cuBLAS, TF32 off), and `params` in f32 (the bf16 tree freed): a witness
    of the model code's arithmetic, K1's f32 products being held by [K1]
    and [K1 train]."""
    import dataclasses

    from repro_torch.models import get_model
    from repro_torch.tree import tree_map

    params = tree_map(lambda t: t.float(), params)
    _free(torch)
    return get_model(dataclasses.replace(model.cfg, param_dtype="float32",
                                         activation_dtype="float32",
                                         use_mesh_kernel=False)), params


def serve_tp_families_rank(rank, world, init, tmp):
    """One rank of [serve_tp_families] (run by the phase in its own
    process): its findings, K1, K4 and K6 calls and plans' blocks go to tmp
    as JSON."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank, world_size=world)
    with k1_calls() as calls, k4_k5_calls() as (k4, k5, k6):
        found = _serve_tp_families_rank(torch, rank, tmp)
    found["k1_calls"] = sorted(calls, key=str)
    found["k4_calls"], found["k6_calls"] = sorted(k4, key=str), sorted(k6, key=str)
    found["k5_calls"] = len(k5)
    found["blocks"] = _plan_blocks()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(found, f)
    dist.destroy_process_group()


def _serve_tp_families_rank(torch, rank, tmp):
    """serve_tp_families_rank's work, in its process group."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.scheduler import ContinuousBatchingServer, Request, ServeConfig
    from repro_torch.launch.serve import generate
    from repro_torch.models import get_model
    from repro_torch.models.attention import head_layout
    from repro_torch.models.layers import ShardCtx

    meshes = {s: make_local_mesh(s, ("data", "model")) for s in ((1, 2),) + TPF_SERVER_MESHES}
    found = {}
    if rank < 2:
        ctx = ShardCtx(meshes[(1, 2)])
        cfgs = _family_cfgs()
        # (a) RWKV-6 1.6B: req0 through generate, the 8 requests through
        # the 4-slot server, req0 teacher-forced.
        ref = torch.load(os.path.join(tmp, "rwkv.pt"))
        model = get_model(cfgs["rwkv"])
        params = _tp_params(torch, model, ctx)
        prompts = _family_inputs(torch, "rwkv", model.cfg)
        prompt = torch.as_tensor(prompts[0], device="cuda")[None]
        with _counted(torch) as gen:
            toks, _ = generate(model, params, prompt, gen_len=NEW_TOKENS, ctx=ctx)
        gen["tokens"] = toks[0].tolist()
        scfg = ServeConfig(max_slots=SLOTS, queue_capacity=REQUESTS, warmup_prompt_lens=(PROMPT,))
        with _counted(torch) as srv:
            server = ContinuousBatchingServer(model, params, scfg, ctx, device="cuda")
            server.warmup()
            results = server.run([Request(rid=f"req{i}", prompt=p, max_new_tokens=NEW_TOKENS)
                                  for i, p in enumerate(prompts)])
        srv.update(counters=dict(server.counters), wkv=list(server.state["wkv"].shape),
                   statuses=[r.status for r in results.values()],
                   lengths=[len(r.tokens) for r in results.values()],
                   req0=results["req0"].tokens)
        del server
        with _counted(torch) as tf:
            logits, _ = _tf_logits(torch, model, params, {"tokens": prompt}, TPF_TF_STEPS, ctx,
                                   feed=ref["feed"])
        tf["diffs"] = _tf_diffs(logits, ref["logits"], model.cfg.vocab_size)
        tf["first"] = int(logits[0, 0].argmax())
        del logits
        with _counted(torch) as f32:
            model, params = _f32_model(torch, model, params)
            logits, _ = _tf_logits(torch, model, params, {"tokens": prompt}, 0, ctx)
        f32.update(diff=_tf_diffs(logits, ref["f32_logits"], model.cfg.vocab_size)[0],
                   first=int(logits[0, 0].argmax()))
        found["rwkv"] = dict(generate=gen, server=srv, tf=tf, f32=f32)
        del params, model, logits
        _free(torch)
        # (b) Zamba2-1.2B and (c) Whisper-medium: [serve_zamba]'s and
        # [serve_whisper]'s batches prefilled, then teacher-forced steps.
        for name, positions in (("zamba", TPF_ZAMBA_POSITIONS),
                                ("whisper", TPF_WHISPER_POSITIONS)):
            ref = torch.load(os.path.join(tmp, f"{name}.pt"))
            model = get_model(cfgs[name])
            params = _tp_params(torch, model, ctx)
            with _counted(torch) as tf:
                logits, _ = _tf_logits(torch, model, params,
                                       _family_inputs(torch, name, model.cfg), TPF_TF_STEPS,
                                       ctx, feed=ref["feed"], positions=positions)
            tf["diffs"] = _tf_diffs(logits, ref["logits"], model.cfg.vocab_size)
            tf["scale"] = ref["logits"][..., :model.cfg.vocab_size].abs().max().item()
            lay = head_layout(model.cfg, ctx)
            tf["heads"] = [lay.q.size, lay.kv.size]
            if name == "zamba":
                tf["ssm_heads"] = ctx.part("mlp", model.cfg.ssm_num_heads).size
                tf["in_proj"] = list(params["mamba_seg"]["in_proj"].shape)
            found[name] = tf
            del params, model, logits
            _free(torch)
    # (d) mesh-paper through the server on 2x1 (ranks 0-1) and 2x2 (all).
    ref = torch.load(os.path.join(tmp, "mesh_paper.pt"))
    prompts = list(ref["prompts"].numpy())
    cfg = get_config("mesh-paper")
    for shape in TPF_SERVER_MESHES:
        dist.barrier()  # the ranks not in the 2x1 mesh wait here, not in a collective
        if rank >= shape[0] * shape[1]:
            continue
        ctx = ShardCtx(meshes[shape])
        model = get_model(cfg)
        params = _tp_params(torch, model, ctx)
        pages = -(-(PROMPT + NEW_TOKENS) // PAGE)
        scfg = ServeConfig(max_slots=SLOTS, page_size=PAGE, num_pages=1 + SLOTS * pages,
                           max_pages_per_seq=pages, queue_capacity=REQUESTS,
                           warmup_prompt_lens=(PROMPT,))
        with _counted(torch) as srv:
            server = ContinuousBatchingServer(model, params, scfg, ctx, device="cuda")
            server.warmup()
            results = server.run([Request(rid=f"req{i}", prompt=p, max_new_tokens=NEW_TOKENS)
                                  for i, p in enumerate(prompts)])
        lay = head_layout(cfg, ctx)
        srv.update(counters=dict(server.counters), rows=[server._rows.start, server._rows.size],
                   heads=[lay.q.size, lay.kv.size, len(lay.read)],
                   pool=list(server.pools["k"].shape),
                   statuses=[r.status for r in results.values()],
                   tokens={rid: r.tokens for rid, r in results.items()})
        del server
        with _counted(torch) as tf:
            logits, _ = _slots_tf(torch, model, params, prompts, TPF_TF_STEPS, ctx,
                                  feed=ref["feed"])
        tf["diffs"] = _tf_diffs(logits, ref["logits"], cfg.vocab_size)
        found[f"server {shape[0]}x{shape[1]}"] = dict(server=srv, tf=tf)
        del params, model, logits
        _free(torch)
    return found


def phase_serve_tp_families(torch):
    """RWKV-6, Zamba2 and Whisper tensor-parallel on 1x2 and mesh-paper's
    server on 2x1 and 2x2, on TPF_RANKS ranks sharing the card (see the
    constants above): the parent computes the single-process references
    and plans every shard shape, the ranks serve, and the parent holds
    their launches, tokens and logits and every K1, K4 and K6 call they
    made against its plain version.  Walls and memory are printed, never
    as speeds."""
    import shutil

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.scheduler import ContinuousBatchingServer, Request, ServeConfig
    from repro_torch.launch.serve import generate, serving_steps
    from repro_torch.models import get_model
    from repro_torch.models.layers import NO_SHARD

    t_phase = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="serve_tp_families")
    cfgs = _family_cfgs()
    try:
        with k1_calls() as parent_calls:
            planned = plan_products(torch, tp_family_products(torch))
            # RWKV-6: req0's first token and generate's tokens, single-process,
            # and its greedy teacher-forced logits.
            model, params = _init_full_width(torch, "serve_tp_families", cfgs["rwkv"])
            prompts = _family_inputs(torch, "rwkv", model.cfg)
            prompt = torch.as_tensor(prompts[0], device="cuda")[None]
            first = int(serving_steps(model)[0](params, {"tokens": prompt})[0][0])
            gen_tokens = generate(model, params, prompt, gen_len=NEW_TOKENS)[0][0].tolist()
            logits, feed = _tf_logits(torch, model, params, {"tokens": prompt}, TPF_TF_STEPS,
                                      NO_SHARD)
            top2 = logits[0, 0, :model.cfg.vocab_size].topk(2).values.tolist()
            model, params = _f32_model(torch, model, params)
            f32_logits, _ = _tf_logits(torch, model, params, {"tokens": prompt}, 0, NO_SHARD)
            torch.save({"logits": logits, "feed": feed, "f32_logits": f32_logits},
                       os.path.join(tmp, "rwkv.pt"))
            ref_logits = logits
            del model, params
            for name, positions in (("zamba", TPF_ZAMBA_POSITIONS),
                                    ("whisper", TPF_WHISPER_POSITIONS)):
                model, params = _init_full_width(torch, "serve_tp_families", cfgs[name])
                logits, feed = _tf_logits(torch, model, params,
                                          _family_inputs(torch, name, model.cfg), TPF_TF_STEPS,
                                          NO_SHARD, positions=positions)
                torch.save({"logits": logits, "feed": feed}, os.path.join(tmp, f"{name}.pt"))
                del model, params
            # mesh-paper: the single-process server's tokens, and the greedy
            # teacher-forced logits of its device steps on 4 slots.
            cfg = get_config("mesh-paper")
            model, params = _init_full_width(torch, "serve_tp_families", cfg)
            rng = np.random.default_rng(0)
            mp_prompts = [rng.integers(0, cfg.vocab_size, PROMPT).astype(np.int32)
                          for _ in range(REQUESTS)]
            pages = -(-(PROMPT + NEW_TOKENS) // PAGE)
            scfg = ServeConfig(max_slots=SLOTS, page_size=PAGE, num_pages=1 + SLOTS * pages,
                               max_pages_per_seq=pages, queue_capacity=REQUESTS,
                               warmup_prompt_lens=(PROMPT,))
            server = ContinuousBatchingServer(model, params, scfg, device="cuda")
            server.warmup()
            single = {rid: r.tokens for rid, r in server.run(
                [Request(rid=f"req{i}", prompt=p, max_new_tokens=NEW_TOKENS)
                 for i, p in enumerate(mp_prompts)]).items()}
            del server
            logits, feed = _slots_tf(torch, model, params, mp_prompts, TPF_TF_STEPS, NO_SHARD)
            torch.save({"logits": logits, "feed": feed,
                        "prompts": torch.as_tensor(np.stack(mp_prompts))},
                       os.path.join(tmp, "mesh_paper.pt"))
            del model, params
            _free(torch)
        log(f"[serve_tp_families] single-process references and {len(planned)} shard shapes"
            f" planned in {time.monotonic() - t_phase:.1f} s; RWKV-6 req0's first token {first}")

        t0 = time.monotonic()
        runs = _spawn(lambda r: (
            "import chip_smoke; chip_smoke.serve_tp_families_rank("
            f"{r}, {TPF_RANKS}, {os.path.join(tmp, 'gloo')!r}, {tmp!r})"),
            TPF_RANKS, TPF_TIMEOUT_S)
        wall = time.monotonic() - t0
        bad = [f"rank {r}: rc={rc} {e[-3000:]}" for r, (rc, _, e) in enumerate(runs) if rc != 0]
        check(not bad, "[serve_tp_families] rank failures:\n" + "\n".join(bad))
        ranks = [json.loads(Path(tmp, f"rank{r}.json").read_text()) for r in range(TPF_RANKS)]
        parent_blocks = _plan_blocks()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[serve_tp_families] {TPF_RANKS} gloo ranks on one card: {wall:.1f} s wall in all,"
        " process start, CUDA init and every model's init included (not a speed: the ranks"
        " share the card and every collective goes through host memory)")

    failed = []

    def launches(tag, got, want):
        ok = all(got[k] == v for k, v in want.items())
        if not ok:
            failed.append(f"{tag}: launches {[got[k] for k in want]} != {want}")
        return (f"K1 {got['k1']} K4 {got['k4']} K6 {got['k6']} (want"
                f" {', '.join(f'{k.upper()} {v}' for k, v in want.items())})")

    def held(tag, tf, tol, extra=""):
        worst = max(tf["diffs"])
        if not worst <= tol:
            failed.append(f"{tag}: teacher-forced max |d| {worst} > {tol}")
        return (f"max |d| per row {[round(x, 4) for x in tf['diffs']]}, largest {worst:.4f}"
                f" (tol {tol}){extra}")

    def spent(got):
        return f"wall {got['wall_s']:.2f} s (not a speed), peak {got['peak_gib']:.2f} GiB"

    rw, zm, wh = (RWKV_STEP_LAUNCHES, ZAMBA_STEP_LAUNCHES, WHISPER_DEC_LAUNCHES)
    f32_first = int(f32_logits[0, 0].argmax())
    per_tick = sum(TICK_LAUNCHES.values())
    layers = get_config("mesh-paper").num_layers
    for r, f in enumerate(ranks):
        if r < 2:
            g, s, tf = f["rwkv"]["generate"], f["rwkv"]["server"], f["rwkv"]["tf"]
            c = s["counters"]
            log(f"[serve_tp_families] rank {r} RWKV-6 1x2 (wkv state {s['wkv']}): generate"
                f" {NEW_TOKENS} tokens, {sum(a == b for a, b in zip(g['tokens'], gen_tokens))}"
                f" of {NEW_TOKENS} equal to the single process's, "
                + launches(f"rank {r} RWKV generate", g, dict(k1=rw * NEW_TOKENS, k4=0, k6=0))
                + f", {spent(g)}")
            x = f["rwkv"]["f32"]
            gap = top2[0] - ref_logits[0, 0, s["req0"][0]].item()
            log(f"[serve_tp_families] rank {r} RWKV-6 server {REQUESTS} x {NEW_TOKENS} on"
                f" {SLOTS} slots: statuses {sorted(set(s['statuses']))}, req0's first token"
                f" {s['req0'][0]} (single process {first}; its logit {gap:.4f} below the single"
                f" process's top, whose top-2 gap is {top2[0] - top2[1]:.4f}), "
                + launches(f"rank {r} RWKV server", s,
                           dict(k1=rw * (c["prefills"] + c["decode_steps"]) + 2, k4=0, k6=0))
                + f" ({c['prefills']} prefills + {c['decode_steps']} decode steps), {spent(s)}")
            if set(s["statuses"]) != {"ok"} or set(s["lengths"]) != {NEW_TOKENS}:
                failed.append(f"rank {r} RWKV server results {s['statuses']} {s['lengths']}")
            # bf16: the first token may flip only at a near-tie, one whose gap
            # two logits moved by the measured TP prefill |d| can close; f32:
            # equal, within its limit.
            if s["req0"][0] != tf["first"] or (s["req0"][0] != first
                                               and not gap <= 2 * tf["diffs"][0]):
                failed.append(f"rank {r} RWKV req0 first token {s['req0'][0]} (teacher-forced"
                              f" {tf['first']}) vs {first}, gap {gap} > 2 |d| {tf['diffs'][0]}")
            log(f"[serve_tp_families] rank {r} RWKV-6 f32 witness (req0's prefill, f32 weights"
                f" and activations, the torch backend): TP against single-process logits max |d|"
                f" {x['diff']:.3e} (tol {TPF_RWKV_F32_TOL}), first token {x['first']} (single"
                f" process {f32_first}); "
                + launches(f"rank {r} RWKV f32", x, dict(k1=0, k4=0, k6=0))
                + f", {spent(x)}")
            if not x["diff"] <= TPF_RWKV_F32_TOL or x["first"] != f32_first:
                failed.append(f"rank {r} RWKV f32 witness {x['diff']} first {x['first']}")
            if s["wkv"] != [RWKV_LAYERS, SLOTS, 16, 64, 64]:
                failed.append(f"rank {r} RWKV stacked state {s['wkv']}")
            log(f"[serve_tp_families] rank {r} RWKV-6 req0 teacher-forced (prefill + {TPF_TF_STEPS}"
                f" steps), TP against single-process logits: "
                + held(f"rank {r} RWKV", tf, TPF_TOL["rwkv"]) + "; "
                + launches(f"rank {r} RWKV tf", tf, dict(k1=rw * (1 + TPF_TF_STEPS), k4=0, k6=0))
                + f", {spent(tf)}")
            z = f["zamba"]
            log(f"[serve_tp_families] rank {r} Zamba2 1x2 ({z['ssm_heads']} SSM heads, (query, kv)"
                f" heads {z['heads']}, in_proj {z['in_proj']}): 2 x {ZAMBA_PROMPT} prefill at"
                f" positions {TPF_ZAMBA_POSITIONS} then {TPF_TF_STEPS} teacher-forced steps: "
                + held(f"rank {r} Zamba2", z, TPF_TOL["zamba"], f" on logits up to {z['scale']:.2f}")
                + "; " + launches(f"rank {r} Zamba2", z,
                                  dict(k1=zm * (1 + TPF_TF_STEPS), k4=0, k6=ZAMBA_APPS))
                + f", {spent(z)}")
            if z["ssm_heads"] != 32 or z["heads"] != [16, 16]:
                failed.append(f"rank {r} Zamba2 heads {z['ssm_heads']} {z['heads']}")
            w = f["whisper"]
            log(f"[serve_tp_families] rank {r} Whisper 1x2 ((query, kv) heads {w['heads']}):"
                f" 2 x {WHISPER_FRAMES} frames, {WHISPER_PROMPT}-token prompt at positions"
                f" {TPF_WHISPER_POSITIONS}, then {TPF_TF_STEPS} teacher-forced steps: "
                + held(f"rank {r} Whisper", w, TPF_TOL["whisper"],
                       f" on logits up to {w['scale']:.2f}")
                + "; " + launches(f"rank {r} Whisper", w,
                                  dict(k1=WHISPER_ENC_LAUNCHES + wh * (1 + TPF_TF_STEPS), k4=0,
                                       k6=WHISPER_LAYERS))
                + f", {spent(w)}")
            if w["heads"] != [8, 8]:
                failed.append(f"rank {r} Whisper heads {w['heads']}")
        for d, m in TPF_SERVER_MESHES:
            if r >= d * m:
                continue
            s, tf = f[f"server {d}x{m}"]["server"], f[f"server {d}x{m}"]["tf"]
            c = s["counters"]
            same = [rid for rid in sorted(single) if s["tokens"][rid] == single[rid]]
            firsts = sum(s["tokens"][rid][0] == single[rid][0] for rid in single)
            diverge = {rid: next(i for i, (a, b) in enumerate(zip(s["tokens"][rid], single[rid]))
                                 if a != b) for rid in single if rid not in same}
            log(f"[serve_tp_families] rank {r} mesh-paper server {d}x{m} (slot rows {s['rows']},"
                f" heads (query, kv, pool) {s['heads']}, pool {s['pool']}): {REQUESTS} x"
                f" {NEW_TOKENS} tokens, statuses {sorted(set(s['statuses']))}; requests equal to"
                f" the single-process server's: {len(same)} of {REQUESTS}, first tokens {firsts}"
                f" of {REQUESTS}, first differing token {diverge}; "
                + launches(f"rank {r} server {d}x{m}", s,
                           dict(k1=per_tick * (c["prefills"] + c["decode_steps"])
                                + sum(CANARY_TILES.values()), k4=layers * c["decode_steps"],
                                k6=0))
                + f" ({c['prefills']} prefills + {c['decode_steps']} decode steps), {spent(s)}")
            rows = SLOTS // d
            if s["rows"] != [(r // m) * rows, rows] or s["heads"][0] != 16 // m:
                failed.append(f"rank {r} server {d}x{m} rows {s['rows']} heads {s['heads']}")
            if m == 1 and (len(same) != REQUESTS or any(tf["diffs"])):
                failed.append(f"rank {r} server {d}x{m}: not bitwise the single process's"
                              f" ({len(same)} requests equal, |d| {tf['diffs']})")
            if set(s["statuses"]) != {"ok"}:
                failed.append(f"rank {r} server {d}x{m} statuses {s['statuses']}")
            log(f"[serve_tp_families] rank {r} mesh-paper {d}x{m} teacher-forced device steps"
                f" ({SLOTS} prompts prefilled alone, then {TPF_TF_STEPS} paged steps of {rows}"
                f" slots a data rank) against the single process's on 4 slots: "
                + held(f"rank {r} server {d}x{m}", tf, 0.0 if m == 1 else TPF_TOL["server"])
                + "; "
                + launches(f"rank {r} server {d}x{m} tf", tf,
                           dict(k1=per_tick * (SLOTS + TPF_TF_STEPS), k4=layers * TPF_TF_STEPS,
                                k6=0))
                + f", {spent(tf)}")
        moved = {k: (v, parent_blocks.get(k)) for k, v in f["blocks"].items()
                 if k in parent_blocks and parent_blocks[k] != v}
        if moved:
            failed.append(f"rank {r} planned other blocks than this process: {moved}")
        if r < 2:  # a data rank of the 2x1 server: SLOTS // 2 rows a decode step
            same, other = _blocks_at_rows(f["blocks"], parent_blocks, SLOTS // 2, SLOTS,
                                          set(MESH_PAPER_GEMMS.values()))
            log(f"[serve_tp_families] rank {r}: {same} products planned at M={SLOTS // 2} on"
                f" the single process's blocks at M={SLOTS} (the 2x1 server's bitwise check"
                f" needs K1 on equal blocks), {len(other)} on others")
            if other or not same:
                failed.append(f"rank {r} decode products on other blocks than the single"
                              f" process's 4-slot ones: {other}")
    calls = parent_calls | {_as_key(key) for f in ranks for key in f["k1_calls"]}
    here, before = hold_k1_keys(torch, "serve_tp_families", calls)
    log(f"[serve_tp_families] {len(calls)} distinct K1 calls of the parent and the ranks: {before}"
        f" held by [K1]/[K1 train]/[serve_tp] before, {here} held here on the same blocks")
    k4_held, _, k6_held = hold_k4_k5_calls(
        torch, "serve_tp_families", {_as_key(x) for f in ranks for x in f["k4_calls"]}, set(),
        {_as_key(x) for f in ranks for x in f["k6_calls"]})
    log(f"[serve_tp_families] the ranks' distinct K4 calls ({k4_held}: shapes, table and"
        f" lengths) and K6 calls ({k6_held}: shapes, mask and query offset) each held against"
        " the plain version at [K4]'s and [K6]'s limits")
    if not k4_held or not k6_held or any(f["k5_calls"] for f in ranks):
        failed.append(f"K4/K6 calls recorded: {k4_held} {k6_held}; K5"
                      f" {[f['k5_calls'] for f in ranks]}")
    check(not failed, "[serve_tp_families] failed:\n" + "\n".join(failed))
    fams = ranks[:2]
    k1 = sum(f[k]["k1"] for f in fams for k in ("zamba", "whisper"))
    k1 += sum(f["rwkv"][k]["k1"] for f in fams for k in ("generate", "server", "tf"))
    servers = [f[f"server {d}x{m}"] for f in ranks for d, m in TPF_SERVER_MESHES
               if f"server {d}x{m}" in f]
    return {"mesh_matmul": k1 + sum(s[k]["k1"] for s in servers for k in ("server", "tf")),
            "paged_attention": sum(s[k]["k4"] for s in servers for k in ("server", "tf")),
            "flash_attention": sum(f[k]["k6"] for f in fams for k in ("zamba", "whisper"))}


# [train_tp]: tensor-parallel training on ranks that share the card (gloo,
# every collective staged through host memory), through build_trainer
# under a ('data', 'model') mesh.  Full-width mesh-paper (4 layers, 16
# heads, σ scramble, `dots`, [train]'s 2 x 2048 tokens of batch 0, seed 0)
# on 1x2 (ranks 0-1: 8 heads and 4096 of 8192 d_ff columns a rank) and on
# 2x2 (all 4 ranks, one row a data rank): one step's gradients gathered to
# the global tree against the single-process kernel step's, then
# TRAIN_TP_STEPS steps (launches per rank, replicated leaves bitwise across
# the 'model' ranks, every leaf across the 'data' ranks).  The
# tensor-parallel checkpoint: mesh-paper at TRAIN_TP_CKPT_LAYERS of its 4
# layers (full width) on 1x2, TRAIN_TP_STEPS steps through train_loop,
# which gathers the global tree and writes it from coordinate 0; the
# parent restores it on one process and holds each leaf's sha256 against
# the tree the ranks gathered.  OLMoE-1B-7B at full width and
# [train_moe]'s 2 of 16 layers on 1x2 under expert parallelism (32 of 64
# experts a rank) on the single-process step's replayed routing (ranks
# 0-1); RWKV-6 at 2 of its 24 layers ([train_rwkv]'s held depth) and
# Zamba2-1.2B at full width on 1x2 (ranks 2-3, meanwhile), and at one
# segment of its depth for its per-parameter check.  The parent
# computes every single-process gradient and plans every shard shape
# first, so the ranks read its autotune cache.
TRAIN_TP_WORLD, TRAIN_TP_M, TRAIN_TP_STEPS, TRAIN_TP_TIMEOUT_S = 4, 2, 2, 420
# The checkpoint's depth: at all 4 layers its train state is 4.0 GB, whose
# write and restore took 25-35 s of the run (H100 80GB HBM3); at 1 layer
# it is 2.0 GB (the vocab's embedding and head are half of it), written by
# ranks 0-1 while ranks 2-3 finish their longer cases.
TRAIN_TP_CKPT_LAYERS = 1
TRAIN_TP_CASES = ("mesh-paper 1x2", "mesh-paper 2x2", "olmoe 1x2", "rwkv 1x2", "zamba 1x2",
                  "zamba6 1x2")
# Zamba2's per-parameter check is held at one segment of its 38 layers (6
# Mamba2 layers and one application of the shared block), as RWKV-6's at 2
# of 24: at full depth its per-head a_log and dt_bias read 0.0455 and 0.0469
# of their norms in two runs against [train]'s 0.05 (bf16 roundings 38
# layers deep; every other leaf under 0.04), and the loss, the grad norm and
# finite gradients are held there.
ZAMBA_TP_HELD_LAYERS = 6
# Limits of a TP step's gradients against the single-process kernel step's
# (loss |d|, grad norm relative, each parameter's ||d||/||g||; None: read,
# not held), each about 3x the larger of its first two readings and never
# looser than [train]'s (1e-3, 0.1 %, 0.05).  Readings (NVIDIA H100 80GB
# HBM3, 700 W, my chip runs 2-3 of PR 25; the TP shapes' timed blocks move
# between runs): mesh-paper 1x2 4.282e-04 / 2.022e-04, 0.00656 / 0.00386 %,
# 0.0165 / 0.0165; 2x2 3.052e-04, 0.00524 %, 0.0166 (both runs); OLMoE
# 1.268e-04 / 7.915e-05, 0.0172 / 0.0215 %, 0.0131 / 0.0129; RWKV-6
# 2.089e-04 / 1.154e-04, 0.0139 / 0.0208 %, 0.0246 / 0.0233; Zamba2
# 1.802e-04 / 1.497e-04, 0.00061 / 0.00214 %, (0.0455 / 0.0469); Zamba2 at
# 6 layers (runs 4-5, one set of blocks) (3.815e-06, 0.00087 %), 0.0155.
# The per-parameter readings hold still when the timed blocks move (run 2
# against 3: 0.0165 both, 0.0131 / 0.0129, 0.0246 / 0.0233), the loss and
# the grad norm, differences of large sums, do not (up to 3.5x): so each of
# Zamba2's two depths holds the measures it reads far from [train]'s
# limits, the full depth its loss and grad norm, 6 layers its parameters.
# Zamba2's full-depth grad norm moved with R1 at its 38 gated norms, and
# only there.  The single process's `ssm._gated_norm` runs R1 (its fixed
# tree), while the 1x2 ranks' sharded branch sums two f32 partials in
# torch and all-reduces them: the two sides sum each row in different
# orders, where before both took torch's reduction.  Readings (NVIDIA H100
# 80GB HBM3, 700 W, one machine, one call): the parent tree 0.00214 % and
# 0.00061 %; this tree 0.00715 % (and 0.00843 %, 0.00715 %, 0.00715 % on
# others); this tree with the single process's gated norm on
# rmsnorm_torch 0.00229 %; with R1 off everywhere 0.00214 %, bitwise the
# parent's first reading (the model code's other changes move nothing).
# So 3x the largest with R1, 2.6e-4, still 4x under [train]'s 0.1 % (its
# loss and per-parameter readings did not move).
TRAIN_TP_TOL = {"mesh-paper 1x2": (1e-3, 2e-4, 0.05), "mesh-paper 2x2": (9e-4, 1.6e-4, 0.05),
                "olmoe 1x2": (4e-4, 6.5e-4, 0.04), "rwkv 1x2": (6.3e-4, 6.2e-4, 0.05),
                "zamba 1x2": (5.4e-4, 2.6e-4, None), "zamba6 1x2": (None, None, 0.047)}
# Leaves each family's per-parameter check must name: Mamba2's fused
# projection and conv (B and C replicated inside them) and RWKV-6's
# per-channel leaves, sliced from replicated copies by the model code.
TRAIN_TP_NAMED = {
    "zamba6 1x2": ("mamba_seg/in_proj", "mamba_seg/conv_w", "mamba_seg/conv_b"),
    "rwkv 1x2": ("blocks/w0", "blocks/u", "blocks/ww2", "blocks/gn_g", "blocks/gn_b")}


def _train_tp_cfgs():
    """{case: the config it trains} (kernel path, published widths)."""
    import dataclasses

    from repro_torch.configs import get_config

    paper = get_config("mesh-paper")
    return {
        "mesh-paper 1x2": paper, "mesh-paper 2x2": paper,
        "olmoe 1x2": dataclasses.replace(get_config("olmoe-1b-7b"),
                                         num_layers=MOE_TRAIN_LAYERS, use_mesh_kernel=True),
        "rwkv 1x2": dataclasses.replace(get_config("rwkv6-1.6b").tuned(),
                                        num_layers=RWKV_HELD_LAYERS, use_mesh_kernel=True),
        "zamba 1x2": dataclasses.replace(get_config("zamba2-1.2b").tuned(),
                                         use_mesh_kernel=True),
        "zamba6 1x2": dataclasses.replace(get_config("zamba2-1.2b").tuned(),
                                          num_layers=ZAMBA_TP_HELD_LAYERS, use_mesh_kernel=True),
    }


def train_tp_products(torch):
    """[train_tp]'s forward K1 products on a rank, (label, M, K, N, out
    dtype), at 2 x 2048 rows (1x2) and mesh-paper's 2048 (a 2x2 data
    rank's row): column-parallel projections of a rank's heads, gate and
    up slices, Mamba2 segments and vocab rows, row-parallel ones with f32
    partial sums, and the replicated ones.  The backward's dA and dB follow
    from each forward's blocks (api.mm_backward)."""
    from repro_torch.models.attention import head_layout
    from repro_torch.models.layers import padded_vocab

    f32, ctx, out = torch.float32, _tp_ctx(TRAIN_TP_M), []
    cfgs = _train_tp_cfgs()
    tokens = TRAIN_BATCH * TRAIN_SEQ

    def attn(cfg):
        d, hd, lay = cfg.d_model, cfg.head_dim_, head_layout(cfg, ctx)
        return [("wq", d, lay.q.size * hd, None), ("wk|wv", d, lay.kv.size * hd, None),
                ("wo", lay.q.size * hd, d, f32)]

    def mlp(cfg):
        fp = ctx.part("mlp", cfg.d_ff)
        return [("wi", cfg.d_model, 2 * fp.size, None), ("mlp wo", fp.size, cfg.d_model, f32)]

    def head(cfg):
        return [("head", cfg.d_model, ctx.part("vocab", padded_vocab(cfg)).size, None)]

    def add(name, prods, ms):
        for m in ms:
            out.extend((f"{name} {label} M={m}", m, k, n, dt) for label, k, n, dt in prods)

    cfg = cfgs["mesh-paper 1x2"]
    add("mesh-paper", attn(cfg) + mlp(cfg) + head(cfg), (tokens, TRAIN_SEQ))
    cfg = cfgs["olmoe 1x2"]
    add("olmoe", attn(cfg) + head(cfg), (tokens,))
    cfg = cfgs["rwkv 1x2"]
    d, hp, fp = cfg.d_model, ctx.part("heads", cfg.num_heads), ctx.part("mlp", cfg.d_ff)
    cols = hp.size * cfg.head_dim_
    add("rwkv", [("wr|wk|wv|wg", d, cols, None), ("wo", cols, d, f32),
                 ("cm_wk", d, fp.size, None), ("cm_wv", fp.size, d, f32), ("cm_wr", d, d, None)]
        + head(cfg), (tokens,))
    cfg = cfgs["zamba 1x2"]
    d_in, n = cfg.ssm_expand * cfg.d_model, cfg.ssm_state_size
    hs = ctx.part("mlp", cfg.ssm_num_heads)
    ph = d_in // cfg.ssm_num_heads
    add("zamba", [("in_proj", cfg.d_model, 2 * hs.size * ph + 2 * n + hs.size, None),
                  ("out_proj", hs.size * ph, cfg.d_model, f32)] + attn(cfg) + mlp(cfg)
        + head(cfg), (tokens,))
    return out


@contextlib.contextmanager
def k5_backward_calls(k5):
    """Within the block, the `_gmm` backward's K5 calls (its f32 grouped
    products) are recorded into `k5` as k4_k5_calls records the forward's
    (the backward binds the kernel wrapper as a default argument, which
    k4_k5_calls' patch does not reach)."""
    from repro_torch.kernels import api
    from repro_torch.kernels.grouped import grouped_mesh_matmul as run

    original = api.gmm_backward

    def recorded(*args, **kw):
        kw.pop("matmul", None)

        def matmul(tokens, sizes, w, **mkw):
            k5.add((tuple(tokens.shape), tuple(w.shape), str(tokens.dtype)[6:],
                    str(mkw.get("out_dtype") or tokens.dtype)[6:],
                    tuple(mkw[f"block_{x}"] for x in "mnk"), mkw["stagger"],
                    mkw.get("activation"), mkw.get("bias") is not None,
                    mkw.get("residual") is not None, tuple(sizes.tolist())))
            return run(tokens, sizes, w, **mkw)

        return original(*args, matmul=matmul, **kw)

    api.gmm_backward = recorded
    try:
        yield k5
    finally:
        api.gmm_backward = original


def train_tp_rank(rank, world, init, tmp):
    """One rank of [train_tp] (run by the phase in its own process): its
    findings, K1, K5 and K6 calls and plans' blocks go to tmp as JSON."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(2)  # 4 ranks on the machine's cores
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank, world_size=world)
    with k1_calls() as calls, k4_k5_calls() as (k4, k5, k6), k5_backward_calls(k5):
        found = _train_tp_rank(torch, rank, tmp)
    found["k1_calls"] = sorted(calls, key=str)
    found["k4_calls"], found["k5_calls"] = sorted(k4, key=str), sorted(k5, key=str)
    found["k6_calls"] = sorted(k6, key=str)
    found["blocks"] = _plan_blocks()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(found, f)
    dist.destroy_process_group()


def _tp_grads(torch, tag, step, params, batch, tmp, blocks, compare):
    """One step's gradients of `batch` on this rank's blocks (`step.grads`),
    gathered to the global tree; where `compare`, held leaf by leaf against
    the single-process kernel step's saved in tmp.  Returns the readings."""
    from repro_torch.optim import global_norm
    from repro_torch.parallel import collectives
    from repro_torch.tree import tree_paths

    for key in list(collectives.traffic):
        collectives.traffic[key] = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    grads, met = step.grads(params, batch)
    norm = float(global_norm(grads, blocks))
    torch.cuda.synchronize()
    out = dict(wall_s=time.monotonic() - t0, loss=float(met["loss"]), grad_norm=norm,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               traffic=dict(collectives.traffic),
               replicated_sha=_replicated_sha(torch, grads, blocks))
    whole = blocks.gather(grads, device="cpu")
    del grads
    if compare:
        want = torch.load(os.path.join(tmp, f"{tag}.pt"))
        leaves = []
        for (path, g), w in zip(tree_paths(whole), want["grads"]):
            g, w = g.cuda().float(), w.cuda().float()
            leaves.append((path, (g - w).norm().item() / max(w.norm().item(), 1e-30),
                           (g - w).abs().max().item(), w.abs().max().item()))
            del g, w
        out.update(leaves=leaves, want_loss=want["loss"], want_norm=want["norm"])
        del want
    del whole
    _free(torch)
    return out


def _replicated_sha(torch, tree, blocks):
    """{path: sha256 of the leaf's replicated parts} of a tree of blocks."""
    import hashlib

    from repro_torch.tree import tree_leaves, tree_paths

    out = {}
    for (path, leaf), rep in zip(tree_paths(tree), tree_leaves(blocks.replicated)):
        same = blocks._parts(leaf.detach(), rep)[1]
        if same:
            h = hashlib.sha256()
            for v in same:
                h.update(v.contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
            out[path] = h.hexdigest()
    return out


def _train_tp_rank(torch, rank, tmp):
    """train_tp_rank's work, in its process group."""
    import io

    import dataclasses

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.interop import shard_params
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.grouped import grouped_mesh_matmul
    from repro_torch.kernels.mesh_matmul import mesh_matmul
    from repro_torch.kernels.scramble import scramble_blocks_cuda
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import build_trainer
    from repro_torch.models import get_model
    from repro_torch.models.layers import ShardCtx
    from repro_torch.optim import AdamWConfig, constant
    from repro_torch.parallel.collectives import mesh_groups
    from repro_torch.parallel.sharding import DEFAULT_RULES
    from repro_torch.train.loop import LoopConfig, train_loop
    from repro_torch.train.metrics import MetricsLogger
    from repro_torch.train.train_step import make_train_step
    from repro_torch.tree import tree_leaves, tree_paths

    cfgs = _train_tp_cfgs()
    host = SyntheticLM(DataConfig(vocab_size=cfgs["mesh-paper 1x2"].vocab_size,
                                  seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                                  seed=0))._host_batch(0)
    names = ("data", "model")
    meshes = {"2x2": make_local_mesh((2, TRAIN_TP_M), names),
              "1x2 a": DeviceMesh("cpu", torch.arange(2).reshape(1, 2), mesh_dim_names=names),
              "1x2 b": DeviceMesh("cpu", torch.arange(2, 4).reshape(1, 2),
                                  mesh_dim_names=names)}
    found = {}

    def counted():
        mesh_matmul.launches = scramble_blocks_cuda.launches = 0
        grouped_mesh_matmul.launches = flash_attention.launches = 0

    def launches():
        return dict(k1=mesh_matmul.launches, k3=scramble_blocks_cuda.launches,
                    k5=grouped_mesh_matmul.launches, k6=flash_attention.launches)

    def paper(case, mesh):
        """mesh-paper through build_trainer under `mesh`: the gradients of
        batch 0, then TRAIN_TP_STEPS steps through train_loop."""
        cfg = cfgs[case]
        coord = dict(zip(names, mesh.get_coordinate()))
        step, state, data = build_trainer(cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ, mesh=mesh,
                                          lr=TRAIN_LR, total_steps=TRAIN_TP_STEPS, seed=0,
                                          device="cuda")
        blocks = step.blocks
        res = {"coord": coord, "state_gib": sum(t.numel() * t.element_size()
                                                for t in tree_leaves(state)) / 2**30}
        counted()
        res["grads"] = _tp_grads(torch, case, step, state["params"], host, tmp, blocks,
                                 compare=coord == {"data": 0, "model": 0})
        res["grads"]["launches"] = launches()
        per = []

        def timed(st, b):
            before = launches()
            t0 = time.monotonic()
            st, met = step(st, b)
            torch.cuda.synchronize()
            per.append((time.monotonic() - t0, {k: v - before[k] for k, v in launches().items()}))
            return st, met

        logger = MetricsLogger(stream=io.StringIO())
        torch.cuda.reset_peak_memory_stats()
        state = train_loop(timed, state, data, LoopConfig(
            total_steps=TRAIN_TP_STEPS, ckpt_every=10**9, log_every=1), logger=logger,
            group=mesh_groups(mesh), blocks=blocks)
        res.update(steps=per, losses=[h["loss"] for h in logger.history],
                   grad_norms=[h["grad_norm"] for h in logger.history],
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   replicated_sha=_replicated_sha(torch, state["params"], blocks),
                   all_sha=[_sha(torch, t) for t in tree_leaves(state["params"])],
                   replicated={p: r if r in (True, None) else [r[0], list(r[1])]
                               for p, r in tree_paths(blocks.replicated)})
        del state, step, data
        _free(torch)
        return res

    def paper_ckpt(mesh):
        """mesh-paper at TRAIN_TP_CKPT_LAYERS through build_trainer under
        `mesh`: TRAIN_TP_STEPS steps through train_loop and the last one's
        checkpoint, the global tree the loop gathers, written from
        coordinate 0 (with the sha256 of each leaf it was given)."""
        cfg = dataclasses.replace(cfgs["mesh-paper 1x2"], num_layers=TRAIN_TP_CKPT_LAYERS)
        coord = dict(zip(names, mesh.get_coordinate()))
        step, state, data = build_trainer(cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ, mesh=mesh,
                                          lr=TRAIN_LR, total_steps=TRAIN_TP_STEPS, seed=0,
                                          device="cuda")

        class Hashed:
            """The writer's checkpointer: the sha256 of each leaf of the
            global tree the loop gathered, then a synchronous save."""

            def __init__(self, manager):
                self.manager, self.sha = manager, None

            def submit(self, step_i, tree, meta):
                self.sha = {p: _sha(torch, t) for p, t in tree_paths(tree)}
                self.manager.save(step_i, tree, meta)

            def wait(self):
                pass

        manager = CheckpointManager(os.path.join(tmp, "ckpt"))
        writer = Hashed(manager) if coord == {"data": 0, "model": 0} else None
        res = {"state_gib": sum(t.numel() * t.element_size()
                                for t in tree_leaves(state)) / 2**30}
        t0 = time.monotonic()
        state = train_loop(step, state, data, LoopConfig(
            total_steps=TRAIN_TP_STEPS, ckpt_every=TRAIN_TP_STEPS, log_every=1), ckpt=manager,
            logger=MetricsLogger(stream=io.StringIO()), group=mesh_groups(mesh),
            blocks=step.blocks, checkpointer=writer)
        res["wall_s"] = time.monotonic() - t0
        if writer is not None:  # the global tree the checkpoint holds, as gathered
            res["gathered_sha"] = writer.sha
        del state, step, data
        _free(torch)
        return res

    def grads_only(case, mesh, replay=None):
        """One step's gradients of `case` on this rank's blocks of the
        seed-0 init, against the single-process kernel step's."""
        cfg = cfgs[case]
        model = get_model(cfg)
        ctx = ShardCtx(mesh, DEFAULT_RULES)
        full = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
        params = shard_params(full, model, ctx)
        del full
        _free(torch)
        step = make_train_step(model, constant(TRAIN_LR), AdamWConfig(), ctx)
        batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                       global_batch=TRAIN_BATCH, seed=0))._host_batch(0)
        coord = dict(zip(names, mesh.get_coordinate()))
        counted()
        with routing(replay) as seen:
            res = _tp_grads(torch, case, step, params, batch, tmp, step.blocks,
                            compare=coord["model"] == 0)
        res["launches"] = launches()
        res["routes"] = len(seen)
        res["replicated"] = {p: r if r in (True, None) else [r[0], list(r[1])]
                             for p, r in tree_paths(step.blocks.replicated)}
        res["params_gib"] = sum(t.numel() * t.element_size() for t in tree_leaves(params)) / 2**30
        del params, step
        _free(torch)
        return res

    t0 = time.monotonic()
    if rank < 2:
        found["mesh-paper 1x2"] = paper("mesh-paper 1x2", meshes["1x2 a"])
        routes = [r.cuda() for r in torch.load(os.path.join(tmp, "olmoe_routes.pt"))]
        found["olmoe 1x2"] = grads_only("olmoe 1x2", meshes["1x2 a"], replay=routes)
        del routes
        found["ckpt 1x2"] = paper_ckpt(meshes["1x2 a"])
    else:
        for case in ("rwkv 1x2", "zamba 1x2", "zamba6 1x2"):
            found[case] = grads_only(case, meshes["1x2 b"])
    found["1x2 wall_s"] = time.monotonic() - t0
    dist.barrier()
    t0 = time.monotonic()
    found["mesh-paper 2x2"] = paper("mesh-paper 2x2", meshes["2x2"])
    found["2x2 wall_s"] = time.monotonic() - t0
    return found


def phase_train_tp(torch):
    """Tensor-parallel training on TRAIN_TP_WORLD ranks sharing the card
    (see the constants above): the parent computes the single-process
    kernel steps' gradients and plans every shard shape, the ranks train,
    and the parent holds their gradients, launches, bitwise agreements,
    checkpoint and every K1, K5 and K6 call they made.  Walls and bytes are
    printed, never as speeds."""
    import dataclasses
    import shutil

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import get_model
    from repro_torch.optim import global_norm
    from repro_torch.train.train_step import _grads_of, abstract_train_state
    from repro_torch.tree import tree_leaves, tree_paths

    cfgs = _train_tp_cfgs()
    paper_cfg = cfgs["mesh-paper 1x2"]
    check(paper_cfg.scramble_privacy and paper_cfg.use_mesh_kernel
          and paper_cfg.remat_policy == "dots" and TRAIN_SEQ == paper_cfg.d_model,
          f"[train_tp] needs mesh-paper scrambling at seq {TRAIN_SEQ} under dots: {paper_cfg}")
    _free(torch)
    t_phase = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="train_tp")
    try:
        refs, single = {}, {}
        with k1_calls() as parent_calls:
            planned = plan_products(torch, train_tp_products(torch))
            for case, cfg in cfgs.items():
                if case == "mesh-paper 2x2":
                    continue
                model = get_model(cfg)
                params = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
                batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                               global_batch=TRAIN_BATCH,
                                               seed=0))._host_batch(0)
                batch = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.monotonic()
                with routing() as seen:
                    grads, met = _grads_of(model, params, batch)
                torch.cuda.synchronize()
                single[case] = dict(wall_s=time.monotonic() - t0,
                                    peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                                    params=sum(p.numel() for p in tree_leaves(params)),
                                    bytes=sum(p.numel() * p.element_size()
                                              for p in tree_leaves(params)))
                refs[case] = {"loss": float(met["loss"]), "norm": float(global_norm(grads))}
                torch.save({**refs[case], "grads": [g.cpu() for g in tree_leaves(grads)]},
                           os.path.join(tmp, f"{case}.pt"))
                if case == "mesh-paper 1x2":
                    os.link(os.path.join(tmp, f"{case}.pt"), os.path.join(tmp, "mesh-paper 2x2.pt"))
                    refs["mesh-paper 2x2"] = refs[case]
                    single["mesh-paper 2x2"] = single[case]
                if case == "olmoe 1x2":
                    torch.save([r.cpu() for r in seen], os.path.join(tmp, "olmoe_routes.pt"))
                    single[case]["routes"] = len(seen)
                del params, grads, met, batch, seen, model
                _free(torch)
        log(f"[train_tp] single-process kernel steps' gradients of batch 0 and"
            f" {len(planned)} shard shapes planned in {time.monotonic() - t_phase:.1f} s: "
            + "; ".join(f"{c} loss {refs[c]['loss']:.6f} grad norm {refs[c]['norm']:.6f}"
                        f" ({single[c]['params'] / 1e9:.3f} B parameters, peak"
                        f" {single[c]['peak_gib']:.2f} GiB, wall {single[c]['wall_s']:.2f} s)"
                        for c in cfgs if c != "mesh-paper 2x2"))
        t0 = time.monotonic()
        runs = _spawn(lambda r: (
            "import chip_smoke; chip_smoke.train_tp_rank("
            f"{r}, {TRAIN_TP_WORLD}, {os.path.join(tmp, 'gloo')!r}, {tmp!r})"),
            TRAIN_TP_WORLD, TRAIN_TP_TIMEOUT_S)
        wall = time.monotonic() - t0
        bad = [f"rank {r}: rc={rc} {e[-3000:]}" for r, (rc, _, e) in enumerate(runs) if rc != 0]
        check(not bad, "[train_tp] rank failures:\n" + "\n".join(bad))
        ranks = [json.loads(Path(tmp, f"rank{r}.json").read_text())
                 for r in range(TRAIN_TP_WORLD)]
        parent_blocks = _plan_blocks()
        # The 1x2 trainer's step-TRAIN_TP_STEPS checkpoint (the global tree,
        # written by rank 0) restored here, on one process, into a
        # single-process state's structure (meta leaves: restored on the
        # host), against the state the ranks gathered (sha256 of each leaf).
        ckpt = CheckpointManager(os.path.join(tmp, "ckpt"))
        t0 = time.monotonic()
        restored = ckpt.restore(TRAIN_TP_STEPS, abstract_train_state(get_model(
            dataclasses.replace(paper_cfg, num_layers=TRAIN_TP_CKPT_LAYERS))))
        got = {p: _sha(torch, t) for p, t in tree_paths(restored)}
        want = ranks[0]["ckpt 1x2"]["gathered_sha"]
        restore_ok = ckpt.latest_step() == TRAIN_TP_STEPS and got == want
        n_leaves, restore_s = len(got), time.monotonic() - t0
        del restored
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[train_tp] {TRAIN_TP_WORLD} gloo ranks on one card: {wall:.1f} s wall in all, process"
        " start, CUDA init and every model's init included (not a speed: the ranks share the card"
        " and every collective goes through host memory)")

    failed = []
    for case in TRAIN_TP_CASES:
        loss_tol, norm_tol, leaf_tol = TRAIN_TP_TOL[case]
        tp_ranks = [(r, f[case]) for r, f in enumerate(ranks) if case in f]
        for r, res in tp_ranks:
            g = res["grads"] if "grads" in res else res
            if "leaves" not in g:
                continue
            d_loss = abs(g["loss"] - g["want_loss"])
            d_norm = abs(g["grad_norm"] - g["want_norm"]) / g["want_norm"]
            worst = sorted(g["leaves"], key=lambda x: x[1])
            top = ", ".join(f"{p} {rel:.3e}" for p, rel, _, _ in reversed(worst[-4:]))
            named = {p for p, _, _, _ in g["leaves"]}
            missing = [p for p in TRAIN_TP_NAMED.get(case, ()) if p not in named]
            tr = g["traffic"]
            log(f"[train_tp] {case} rank {r}: one step's gradients of batch 0 gathered against"
                f" the single-process kernel step's: loss {g['loss']:.6f} vs {g['want_loss']:.6f}"
                f" (|d| {d_loss:.3e}, tol {loss_tol}), grad norm {g['grad_norm']:.6f} vs"
                f" {g['want_norm']:.6f} ({100 * d_norm:.5f} %, tol"
                f" {'None' if norm_tol is None else f'{100 * norm_tol:g} %'}),"
                f" per-parameter ||d||/||g|| largest: {top} (tol {leaf_tol}) of"
                f" {len(g['leaves'])} leaves; all-reduces {tr['all_reduce']}"
                f" ({tr['all_reduce_bytes'] / 2**20:.1f} MiB), all-gathers {tr['all_gather']}"
                f" ({tr['all_gather_bytes'] / 2**20:.1f} MiB) in the step's forward and"
                f" backward; wall {g['wall_s']:.2f} s (not a speed), peak {g['peak_gib']:.2f} GiB")
            held = [(x, t) for x, t in ((d_loss, loss_tol), (d_norm, norm_tol),
                                        (worst[-1][1], leaf_tol)) if t is not None]
            if (any(x > t for x, t in held) or missing or not math.isfinite(d_loss + d_norm)
                    or not all(math.isfinite(x[1]) for x in worst)):
                failed.append(f"{case} rank {r} gradients: loss {d_loss}, norm {d_norm},"
                              f" leaf {worst[-1]}, missing {missing}")
        # Each rank holds its blocks: its peak in the gradients below the
        # single-process step's, measured in this phase.
        for r, res in tp_ranks:
            g = res["grads"] if "grads" in res else res
            log(f"[train_tp] {case} rank {r}: peak device memory in one step's gradients"
                f" {g['peak_gib']:.2f} GiB, the single process's {single[case]['peak_gib']:.2f} GiB")
            if not g["peak_gib"] < single[case]["peak_gib"]:
                failed.append(f"{case} rank {r} peak {g['peak_gib']} GiB not below the single"
                              f" process's {single[case]['peak_gib']}")
        # Replicated parts bitwise across the 'model' ranks of a data rank.
        by_data = {}
        for r, res in tp_ranks:
            coord = res.get("coord", {"data": 0})
            by_data.setdefault(coord["data"], []).append(
                (res["grads"] if "grads" in res else res)["replicated_sha"])
        same = all(all(s == shas[0] for s in shas) and shas[0] for shas in by_data.values())
        if not same:
            failed.append(f"{case}: replicated gradients differ across the 'model' ranks")
    # The trainers' steps.
    for case in ("mesh-paper 1x2", "mesh-paper 2x2"):
        tp_ranks = [(r, f[case]) for r, f in enumerate(ranks) if case in f]
        per_rank = TRAIN_TP_M if case.endswith("1x2") else TRAIN_TP_WORLD
        check(len(tp_ranks) == per_rank, f"[train_tp] {case}: {len(tp_ranks)} ranks reported")
        for r, res in tp_ranks:
            for i, (dt, got) in enumerate(res["steps"]):
                log(f"[train_tp] {case} rank {r} step {i + 1}: loss {res['losses'][i]:.5f}"
                    f" grad norm {res['grad_norms'][i]:.5f}, wall {dt * 1e3:.1f} ms (not a"
                    f" speed), launches K1={got['k1']} K3={got['k3']}")
            if any((got["k1"], got["k3"]) != (STEP_LAUNCHES["mesh_matmul"],
                                              STEP_LAUNCHES["scramble_blocks"])
                   for _, got in res["steps"]) or len(res["steps"]) != TRAIN_TP_STEPS:
                failed.append(f"{case} rank {r} launches per step {res['steps']}")
            if not all(math.isfinite(x) for x in res["losses"]):
                failed.append(f"{case} rank {r} losses {res['losses']}")
            log(f"[train_tp] {case} rank {r}: its blocks' train state {res['state_gib']:.2f} GiB"
                f" ({single[case]['bytes'] / 1e9:.3f} GB of bf16 parameters in all), peak device"
                f" memory over the steps {res['peak_gib']:.2f} GiB")
        shas = {}
        for r, res in tp_ranks:
            shas.setdefault(res["coord"]["data"], []).append(res["replicated_sha"])
        rep_same = all(all(s == v[0] for s in v) and v[0] for v in shas.values())
        data_same = all(res["all_sha"] == tp_ranks[res["coord"]["model"]][1]["all_sha"]
                        for _, res in tp_ranks)
        if len({tuple(res["losses"]) for _, res in tp_ranks}) != 1:
            failed.append(f"{case}: the ranks' losses differ")
        log(f"[train_tp] {case} after {TRAIN_TP_STEPS} steps: replicated leaves bitwise equal"
            f" across the 'model' ranks: {rep_same}; every leaf bitwise equal across the 'data'"
            f" ranks: {data_same}")
        if not rep_same or not data_same:
            failed.append(f"{case}: parameters differ across ranks ({rep_same}, {data_same})")
    log(f"[train_tp] mesh-paper 1x2 at {TRAIN_TP_CKPT_LAYERS} of 4 layers: its"
        f" step-{TRAIN_TP_STEPS} checkpoint (the global tree, {n_leaves} leaves; a rank's"
        f" state {ranks[0]['ckpt 1x2']['state_gib']:.2f} GiB, the ranks' {TRAIN_TP_STEPS} steps"
        f" and write {ranks[0]['ckpt 1x2']['wall_s']:.1f} s) restored on this process in"
        f" {restore_s:.1f} s, bitwise equal to the state the ranks gathered: {restore_ok}")
    if not restore_ok:
        failed.append("the 1x2 checkpoint does not restore to the gathered state")
    # Launch counts from the code: a mesh-paper step's K1 75 and K3 4 on each
    # rank (the rank runs every product on its blocks); OLMoE's K5 2 a layer
    # forward, 2 a layer in the backward's dtokens plus the dots recompute;
    # Zamba2's K6 one a shared-block application.
    for r, f in enumerate(ranks):
        for case in ("olmoe 1x2", "rwkv 1x2", "zamba 1x2", "zamba6 1x2"):
            if case in f:
                log(f"[train_tp] {case} rank {r}: launches in one step's gradients"
                    f" {f[case]['launches']}, routing decisions {f[case]['routes']} (the"
                    f" single process {single[case].get('routes', 0)}), its blocks"
                    f" {f[case]['params_gib']:.2f} GiB of parameters")
        if "olmoe 1x2" in f and f["olmoe 1x2"]["routes"] != single["olmoe 1x2"]["routes"]:
            failed.append(f"rank {r} OLMoE routing decisions {f['olmoe 1x2']['routes']}")
        if "zamba 1x2" in f and (f["zamba 1x2"]["launches"]["k6"],
                                 f["zamba6 1x2"]["launches"]["k6"]) != (ZAMBA_APPS, 1):
            failed.append(f"rank {r} Zamba2 K6 launches {f['zamba 1x2']['launches']}"
                          f" {f['zamba6 1x2']['launches']}")
        moved = {k: (v, parent_blocks.get(k)) for k, v in f["blocks"].items()
                 if k in parent_blocks and parent_blocks[k] != v}
        if moved:
            failed.append(f"rank {r} planned other blocks than this process: {moved}")
    two = [f["mesh-paper 2x2"] for f in ranks if "mesh-paper 2x2" in f]
    TRAIN_TP_2X2.update(state_gib=round(two[0]["state_gib"], 3),
                        peak_gib=round(max(x["peak_gib"] for x in two), 3))
    rep = ranks[0]["mesh-paper 1x2"]["replicated"]
    log(f"[train_tp] replicated over 'model' (mesh-paper 1x2): "
        f"{sorted(p for p, v in rep.items() if v is True)}; Zamba2's segments: "
        f"{ {p: v for p, v in ranks[2]['zamba 1x2']['replicated'].items() if isinstance(v, list)} }")
    log(f"[train_tp] ranks' walls: 1x2 cases {[round(f['1x2 wall_s'], 1) for f in ranks]} s,"
        f" 2x2 {[round(f['2x2 wall_s'], 1) for f in ranks]} s (not speeds)")
    calls = parent_calls | {_as_key(key) for f in ranks for key in f["k1_calls"]}
    here, before = hold_k1_keys(torch, "train_tp", calls)
    log(f"[train_tp] {len(calls)} distinct K1 calls of the parent and the ranks (the f32"
        f" backward's dA and dB at the half-width shapes included): {before} held by"
        f" [K1]/[K1 train] before, {here} held here on the same blocks")
    k4_held, k5_held, k6_held = hold_k4_k5_calls(
        torch, "train_tp", {_as_key(x) for f in ranks for x in f["k4_calls"]},
        {_as_key(x) for f in ranks for x in f["k5_calls"]},
        {_as_key(x) for f in ranks for x in f["k6_calls"]})
    log(f"[train_tp] the ranks' distinct K5 calls ({k5_held}: OLMoE's 32 experts a rank, forward"
        f" and the `_gmm` backward's f32 products) and K6 calls ({k6_held}: Zamba2's shared block"
        " on 16 of 32 heads) each held against the plain version at [K5]'s and [K6]'s limits")
    if not k5_held or not k6_held or k4_held:
        failed.append(f"K4/K5/K6 calls recorded: {k4_held} {k5_held} {k6_held}")
    check(not failed, "[train_tp] failed:\n" + "\n".join(failed))
    return {"mesh_matmul": sum(f[c]["grads"]["launches"]["k1"]
                               + sum(got["k1"] for _, got in f[c]["steps"])
                               for f in ranks for c in ("mesh-paper 1x2", "mesh-paper 2x2")
                               if c in f)
            + sum(f[c]["launches"]["k1"] for f in ranks
                  for c in ("olmoe 1x2", "rwkv 1x2", "zamba 1x2", "zamba6 1x2") if c in f),
            "scramble_blocks": sum(f[c]["grads"]["launches"]["k3"]
                                   + sum(got["k3"] for _, got in f[c]["steps"])
                                   for f in ranks for c in ("mesh-paper 1x2", "mesh-paper 2x2")
                                   if c in f),
            "grouped_mesh_matmul": sum(f["olmoe 1x2"]["launches"]["k5"] for f in ranks
                                       if "olmoe 1x2" in f),
            "flash_attention": sum(f[c]["launches"]["k6"] for f in ranks
                                   for c in ("zamba 1x2", "zamba6 1x2") if c in f)}


# [train_sp]: Megatron sequence parallelism ('seq_sp', TRAIN_RULES), FSDP
# parameter rules (PARAM_RULES) and a sequence-sharded KV cache, on
# TRAIN_SP_WORLD gloo ranks sharing the card.  Full-width mesh-paper (the
# sigma scramble firing, `dots`) through `build_trainer(rules=,
# param_rules=)`: on 1x2 under TRAIN_RULES (ranks 0-1), then on 2x2 under
# TRAIN_RULES with PARAM_RULES parameters (all ranks); one step's gradients
# of batch 0 gathered from the ranks' blocks against the single-process
# kernel step's (loss |d|, grad norm relative, each parameter's
# ||d||/||g||: TRAIN_SP_TOL, about 3x a first reading, never looser than
# [train_tp]'s), then one step, K1 75 and K3 4 on each rank.  Meanwhile
# (ranks 2-3) Granite-3 8B through `tuned()` at KVSEQ_LAYERS of its 40
# layers and full width decodes on 1x2 under its decode rule (its 8 kv
# heads do not divide 'model' in production: kv_heads None, kv_seq
# 'model'): KVSEQ_ROWS prompts of KVSEQ_PROMPT tokens prefilled (K6 on the
# rank's heads), the caches padded and cut into the ranks' halves of the
# positions, KVSEQ_STEPS teacher-forced steps against the single process's
# dense decode (KVSEQ_TOL), and the same in f32 on the `torch` backend (the
# witness, KVSEQ_F32_TOL).
TRAIN_SP_WORLD, TRAIN_SP_TIMEOUT_S = 4, 420
TRAIN_SP_CASES = ("mesh-paper sp 1x2", "mesh-paper fsdp 2x2")
# First readings (NVIDIA H100 80GB HBM3, 700.00 W): 1x2 loss |d|
# 1.898e-04, grad norm 2.28e-05, per parameter 0.0170; 2x2 2.470e-04,
# 3.8e-06, 0.0173.  Limits about 3x (the grad norm
# 3x the larger of the two, since it moves with the timed blocks), capped
# at [train_tp]'s.  Granite's decode: bf16 0.0742 (3x would pass
# [serve_tp]'s 0.15, so 0.15), f32 1.562e-05 (so 5e-5).
TRAIN_SP_TOL = {"mesh-paper sp 1x2": (6e-4, 7e-5, 0.05),
                "mesh-paper fsdp 2x2": (7.5e-4, 7e-5, 0.05)}
KVSEQ_ARCH, KVSEQ_LAYERS, KVSEQ_ROWS, KVSEQ_PROMPT, KVSEQ_STEPS = "granite-3-8b", 2, 2, 2048, 8
KVSEQ_MAX = KVSEQ_PROMPT + 2 * KVSEQ_STEPS
KVSEQ_TOL, KVSEQ_F32_TOL = 0.15, 5e-5
# [train_tp]'s 2x2 rank reading of its state and peak, when it ran in this
# process, for [train_sp]'s line.
TRAIN_TP_2X2 = {}


def _kvseq_cfg(f32=False):
    import dataclasses

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(KVSEQ_ARCH).tuned(), num_layers=KVSEQ_LAYERS,
                              use_mesh_kernel=not f32)
    if f32:
        cfg = dataclasses.replace(cfg, param_dtype="float32", activation_dtype="float32")
    return cfg


def _kvseq_rules():
    from repro_torch.parallel.sharding import DEFAULT_RULES

    return DEFAULT_RULES.replace(kv_heads=None, kv_seq="model")


def _kvseq_tokens():
    import numpy as np

    cfg = _kvseq_cfg()
    rng = np.random.default_rng(27)
    return rng.integers(0, cfg.vocab_size, (KVSEQ_ROWS, KVSEQ_PROMPT + KVSEQ_STEPS)).astype(
        np.int32)


def _kvseq_decode(torch, cfg, params, model, ctx, pre):
    """Prefill under `pre`, pad the caches to KVSEQ_MAX, keep this
    process's block of them under `ctx`, then KVSEQ_STEPS teacher-forced
    decode steps: (steps, rows, vocab) f32 logits on every rank."""
    from repro_torch.models.layers import padded_vocab

    toks = torch.as_tensor(_kvseq_tokens(), device="cuda")
    axes = ("layers", "kv_batch", "kv_seq", "kv_heads", "head_dim")
    with torch.inference_mode():
        _, st = model.prefill(params, {"tokens": toks[:, :KVSEQ_PROMPT]}, pre)
        st = {k: ctx.c(torch.nn.functional.pad(v, (0, 0, 0, 0, 0, KVSEQ_MAX - KVSEQ_PROMPT)),
                       axes, (None, None, KVSEQ_MAX, None, None)) for k, v in st.items()}
        out = []
        for i in range(KVSEQ_STEPS):
            lg, st = model.decode(params, toks[:, KVSEQ_PROMPT + i:KVSEQ_PROMPT + i + 1], st,
                                  KVSEQ_PROMPT + i, ctx)
            out.append(ctx.gather(lg, ("batch", "seq", "vocab"),
                                  (KVSEQ_ROWS, 1, padded_vocab(cfg)))[:, 0].float())
        shapes = {k: list(v.shape) for k, v in st.items()}
    return torch.stack(out), shapes


def kvseq_products():
    """Granite's K1 products on a rank of 1x2 under its decode rule, at the
    prefill's and a decode step's rows: q heads and the f32 row-parallel
    products halved, k and v whole (the kv heads replicate), the gate|up
    and vocab slices."""
    from repro_torch.models.layers import padded_vocab

    import torch

    cfg, f32, out = _kvseq_cfg(), torch.float32, []
    d, hd, ff = cfg.d_model, cfg.head_dim_, cfg.d_ff // 2
    prods = [("wq", d, cfg.num_heads // 2 * hd, None), ("wk|wv", d, cfg.num_kv_heads * hd, None),
             ("wo", cfg.num_heads // 2 * hd, d, f32), ("wi", d, 2 * ff, None),
             ("mlp wo", ff, d, f32), ("head", d, padded_vocab(cfg) // 2, None)]
    for m in (KVSEQ_ROWS * KVSEQ_PROMPT, KVSEQ_ROWS):
        out.extend((f"granite {label} M={m}", m, k, n, dt) for label, k, n, dt in prods)
    return out


def train_sp_rank(rank, world, init, tmp):
    """One rank of [train_sp] (run by the phase in its own process)."""
    import torch
    import torch.distributed as dist

    from repro_torch.kernels.rmsnorm import rmsnorm_cuda

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank, world_size=world)
    rmsnorm_cuda.launches = 0
    with k1_calls() as calls, k4_k5_calls() as (k4, k5, k6):
        found = _train_sp_rank(torch, rank, tmp)
    found["rmsnorm"] = rmsnorm_cuda.launches
    found["k1_calls"] = sorted(calls, key=str)
    found["k4_calls"], found["k5_calls"] = sorted(k4, key=str), sorted(k5, key=str)
    found["k6_calls"] = sorted(k6, key=str)
    found["blocks"] = _plan_blocks()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(found, f)
    dist.destroy_process_group()


def _train_sp_rank(torch, rank, tmp):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.interop import shard_params
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.mesh_matmul import mesh_matmul
    from repro_torch.kernels.scramble import scramble_blocks_cuda
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import build_trainer
    from repro_torch.models import get_model
    from repro_torch.models.layers import ShardCtx
    from repro_torch.parallel.sharding import PARAM_RULES, TRAIN_RULES
    from repro_torch.train.train_step import abstract_train_state
    from repro_torch.tree import tree_leaves

    cfg = _train_tp_cfgs()["mesh-paper 1x2"]
    host = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH, seed=0))._host_batch(0)
    names = ("data", "model")
    meshes = {"2x2": make_local_mesh((2, 2), names),
              "1x2 a": DeviceMesh("cpu", torch.arange(2).reshape(1, 2), mesh_dim_names=names),
              "1x2 b": DeviceMesh("cpu", torch.arange(2, 4).reshape(1, 2),
                                  mesh_dim_names=names)}
    found = {}

    def launches():
        return dict(k1=mesh_matmul.launches, k3=scramble_blocks_cuda.launches,
                    k6=flash_attention.launches)

    def gib(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree)) / 2**30

    def sp(case, mesh, prules):
        step, state, data = build_trainer(cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ, mesh=mesh,
                                          lr=TRAIN_LR, total_steps=2, seed=0, device="cuda",
                                          rules=TRAIN_RULES, param_rules=prules)
        coord = dict(zip(names, mesh.get_coordinate()))
        model = get_model(cfg)
        tp_only = shard_params(abstract_train_state(model), model, ShardCtx(mesh, TRAIN_RULES))
        res = {"coord": coord, "state_gib": gib(state), "tp_state_gib": gib(tp_only)}
        mesh_matmul.launches = scramble_blocks_cuda.launches = 0
        res["grads"] = _tp_grads(torch, case, step, state["params"], host, tmp, step.blocks,
                                 compare=coord == {"data": 0, "model": 0})
        res["grads"]["launches"] = launches()
        batch = next(data)
        before = launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        state, met = step(state, batch)
        torch.cuda.synchronize()
        res["step"] = dict(wall_s=time.monotonic() - t0, loss=float(met["loss"]),
                           launches={k: v - before[k] for k, v in launches().items()},
                           peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        del state, step, data
        _free(torch)
        return res

    def kvseq(mesh):
        res = {}
        rules = _kvseq_rules()
        for tag, f32 in (("bf16", False), ("f32", True)):
            c = _kvseq_cfg(f32)
            model = get_model(c)
            full = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
            ctx = ShardCtx(mesh, rules)
            params = shard_params(full, model, ctx)
            del full
            _free(torch)
            flash_attention.launches = mesh_matmul.launches = 0
            t0 = time.monotonic()
            logits, shapes = _kvseq_decode(torch, c, params, model, ctx,
                                           ShardCtx(mesh, rules.replace(kv_seq=None)))
            want = torch.load(os.path.join(tmp, f"kvseq_{tag}.pt")).cuda()
            vocab = c.vocab_size
            res[tag] = dict(err=(logits[..., :vocab] - want[..., :vocab]).abs().max().item(),
                            scale=want[..., :vocab].abs().max().item(), shapes=shapes,
                            argmax_equal=bool(torch.equal(logits[..., :vocab].argmax(-1),
                                                          want[..., :vocab].argmax(-1))),
                            wall_s=time.monotonic() - t0, launches=launches())
            del params, logits, want
            _free(torch)
        return res

    t0 = time.monotonic()
    if rank < 2:
        found["mesh-paper sp 1x2"] = sp("mesh-paper sp 1x2", meshes["1x2 a"], None)
    else:
        found["kvseq 1x2"] = kvseq(meshes["1x2 b"])
    found["1x2 wall_s"] = time.monotonic() - t0
    dist.barrier()
    t0 = time.monotonic()
    found["mesh-paper fsdp 2x2"] = sp("mesh-paper fsdp 2x2", meshes["2x2"], PARAM_RULES)
    found["2x2 wall_s"] = time.monotonic() - t0
    return found


def phase_train_sp(torch):
    """Sequence parallelism, FSDP and the sequence-sharded KV cache on
    TRAIN_SP_WORLD ranks sharing the card (constants above): the parent
    computes the single-process references and plans every shard shape,
    the ranks run, and the parent holds their gradients, logits, launches
    and every K1 and K6 call they made.  Walls are printed, never as
    speeds."""
    import shutil

    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import get_model
    from repro_torch.models.layers import NO_SHARD
    from repro_torch.optim import global_norm
    from repro_torch.train.train_step import _grads_of
    from repro_torch.tree import tree_leaves

    cfg = _train_tp_cfgs()["mesh-paper 1x2"]
    _free(torch)
    t_phase = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="train_sp")
    try:
        with k1_calls() as parent_calls:
            planned = plan_products(torch, [p for p in train_tp_products(torch)
                                            if p[0].startswith("mesh-paper")]
                                    + kvseq_products())
            model = get_model(cfg)
            params = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
            batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                           global_batch=TRAIN_BATCH, seed=0))._host_batch(0)
            batch = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            grads, met = _grads_of(model, params, batch)
            single_peak = torch.cuda.max_memory_allocated() / 2**30
            ref = {"loss": float(met["loss"]), "norm": float(global_norm(grads))}
            torch.save({**ref, "grads": [g.cpu() for g in tree_leaves(grads)]},
                       os.path.join(tmp, "mesh-paper sp 1x2.pt"))
            os.link(os.path.join(tmp, "mesh-paper sp 1x2.pt"),
                    os.path.join(tmp, "mesh-paper fsdp 2x2.pt"))
            del params, grads, met, batch, model
            _free(torch)
            for tag, f32 in (("bf16", False), ("f32", True)):
                c = _kvseq_cfg(f32)
                model = get_model(c)
                params = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
                logits, _ = _kvseq_decode(torch, c, params, model, NO_SHARD, NO_SHARD)
                torch.save(logits.cpu(), os.path.join(tmp, f"kvseq_{tag}.pt"))
                del params, logits, model
                _free(torch)
        log(f"[train_sp] single-process references (mesh-paper's kernel step: loss"
            f" {ref['loss']:.6f}, grad norm {ref['norm']:.6f}, peak {single_peak:.2f} GiB;"
            f" {KVSEQ_ARCH}'s dense decode, bf16 and f32) and {len(planned)} shard shapes"
            f" planned in {time.monotonic() - t_phase:.1f} s")
        t0 = time.monotonic()
        runs = _spawn(lambda r: (
            "import chip_smoke; chip_smoke.train_sp_rank("
            f"{r}, {TRAIN_SP_WORLD}, {os.path.join(tmp, 'gloo')!r}, {tmp!r})"),
            TRAIN_SP_WORLD, TRAIN_SP_TIMEOUT_S)
        wall = time.monotonic() - t0
        bad = [f"rank {r}: rc={rc} {e[-3000:]}" for r, (rc, _, e) in enumerate(runs) if rc != 0]
        check(not bad, "[train_sp] rank failures:\n" + "\n".join(bad))
        ranks = [json.loads(Path(tmp, f"rank{r}.json").read_text())
                 for r in range(TRAIN_SP_WORLD)]
        parent_blocks = _plan_blocks()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[train_sp] {TRAIN_SP_WORLD} gloo ranks on one card: {wall:.1f} s wall in all, process"
        " start, CUDA init and every model's init included (not a speed)")

    failed = []
    for case in TRAIN_SP_CASES:
        loss_tol, norm_tol, leaf_tol = TRAIN_SP_TOL[case]
        for r, f in enumerate(ranks):
            if case not in f:
                continue
            res = f[case]
            g, st = res["grads"], res["step"]
            tr = g["traffic"]
            if "leaves" in g:
                d_loss = abs(g["loss"] - g["want_loss"])
                d_norm = abs(g["grad_norm"] - g["want_norm"]) / g["want_norm"]
                worst = sorted(g["leaves"], key=lambda x: x[1])
                top = ", ".join(f"{p} {rel:.3e}" for p, rel, _, _ in reversed(worst[-4:]))
                log(f"[train_sp] {case} rank {r}: one step's gradients of batch 0 gathered"
                    f" against the single-process kernel step's: loss |d| {d_loss:.3e} (tol"
                    f" {loss_tol}), grad norm {100 * d_norm:.5f} % (tol {100 * norm_tol:g} %),"
                    f" per-parameter ||d||/||g|| largest: {top} (tol {leaf_tol}) of"
                    f" {len(g['leaves'])} leaves")
                if (d_loss > loss_tol or d_norm > norm_tol or worst[-1][1] > leaf_tol
                        or not math.isfinite(d_loss + d_norm)
                        or not all(math.isfinite(x[1]) for x in worst)):
                    failed.append(f"{case} rank {r} gradients: loss {d_loss}, norm {d_norm},"
                                  f" leaf {worst[-1]}")
            log(f"[train_sp] {case} rank {r} {res['coord']}: its train state"
                f" {res['state_gib']:.2f} GiB (the same mesh without FSDP"
                f" {res['tp_state_gib']:.2f} GiB), peak {g['peak_gib']:.2f} GiB in the"
                f" gradients and {st['peak_gib']:.2f} GiB in a step ([train_tp]'s 2x2 rank:"
                f" {TRAIN_TP_2X2 or 'not run here'}; the single process {single_peak:.2f} GiB);"
                f" all-reduces {tr['all_reduce']} ({tr['all_reduce_bytes'] / 2**20:.1f} MiB),"
                f" all-gathers {tr['all_gather']} ({tr['all_gather_bytes'] / 2**20:.1f} MiB) in"
                f" the gradients; launches: gradients {g['launches']}, the step {st['launches']}"
                f" (loss {st['loss']:.5f}, wall {st['wall_s']:.2f} s, not a speed)")
            for what, got in (("gradients", g["launches"]), ("step", st["launches"])):
                if (got["k1"], got["k3"]) != (STEP_LAUNCHES["mesh_matmul"],
                                              STEP_LAUNCHES["scramble_blocks"]):
                    failed.append(f"{case} rank {r} {what} launches {got}")
            if case.startswith("mesh-paper fsdp") and not (
                    res["state_gib"] < 0.6 * res["tp_state_gib"]):
                failed.append(f"{case} rank {r}: FSDP state {res['state_gib']} GiB, not about"
                              f" half of {res['tp_state_gib']}")
            if not math.isfinite(st["loss"]):
                failed.append(f"{case} rank {r} loss {st['loss']}")
        rep = {}
        for f in ranks:
            if case in f:
                rep.setdefault(f[case]["coord"]["data"], []).append(
                    f[case]["grads"]["replicated_sha"])
        if not all(all(x == v[0] for x in v) and v[0] for v in rep.values()):
            failed.append(f"{case}: replicated gradients differ across the 'model' ranks")
    for r, f in enumerate(ranks):
        if "kvseq 1x2" not in f:
            continue
        for tag, tol in (("bf16", KVSEQ_TOL), ("f32", KVSEQ_F32_TOL)):
            k = f["kvseq 1x2"][tag]
            log(f"[train_sp] {KVSEQ_ARCH} at {KVSEQ_LAYERS} layers, {tag}, rank {r} of 1x2"
                f" (kv_heads None, kv_seq 'model'): {KVSEQ_STEPS} teacher-forced decode steps"
                f" of {KVSEQ_ROWS} rows against the single process's dense decode: max |d|"
                f" {k['err']:.4g} (tol {tol}; max |logit| {k['scale']:.3g}), argmax equal"
                f" {k['argmax_equal']}; cache blocks {k['shapes']}; launches {k['launches']};"
                f" wall {k['wall_s']:.1f} s (not a speed)")
            half = KVSEQ_MAX // 2
            if k["err"] > tol or not math.isfinite(k["err"]) or any(
                    shp[2] != half for shp in k["shapes"].values()):
                failed.append(f"rank {r} kvseq {tag}: {k}")
        if f["kvseq 1x2"]["bf16"]["launches"]["k6"] != KVSEQ_LAYERS:
            failed.append(f"rank {r} kvseq K6 launches {f['kvseq 1x2']['bf16']['launches']}")
        moved = {k: (v, parent_blocks.get(k)) for k, v in f["blocks"].items()
                 if k in parent_blocks and parent_blocks[k] != v}
        if moved:
            failed.append(f"rank {r} planned other blocks than this process: {moved}")
    log(f"[train_sp] R1 launches on the ranks: {[f['rmsnorm'] for f in ranks]}; walls: 1x2"
        f" {[round(f['1x2 wall_s'], 1) for f in ranks]} s, 2x2"
        f" {[round(f['2x2 wall_s'], 1) for f in ranks]} s (not speeds)")
    if not all(f["rmsnorm"] > 0 for f in ranks):
        failed.append(f"R1 never launched on a rank: {[f['rmsnorm'] for f in ranks]}")
    calls = parent_calls | {_as_key(key) for f in ranks for key in f["k1_calls"]}
    here, before = hold_k1_keys(torch, "train_sp", calls)
    log(f"[train_sp] {len(calls)} distinct K1 calls of the parent and the ranks: {before} held"
        f" before, {here} held here on the same blocks")
    k4_held, k5_held, k6_held = hold_k4_k5_calls(
        torch, "train_sp", set(), set(), {_as_key(x) for f in ranks for x in f["k6_calls"]})
    log(f"[train_sp] the ranks' distinct K6 calls ({k6_held}: Granite's prefill on 16 of 32"
        " heads) each held against the plain version at [K6]'s limits")
    if not k6_held or any(f["k4_calls"] or f["k5_calls"] for f in ranks):
        failed.append(f"K4/K5/K6 calls recorded: {k4_held} {k5_held} {k6_held}")
    check(not failed, "[train_sp] failed:\n" + "\n".join(failed))
    cases = [f[c] for f in ranks for c in TRAIN_SP_CASES if c in f]
    kv = [f["kvseq 1x2"][t]["launches"] for f in ranks if "kvseq 1x2" in f for t in ("bf16",
                                                                                    "f32")]
    return {"mesh_matmul": sum(c["grads"]["launches"]["k1"] + c["step"]["launches"]["k1"]
                               for c in cases) + sum(x["k1"] for x in kv),
            "scramble_blocks": sum(c["grads"]["launches"]["k3"] + c["step"]["launches"]["k3"]
                                   for c in cases),
            "flash_attention": sum(x["k6"] for x in kv),
            "rmsnorm": sum(f["rmsnorm"] for f in ranks)}


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

_DRYRUN_CPU = """
import json
from repro_torch.launch import dryrun, roofline
arts = []
for arch, shape in {cells!r}:
    art = dryrun.run_cell(arch, shape, probe=False)
    row = roofline.analyze_artifact(art)
    if row is not None:
        print(f"[roofline] {{arch}} x {{shape}}: compute {{row['t_compute_s']:.4e}} s, memory"
              f" {{row['t_memory_s']:.4e}} s, collective {{row['t_collective_s']:.4e}} s,"
              f" dominant {{row['dominant']}}, useful FLOP ratio {{row['useful_ratio']:.3f}},"
              f" roofline fraction {{row['roofline_fraction']:.3f}} (data-sheet rates)",
              flush=True)
    arts.append(art)
print("ARTIFACTS " + json.dumps(arts))
"""


def _dryrun_card(torch, name):
    """Rank 0's real step of DRYRUN_ARCH x the cell `name` (a shape, or
    "train_4k tuned": 'seq_sp' and FSDP) at DRYRUN_DEPTH on the card under
    a fake group of 256 ranks, against the dry run's artifact of the same
    cell: (artifact, reading)."""
    import dataclasses

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.parallel.sharding import PARAM_RULES

    shape_name, tuned = name.split()[0], name.endswith("tuned")
    over = dict(DRYRUN_TUNED, num_layers=DRYRUN_DEPTH)
    cfg = dataclasses.replace(get_config(DRYRUN_ARCH), **over)
    shape = SHAPES[shape_name]
    _free(torch)
    with dryrun.fake_group(256):
        art = dryrun.run_cell(DRYRUN_ARCH, shape_name, cfg_overrides=over, probe=False,
                              verbose=False, tuned=tuned)
        mesh = make_production_mesh()
        rules = dryrun._rules_for(cfg, shape, mesh, tuned=tuned)
        param_rules = PARAM_RULES if tuned else None
        gen = torch.Generator(device="cuda").manual_seed(0)

        def make(t):
            if t.dim() == 0:  # the optimizer's count and step
                return torch.zeros((), dtype=t.dtype, device="cuda")
            if t.dtype.is_floating_point:
                x = torch.randn(t.shape, generator=gen, dtype=torch.float32, device="cuda")
                return x.mul_(0.02).to(t.dtype)
            return torch.randint(0, cfg.vocab_size, t.shape, generator=gen, dtype=t.dtype,
                                 device="cuda")

        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        step, args = dryrun.build_step(cfg, shape, mesh, rules, param_rules, make=make)
        torch.cuda.synchronize()
        args_bytes = torch.cuda.memory_allocated() - base
        out = step(*args)  # warm: plans, library handles
        del out
        _free(torch)
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = 0
        t0 = time.monotonic()
        out = step(*args)
        torch.cuda.synchronize()
        ms = (time.monotonic() - t0) * 1e3
        reading = dict(peak=torch.cuda.max_memory_allocated() - base, args=args_bytes, ms=ms,
                       k6=flash_attention.launches)
        del out, args, step
    _free(torch)
    return art, reading


def phase_dryrun(torch, smi: str):
    """(a) DRYRUN_CELLS traced on the CPU in a subprocess (run meanwhile);
    (b), (c) rank 0's train and decode steps on the card against their
    dry runs (constants above)."""
    from repro_torch.launch import roofline

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="",
               PYTHONWARNINGS="ignore")
    env.pop("REPRO_COSTMODEL_TIMED", None)
    t0 = time.monotonic()
    proc = subprocess.Popen([sys.executable, "-c", _DRYRUN_CPU.format(cells=DRYRUN_CELLS)],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        card = {name: _dryrun_card(torch, name) for name in DRYRUN_CARD}
        out, err = proc.communicate(timeout=DRYRUN_CPU_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    cpu_s = time.monotonic() - t0
    check(proc.returncode == 0, f"[dryrun] CPU cells failed: rc={proc.returncode} {err[-3000:]}")
    for line in out.splitlines():
        if not line.startswith("ARTIFACTS "):
            log(f"[dryrun] {line}")
    arts = json.loads(next(s for s in out.splitlines() if s.startswith("ARTIFACTS "))[10:])
    bad = []
    for (arch, shape), art in zip(DRYRUN_CELLS, arts):
        want = "skipped" if (arch, shape) in DRYRUN_SKIPPED else "ok"
        if art["status"] != want:
            bad.append(f"{arch} x {shape}: {art['status']} ({art.get('error')}), want {want}")
        elif want == "ok" and not all(
                math.isfinite(art[k]) and art[k] > 0
                for k in ("flops_per_device", "bytes_per_device", "collective_link_bytes")):
            bad.append(f"{arch} x {shape}: counts not finite and positive")
    log(f"[dryrun] (a) {len(arts)} cells of pod16x16 traced on the CPU in {cpu_s:.1f} s (run"
        f" beside the card's steps): statuses {[a['status'] for a in arts]}")
    k6_want = {"train_4k": 2 * DRYRUN_DEPTH, "train_4k tuned": 2 * DRYRUN_DEPTH,
               "decode_32k": 0}
    for (name, (art, r)), letter in zip(card.items(), "bcd"):
        ma = art["memory_analysis"]
        want = ma["argument_size_in_bytes"] + ma["temp_size_in_bytes"]
        rel = abs(r["peak"] - want) / want
        bound = roofline.analyze_artifact(art)
        log(f"[dryrun] ({letter}) {DRYRUN_ARCH} x {name} at"
            f" {DRYRUN_DEPTH} layers, rank 0 of pod16x16 on the card ({smi}): peak above the"
            f" baseline {r['peak'] / 2**30:.3f} GiB (its arguments {r['args'] / 2**30:.3f} GiB)"
            f" against the dry run's argument + temp {want / 2**30:.3f} GiB (arguments"
            f" {ma['argument_size_in_bytes'] / 2**30:.3f} GiB): off by {100 * rel:.4f} % (tol"
            f" {100 * DRYRUN_MEM_TOL[name]:.1f} %); K6 launches {r['k6']} (want {k6_want[name]}); step"
            f" {r['ms']:.1f} ms wall beside the roofline's t_bound"
            f" {1e3 * bound['t_bound_s']:.3f} ms ({bound['dominant']}; a reading, not held)")
        if rel > DRYRUN_MEM_TOL[name]:
            bad.append(f"{name}: peak {r['peak']} vs the dry run's {want} ({100 * rel:.2f} %)")
        if r["k6"] != k6_want[name]:
            bad.append(f"{name}: K6 launched {r['k6']} times, want {k6_want[name]}")
    check(not bad, "[dryrun] " + "; ".join(bad))
    return {"flash_attention": sum(r["k6"] for _, r in card.values())}


def healthy(name, fn):
    """`fn` as a phase that arms no fault: the resilience ledger is cleared
    before it, and after it no planner event (`plan.*`, `guard.*`) may have
    been recorded and every cached plan must still run on its own backend,
    so no main-path GEMM left its kernel unseen."""
    def run(torch, *args):
        from repro_torch.kernels import api
        from repro_torch.kernels.rmsnorm import rmsnorm_cuda
        from repro_torch.resilience import ledger

        ledger.clear()
        rmsnorm_cuda.launches = 0
        t0 = time.monotonic()
        out = fn(torch, *args)
        RMSNORM_BY_PHASE[name] = rmsnorm_cuda.launches
        log(f"[{name}] phase wall {time.monotonic() - t0:.1f} s; R1 launches"
            f" {rmsnorm_cuda.launches}")
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
        ("k1", phase_k1), ("k4", phase_k4), ("k3", phase_k3), ("rmsnorm", phase_rmsnorm),
        ("k1_bwd", phase_k1_backward),
        ("k5", phase_k5), ("k5_bwd", phase_k5_backward), ("k6", phase_k6),
        ("k6_bwd", phase_k6_backward), ("serve", phase_serve), ("train", phase_train),
        ("serve_moe", phase_serve_moe), ("serve_qwen2", phase_serve_qwen2),
        ("train_flash", phase_train_flash), ("serve_qwen2_moe", phase_serve_qwen2_moe),
        ("train_moe", phase_train_moe), ("configs", phase_configs),
        ("serve_rwkv", phase_serve_rwkv), ("serve_pixtral", phase_serve_pixtral),
        ("serve_zamba", phase_serve_zamba), ("serve_whisper", phase_serve_whisper),
        ("train_rwkv", phase_train_rwkv), ("train_zamba", phase_train_zamba),
        ("sharded", phase_sharded), ("train_dp", phase_train_dp),
        ("serve_tp", phase_serve_tp), ("serve_tp_families", phase_serve_tp_families),
        ("train_tp", phase_train_tp), ("train_sp", phase_train_sp))}
    phases["paper"] = healthy("paper", lambda torch: phase_paper(torch, smi))
    phases["planner"] = phase_planner
    phases["obs"] = healthy("obs", lambda torch: phase_obs(torch, smi))
    phases["dryrun"] = healthy("dryrun", lambda torch: phase_dryrun(torch, smi))
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
    r1_err, r1, r1_decode = phases["rmsnorm"](torch)
    k1_bwd_err, k1_train = phases["k1_bwd"](torch)
    k1_err = max(k1_err, k1_bwd_err)
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
    serve_rwkv = phases["serve_rwkv"](torch)
    serve_pixtral = phases["serve_pixtral"](torch)
    serve_zamba = phases["serve_zamba"](torch)
    serve_whisper = phases["serve_whisper"](torch)
    train_rwkv = phases["train_rwkv"](torch)
    train_zamba = phases["train_zamba"](torch)
    sharded = phases["sharded"](torch)
    train_dp = phases["train_dp"](torch)
    serve_tp = phases["serve_tp"](torch)
    serve_tpf = phases["serve_tp_families"](torch)
    train_tp = phases["train_tp"](torch)
    train_sp = phases["train_sp"](torch)
    dryrun = phases["dryrun"](torch)
    phases["paper"](torch)
    planner = phases["planner"](torch)
    phases["obs"](torch)

    # R1 runs wherever a model normalises on the card: its launches in each
    # model phase's own process, and [train_sp]'s ranks'.
    r1_paths = {k: v for k, v in RMSNORM_BY_PHASE.items()
                if k not in ("k1", "k4", "k3", "rmsnorm", "k1_bwd", "k5", "k5_bwd", "k6",
                             "k6_bwd")}
    r1_paths["train_sp ranks (4)"] = train_sp["rmsnorm"]
    check(r1_paths.get("serve", 0) > 0 and r1_paths.get("train", 0) > 0,
          f"R1 never launched on the main path: {r1_paths}")

    def row(name, source, replaces, launches, err, t, shape, **extra):
        return dict(name=name, route="cuda", source=f"src/repro_torch/csrc/{source}",
                    replaces=replaces, launches=launches, max_abs_err=err, ms=t["ms"],
                    plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                    library_ms=t["library_ms"], shape=shape, **extra)

    kernels = [
        row("mesh_matmul", "mesh_matmul.cu", "src/repro/kernels/mesh_matmul.py:341",
            serve["mesh_matmul"] + train["mesh_matmul"] + serve_moe["mesh_matmul"]
            + serve_qwen2_moe["mesh_matmul"] + train_moe["mesh_matmul"]
            + planner["mesh_matmul"] + serve_rwkv["mesh_matmul"] + serve_zamba["mesh_matmul"]
            + serve_whisper["mesh_matmul"] + train_rwkv["mesh_matmul"]
            + train_zamba["mesh_matmul"] + sharded["mesh_matmul"] + train_dp["mesh_matmul"]
            + train_dp["pipeline_mesh_matmul"] + serve_tp["mesh_matmul"]
            + serve_tpf["mesh_matmul"] + train_tp["mesh_matmul"] + train_sp["mesh_matmul"],
            k1_err, k1,
            "one decode tick: 25 launches at M=4",
            launches_by_path={"serve": serve["mesh_matmul"], "train": train["mesh_matmul"],
                              "serve_moe": serve_moe["mesh_matmul"],
                              "serve_qwen2_moe": serve_qwen2_moe["mesh_matmul"],
                              "train_moe": train_moe["mesh_matmul"],
                              "planner": planner["mesh_matmul"],
                              "serve_rwkv": serve_rwkv["mesh_matmul"],
                              "serve_zamba": serve_zamba["mesh_matmul"],
                              "serve_whisper": serve_whisper["mesh_matmul"],
                              "train_rwkv": train_rwkv["mesh_matmul"],
                              "train_zamba": train_zamba["mesh_matmul"],
                              "sharded (4 ranks)": sharded["mesh_matmul"],
                              "train_dp (2 ranks)": train_dp["mesh_matmul"],
                              "pipeline (4 ranks)": train_dp["pipeline_mesh_matmul"],
                              "serve_tp (2 ranks)": serve_tp["mesh_matmul"],
                              "serve_tp_families (4 ranks)": serve_tpf["mesh_matmul"],
                              "train_tp (4 ranks)": train_tp["mesh_matmul"],
                              "train_sp (4 ranks)": train_sp["mesh_matmul"]},
            launches_by_tile=K1_TILES, train_step=k1_train,
            batched={**k1b, "replaces": "src/repro/kernels/mesh_matmul.py:404",
                     "shape": "B=4 M=128 K=1024 N=512 bf16"}),
        row("paged_attention", "paged_attention.cu",
            "src/repro/kernels/paged_attention.py:182",
            serve["paged_attention"] + serve_moe["paged_attention"]
            + serve_qwen2["paged_attention"] + serve_qwen2_moe["paged_attention"]
            + configs["paged_attention"] + serve_pixtral["paged_attention"]
            + serve_tp["paged_attention"] + serve_tpf["paged_attention"], k4_err, k4,
            "one launch: S=4 H=KV=16 hd=128 bf16, 128-160 token contexts",
            launches_by_path={"serve": serve["paged_attention"],
                              "serve_moe": serve_moe["paged_attention"],
                              "serve_qwen2": serve_qwen2["paged_attention"],
                              "serve_qwen2_moe": serve_qwen2_moe["paged_attention"],
                              "configs": configs["paged_attention"],
                              "serve_pixtral": serve_pixtral["paged_attention"],
                              "serve_tp (2 ranks)": serve_tp["paged_attention"],
                              "serve_tp_families (4 ranks)": serve_tpf["paged_attention"]},
            qwen2={**k4_qwen, "shape": f"one launch: S=4 H=28 KV=4 hd=128 bf16, contexts"
                   f" {QWEN_LIVE}"}),
        row("scramble_blocks", "scramble_blocks.cu",
            "src/repro/kernels/scramble_kernel.py:41",
            train["scramble_blocks"] + train_dp["scramble_blocks"]
            + train_dp["pipeline_scramble_blocks"] + train_tp["scramble_blocks"]
            + train_sp["scramble_blocks"], k3_err, k3,
            f"one launch: ({TRAIN_BATCH}, {TRAIN_SEQ}, 2048) bf16, 16x16 blocks of 128^2;"
            " library_ms is x.clone() (same bytes, no permutation)",
            launches_by_path={"train": train["scramble_blocks"],
                              "train_dp (2 ranks)": train_dp["scramble_blocks"],
                              "pipeline (4 ranks)": train_dp["pipeline_scramble_blocks"],
                              "train_tp (4 ranks)": train_tp["scramble_blocks"],
                              "train_sp (4 ranks)": train_sp["scramble_blocks"]}),
        row("grouped_mesh_matmul", "grouped_matmul.cu", "src/repro/kernels/grouped.py:119",
            serve_moe["grouped_mesh_matmul"] + serve_qwen2_moe["grouped_mesh_matmul"]
            + train_moe["grouped_mesh_matmul"] + sharded["grouped_mesh_matmul"]
            + serve_tp["grouped_mesh_matmul"] + train_tp["grouped_mesh_matmul"], k5_err, k5_tick,
            f"one OLMoE decode step: 32 launches (wi, wo x 16 layers), 64 experts x 8 rows,"
            f" {SLOTS} tokens routed; library_ms is torch.bmm + segment mask",
            launches_by_path={"serve_moe": serve_moe["grouped_mesh_matmul"],
                              "serve_qwen2_moe": serve_qwen2_moe["grouped_mesh_matmul"],
                              "train_moe": train_moe["grouped_mesh_matmul"],
                              "sharded (4 ranks)": sharded["grouped_mesh_matmul"],
                              "serve_tp (2 ranks)": serve_tp["grouped_mesh_matmul"],
                              "train_tp (2 ranks)": train_tp["grouped_mesh_matmul"]},
            launches_by_tile=K5_TILES, qwen2_moe_decode_step=serve_qwen2_moe["k5_decode_step"],
            prefill={**k5_prefill, "shape": f"one {PROMPT}-token prefill: 32 launches,"
                     " 64 experts x 128 rows"}),
        row("flash_attention", "flash_attention.cu", "src/repro/kernels/flash_attention.py:97",
            serve_qwen2["flash_attention"] + train_flash["flash_attention"]
            + configs["flash_attention"] + serve_pixtral["flash_attention"]
            + serve_zamba["flash_attention"] + serve_whisper["flash_attention"]
            + train_zamba["flash_attention"] + serve_tp["flash_attention"]
            + serve_tpf["flash_attention"] + train_tp["flash_attention"]
            + train_sp["flash_attention"] + dryrun["flash_attention"], k6_err,
            k6["qwen2 T=2048"],
            "one launch: Qwen2-7B prefill B=1 T=2048 H=28 KV=4 hd=128 bf16 causal; library_ms"
            " is scaled_dot_product_attention (is_causal, enable_gqa)",
            launches_by_path={"serve_qwen2": serve_qwen2["flash_attention"],
                              "train_flash": train_flash["flash_attention"],
                              "configs": configs["flash_attention"],
                              "serve_pixtral": serve_pixtral["flash_attention"],
                              "serve_zamba": serve_zamba["flash_attention"],
                              "serve_whisper": serve_whisper["flash_attention"],
                              "train_zamba": train_zamba["flash_attention"],
                              "serve_tp (2 ranks)": serve_tp["flash_attention"],
                              "serve_tp_families (4 ranks)": serve_tpf["flash_attention"],
                              "train_tp (2 ranks)": train_tp["flash_attention"],
                              "train_sp (2 ranks)": train_sp["flash_attention"],
                              "dryrun": dryrun["flash_attention"]},
            device_ms=k6["qwen2 T=2048"]["device_ms"],
            library_device_ms=k6["qwen2 T=2048"]["library_device_ms"],
            t4096=k6["qwen2 T=4096"], mesh_paper_train=k6["mesh-paper train"],
            whisper_encoder=k6["whisper encoder"], zamba_shared=k6["zamba shared block"]),
        row("rmsnorm", "rmsnorm.cu", "src/repro/models/layers.py:240 (an XLA op in the"
            " reference: R1 is the port's own kernel, no Pallas function)",
            sum(r1_paths.values()), r1_err, r1,
            f"one launch: ({TRAIN_BATCH * TRAIN_SEQ}, 2048) bf16, mesh-paper's training"
            " activations; library_ms is torch.nn.functional.rms_norm",
            launches_by_path=r1_paths, decode={**r1_decode, "shape": f"({SLOTS}, 2048) bf16"}),
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
