#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py            # from the repository root; needs one card

Three phases; any failure raises and the script exits non-zero:

  1. build   every CUDA kernel of the serving path from `src/repro_torch/csrc`
             with nvcc (sm_90a), printing ptxas' register/spill report;
  2. kernels each kernel against its plain PyTorch version at the shapes the
             serving path gives it, with a stated tolerance, then its time, the
             plain version's time, one library call computing the same
             function (timed here only, never used by the port) and the
             least time the card could take (bytes at 3.35 TB/s or
             operations at the peak rate of their type, whichever is larger);
  3. serve   full-width mesh-paper (4 layers, d_model 2048, 16 heads, d_ff
             8192, vocab 32768, bf16, random weights from a seed) through
             `ContinuousBatchingServer`: 8 requests x 128-token prompts x 32
             new tokens on 4 slots, with every kernel's launch count read
             around the run, and the output checked against the dense-cache
             path (`generate`, plain `_sdpa` attention).

The last lines are the card's `nvidia-smi` name and power limit, the
`{"kernels": [...]}` JSON, and `{"ok": true, "device": {...}}`.  It imports
nothing of JAX and nothing of the JAX package `repro`.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
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


def time_ms(torch, calls, iters: int) -> float:
    """Mean device time of one call, CUDA events around `iters` calls that
    cycle through `calls` (distinct operands, so weights come from HBM)."""
    for c in calls[:3]:
        c()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        calls[i % len(calls)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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


def phase_k1(torch):
    """K1 (mesh_matmul) against mesh_matmul_torch, then timings."""
    from repro_torch.kernels.mesh_matmul import mesh_matmul, mesh_matmul_torch

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(1)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    def tol_of(ref, dtype):
        # f32: only the summation order differs (<< 1e-5 relative; TF32 would
        # show ~5e-4).  bf16 output: the two f32 sums may round to adjacent
        # bf16 values, 2^-7 relative at most.
        return (1e-5 if dtype == torch.float32 else 2.0**-7) * ref.abs().max().item()

    cases = []
    for label, (k, n) in MESH_PAPER_GEMMS.items():
        for m in (SLOTS, PROMPT):
            cases.append((f"{label} M={m}", (m, k, n), torch.bfloat16, {}))
    cases += [
        ("f32 no-TF32", (PROMPT, 2048, 2048), torch.float32, {}),
        ("bias+gelu+residual", (PROMPT, 2048, 2048), torch.bfloat16,
         dict(activation="gelu", bias=True, residual=True)),
        ("stagger=False", (PROMPT, 2048, 2048), torch.bfloat16, dict(stagger=False)),
        ("scramble_out 8x8 grid", (1024, 2048, 1024), torch.bfloat16, dict(scramble_out=True)),
        ("batched B=4", (PROMPT, 1024, 512), torch.bfloat16, dict(batch=4)),
    ]
    max_err = 0.0
    for label, (m, k, n), dtype, kw in cases:
        kw = dict(kw)
        lead = (kw.pop("batch"),) if "batch" in kw else ()
        a, b = rnd(*lead, m, k, dtype=dtype), rnd(*lead, k, n, dtype=dtype)
        if kw.pop("bias", False):
            kw["bias"] = rnd(n, dtype=dtype)
        if kw.pop("residual", False):
            kw["residual"] = rnd(*lead, m, n, dtype=dtype)
        out = mesh_matmul(a, b, **kw)
        ref = mesh_matmul_torch(a, b, **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = tol_of(ref.float(), dtype)
        why = ("1e-5 max|ref|: summation order only, TF32 would show ~1e-4"
               if dtype == torch.float32 else "2^-7 max|ref|: adjacent bf16 roundings")
        log(f"[K1] {label:28s} {dtype} err={err:.3e} tol={tol:.3e} ({why})")
        check(bool(torch.isfinite(out.float()).all()), f"K1 {label}: non-finite output")
        check(err <= tol, f"K1 {label}: err {err} > tol {tol}")
        max_err = max(max_err, err)

    # Timings at the decode tick's shapes (M = 4 slots) and the prefill's.
    per = {}
    for label, (k, n) in MESH_PAPER_GEMMS.items():
        for m in (SLOTS, PROMPT):
            copies = max(1, math.ceil(2 * L2_BYTES / (k * n * 2)))
            a = rnd(m, k)
            bs = [rnd(k, n) for _ in range(copies)]
            ms = time_ms(torch, [lambda b=b: mesh_matmul(a, b) for b in bs], 30)
            plain = time_ms(torch, [lambda b=b: mesh_matmul_torch(a, b) for b in bs], 5)
            lib = time_ms(torch, [lambda b=b: torch.matmul(a, b) for b in bs], 30)
            bms, by = bound_ms(2 * (m * k + k * n + m * n), 2 * m * k * n, "bfloat16")
            per[(label, m)] = (ms, plain, lib, bms, by)
            log(
                f"[K1] time {label:20s} M={m:<4d} K={k:<5d} N={n:<6d} kernel={ms:.4f} ms"
                f" plain={plain:.4f} ms torch.matmul={lib:.4f} ms bound={bms:.4f} ms ({by})"
            )
    tick = {key: sum(per[(lbl, SLOTS)][i] * TICK_LAUNCHES[lbl] for lbl in TICK_LAUNCHES)
            for i, key in enumerate(("ms", "plain_ms", "library_ms", "bound_ms"))}
    share = {"bytes": 0.0, "operations": 0.0}  # which limit most of the tick's bound is
    for lbl, count in TICK_LAUNCHES.items():
        share[per[(lbl, SLOTS)][4]] += per[(lbl, SLOTS)][3] * count
    tick["bound_by"] = max(share, key=share.get)
    log(f"[K1] one decode tick (25 launches, M={SLOTS}): " + json.dumps(tick))
    return max_err, tick


def _paged_inputs(torch, g, s, h, kvh, hd, lengths, dtype):
    n_pages = max(-(-ln // PAGE) for ln in lengths) + 2
    pool_pages = 1 + s * n_pages
    rnd = lambda *shape: torch.randn(*shape, generator=g, device="cuda").to(dtype)  # noqa: E731
    q = rnd(s, h, hd)
    kp, vp = rnd(pool_pages, PAGE, kvh, hd), rnd(pool_pages, PAGE, kvh, hd)
    perm = torch.randperm(pool_pages - 1, generator=g, device="cuda") + 1
    bt = perm[: s * n_pages].reshape(s, n_pages).to(torch.int32)
    ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, kp, vp, bt, ln


def phase_k2(torch):
    """K2 (paged_attention_cuda) against paged_attention_torch, then timings."""
    from repro_torch.kernels.paged_attention import (
        gather_pages,
        paged_attention_cuda,
        paged_attention_torch,
    )

    g = torch.Generator(device="cuda").manual_seed(2)
    live = [PROMPT + NEW_TOKENS, PROMPT + 1, PROMPT + 21, PROMPT + 9]  # mid-page ends
    cases = [
        ("mesh-paper H=KV=16", (SLOTS, 16, 16, 128), live, torch.bfloat16),
        ("GQA rep=4", (SLOTS, 16, 4, 128), live, torch.bfloat16),
        ("f32 rep=2, length 1", (3, 8, 4, 64), [1, 13, 40], torch.float32),
    ]
    max_err = 0.0
    for label, (s, h, kvh, hd), lengths, dtype in cases:
        q, kp, vp, bt, ln = _paged_inputs(torch, g, s, h, kvh, hd, lengths, dtype)
        out = paged_attention_cuda(q, kp, vp, bt, ln)
        ref = paged_attention_torch(q, kp, vp, bt, ln)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        # bf16: probabilities round to bf16 before the p.v product at
        # different points (unnormalized per page in the kernel, normalized in
        # the plain version), each term off by <= 2^-8 relative, plus the
        # output rounding: 2^-6 of the largest |v|.  f32: summation order.
        vmax = vp.float().abs().max().item()
        tol = (2.0**-6 if dtype == torch.bfloat16 else 1e-5) * vmax
        why = ("2^-6 max|v|: p rounded to bf16 at different points, bf16 output"
               if dtype == torch.bfloat16 else "1e-5 max|v|: summation order only")
        log(f"[K2] {label:22s} {dtype} lengths={lengths} err={err:.3e} tol={tol:.3e} ({why})")
        check(bool(torch.isfinite(out.float()).all()), f"K2 {label}: non-finite output")
        check(err <= tol, f"K2 {label}: err {err} > tol {tol}")
        max_err = max(max_err, err)

    # Timing at the serving decode shape (one launch per layer and tick).
    s, h, kvh, hd = SLOTS, 16, 16, 128
    q, kp, vp, bt, ln = _paged_inputs(torch, g, s, h, kvh, hd, live, torch.bfloat16)
    ms = time_ms(torch, [lambda: paged_attention_cuda(q, kp, vp, bt, ln)], 50)
    plain = time_ms(torch, [lambda: paged_attention_torch(q, kp, vp, bt, ln)], 20)
    kg, vg = gather_pages(kp, bt).transpose(1, 2), gather_pages(vp, bt).transpose(1, 2)
    mask = (torch.arange(kg.shape[2], device="cuda")[None, :] < ln[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = time_ms(torch, [lambda: sdpa(q4, kg, vg, attn_mask=mask)], 50)
    tokens = sum(live)
    nbytes = 2 * (2 * q.numel() + 2 * tokens * kvh * hd) + 4 * (bt.numel() + ln.numel())
    bms, by = bound_ms(nbytes, 4 * h * hd * tokens, "bfloat16")
    log(
        f"[K2] time S={s} H={h} KV={kvh} hd={hd} lengths={live}: kernel={ms:.4f} ms"
        f" plain={plain:.4f} ms sdpa={lib:.4f} ms bound={bms:.5f} ms ({by})"
    )
    return max_err, dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by)


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

    mesh_matmul.launches = 0
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
    # (K1 + K2) and dense decode (K1 + _sdpa) must agree within LOGIT_TOL,
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
        dense = {k: torch.nn.functional.pad(c, (0, 0, 0, 0, 0, 8)) for k, c in caches.items()}
        n_pages = -(-(PROMPT + 8) // PAGE)
        pools = {k: torch.zeros((cfg.num_layers, 1 + n_pages, PAGE, 16, 128),
                                dtype=torch.bfloat16, device="cuda") for k in ("k", "v")}
        for k in ("k", "v"):
            c = torch.nn.functional.pad(caches[k][:, 0], (0, 0, 0, 0, 0, n_pages * PAGE - PROMPT))
            pools[k][:, 1:] = c.reshape(cfg.num_layers, n_pages, PAGE, 16, 128)
        bt = torch.arange(1, 1 + n_pages, dtype=torch.int32, device="cuda")[None]
        worst_diff = worst_gap = 0.0
        for i in range(7):
            tok = torch.tensor([[served[i]]], dtype=torch.int32, device="cuda")
            pos = PROMPT + i
            lg_d, dense = model.decode(params, tok, dense, pos)
            lg_p, pools = model.paged_decode(
                params, tok, pools, bt, torch.tensor([pos], dtype=torch.int32, device="cuda"))
            lg_d, lg_p = lg_d[0, -1].float(), lg_p[0, -1].float()
            worst_diff = max(worst_diff, (lg_d - lg_p).abs().max().item())
            worst_gap = max(worst_gap, (lg_d.max() - lg_d[served[i + 1]]).item())
    exact = sum(a == b for a, b in zip(served[:8], ref_tokens))
    log(f"[serve] req0 first 8 tokens: server={served[:8]} generate={ref_tokens} "
        f"(equal: {exact}/8); teacher-forced paged-vs-dense max |dlogit|={worst_diff:.4f}, "
        f"worst server-token gap to dense argmax={worst_gap:.4f} (tol {logit_tol})")
    check(worst_diff <= logit_tol, f"paged vs dense logits differ by {worst_diff}")
    check(worst_gap <= logit_tol, f"server token {worst_gap} below the dense argmax")
    profile_window(torch, model, params, scfg, prompts[:SLOTS])
    return launches


def profile_window(torch, model, params, scfg, prompts) -> None:
    """Where the serving time goes: one more run (4 requests, one wave of
    prefills then decode ticks) under torch.profiler, reporting device time
    by kernel and the device-busy share of the window's wall time.  The
    profiler's own host cost makes the busy share a lower bound."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.scheduler import ContinuousBatchingServer, Request

    server = ContinuousBatchingServer(model, params, scfg, device="cuda")
    reqs = [Request(rid=f"prof{i}", prompt=p, max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        server.run(reqs)
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    rows = []
    for ev in prof.key_averages():
        # Kernel events only: a CPU op's row repeats its kernels' time.
        dev_us = getattr(ev, "self_device_time_total", 0.0)
        if str(getattr(ev, "device_type", "")).endswith("CUDA") and dev_us > 0:
            rows.append((dev_us, ev.count, ev.key))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    log(f"[profile] {len(reqs)} requests x {NEW_TOKENS} tokens, {server.counters['ticks']} "
        f"ticks: wall={wall_us / 1e3:.1f} ms device busy={busy_us / 1e3:.1f} ms "
        f"({100 * busy_us / wall_us:.1f}% of wall; device time not seen = 'not measured')")
    for dev_us, count, key in rows[:10]:
        log(f"[profile]   {dev_us / 1e3:9.3f} ms {count:6d}x {key[:90]}")


def main() -> int:
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
    t_start = time.monotonic()
    phase_build(torch)
    k1_err, k1 = phase_k1(torch)
    k2_err, k2 = phase_k2(torch)
    torch.cuda.synchronize()
    launches = phase_serve(torch)
    kernels = [
        dict(name="mesh_matmul", route="cuda", source="src/repro_torch/csrc/mesh_matmul.cu",
             replaces="src/repro/kernels/mesh_matmul.py:341",
             launches=launches["mesh_matmul"], max_abs_err=k1_err, max_err=k1_err,
             ms=k1["ms"], kernel_ms=k1["ms"], plain_ms=k1["plain_ms"],
             bound_ms=k1["bound_ms"], bound_by=k1["bound_by"], library_ms=k1["library_ms"],
             shape="one decode tick: 25 launches at M=4"),
        dict(name="paged_attention", route="cuda",
             source="src/repro_torch/csrc/paged_attention.cu",
             replaces="src/repro/kernels/paged_attention.py:182",
             launches=launches["paged_attention"], max_abs_err=k2_err, max_err=k2_err,
             ms=k2["ms"], kernel_ms=k2["ms"], plain_ms=k2["plain_ms"],
             bound_ms=k2["bound_ms"], bound_by=k2["bound_by"], library_ms=k2["library_ms"],
             shape="one launch: S=4 H=KV=16 hd=128 bf16, 128-160 token contexts"),
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
