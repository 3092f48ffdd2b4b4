"""Batched serving driver: prefill + greedy decode with a KV cache.

Port of `repro.launch.serve`.  Runs on the card unless `--device cpu` is
given; with no CUDA device and no explicit device it refuses to run.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mesh-paper \
      --batch 4 --prompt-len 128 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mesh-paper \
      --scheduler --requests 8 --prompt-len 128 --gen 32

Every projection GEMM routes through the plan/execute API
(`repro_torch.kernels.api`): the first request plans each logical GEMM
shape once, and the process-wide plan cache serves every later one —
`--plan-stats` prints the cache.  `--requests N` serves N independent
prompt batches through `serve_requests`, which isolates each request: one
that raises is reported, recorded in the resilience ledger and skipped.
`--scheduler` serves each request as one single-prompt request of the
continuous-batching scheduler (`launch/scheduler.py`) instead.

`--mesh DxM` serves tensor-parallel under a ('data', 'model') mesh of D x M
ranks, one process each, started by torchrun (or any rendezvous
`launch.mesh.init_distributed` reads):

  torchrun --nproc-per-node 2 -m repro_torch.launch.serve --arch mesh-paper \
      --reduced --device cpu --mesh 1x2

Every rank draws the same parameters from the seed and keeps its block
(`interop.shard_params`), gets the same prompts and the same tokens back;
the batch rows split over 'data' where they divide (with `--scheduler`,
the server's decode slots).  Every family runs under it, RWKV-6 and
Zamba2 too; Whisper (audio) is served by `generate` and `serve_requests`
with its frames batch, and the CLI refuses it as the reference's does.
Rank 0 prints.  On one card the ranks share it over gloo (NCCL takes one
rank a card).

`--obs-export PATH` turns tracing on before any model work, installs the
obs bridge (ledger events -> `repro_degradations_total`, `plan.execute`
spans -> cost-model calibration records, on the card with the device time
of CUDA events around each GEMM), and at exit writes a Chrome-trace
timeline to PATH, Prometheus metrics to PATH.prom and the raw spans to
PATH.jsonl.  `--plan-stats` prints, beside each plan, its predicted
milliseconds under the current coefficients, the calibration file's
measured milliseconds for the same shape and backend, the traced
executions' p50/p99 (device time on the card, host time on the CPU) and
the cost model's backend decision.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.kernels import api as kernel_api
from repro_torch.models import get_model
from repro_torch.models.layers import NO_SHARD, ShardCtx
from repro_torch.obs import trace as _obs
from repro_torch.resilience import faults as _faults
from repro_torch.resilience import ledger as _rledger
from repro_torch.train.train_step import make_prefill_step, make_serve_step

__all__ = [
    "generate",
    "main",
    "report_plan_cache",
    "serve_requests",
    "serving_steps",
]


def serving_steps(model, ctx: ShardCtx = NO_SHARD):
    """The (prefill_step, serve_step) pair for a model under `ctx`.  PyTorch
    runs eagerly, so there is no trace to cache: the steps are plain
    functions, shared by `generate` and the continuous-batching
    scheduler."""
    return make_prefill_step(model, ctx), make_serve_step(model, ctx)


def report_plan_cache(prefix: str = "[serve]") -> dict:
    """Print + return the GEMM plan-cache telemetry for this process: each
    (spec, backend, device type) is planned at most once, and hits count
    executions that reused an existing plan.

    Cost-model provenance rides along: every entry prints its predicted
    milliseconds under the current coefficients of its device — plus the
    measured milliseconds when the calibration file holds a record for the
    same shape/backend, and the p50/p99 of its traced executions — and
    entries whose backend the cost model chose print the decision (chosen
    candidate, how many were ranked, calibration source).  Sharded plans
    (a ShardSpec) print their collective schedule, mesh, bytes moved and
    the roofline's collective time (`shard=<schedule>@<mesh> moved=<bytes>B
    t_coll=<us>`, ` ov` for an overlapped schedule), others `shard=-`.
    """
    from repro_torch.costmodel import current_coefficients, predict, terms_from_describe
    from repro_torch.costmodel.calibrate import default_cache
    from repro_torch.launch.roofline import analyze_plan

    info = kernel_api.plan_cache_info()
    print(
        f"{prefix} GEMM plan cache: {info['size']} plans, "
        f"{info['hits']} hits, {info['misses']} misses"
    )
    # Traced execute latencies keyed as the calibration cache keys them
    # ("MxKxN|backend"): device time where the span carries CUDA events.
    obs_ms: dict = {}
    for sp in _obs.spans("plan.execute"):
        k = sp.attrs.get("key")
        if k:
            dev = sp.device_ms()
            obs_ms.setdefault(k, []).append(sp.duration_s * 1e3 if dev is None else dev)
    for p in info["plans"]:
        blocks = "x".join(map(str, p["blocks"])) if p["blocks"] else "-"
        epi = p["epilogue"]
        epi_s = (
            ("+b" if epi["bias"] else "")
            + (f"+{epi['activation']}" if epi["activation"] else "")
            + ("+r" if epi["residual"] else "")
        ) or "-"
        grp = p["grouped"]
        grp_s = f" grouped {grp['num_groups']}x{grp['rows_per_group']} rows" if grp else ""
        sh = p.get("sharding")
        shard_s = "-"
        if sh:
            mesh_s = "x".join(str(size) for _, size in sh["mesh"])
            shard_s = (f"{sh['schedule']}@{mesh_s} moved={sh['bytes_moved']}B"
                       f" t_coll={analyze_plan(p)['t_collective_s'] * 1e6:.2f}us")
            if sh.get("overlap"):
                eff = sh.get("overlap_efficiency")
                shard_s += " ov" + (f"={eff:.2f}x" if eff else "")
        coeffs = current_coefficients(p["device"])
        try:
            measured_ms = {rec.get("key"): rec["ms"]
                           for rec in default_cache().records(coeffs.platform)}
        except Exception:  # a broken calibration file must not break the report
            measured_ms = {}
        key = f"{p['mkn']}|{p['backend']}"
        cost_s = f"pred={predict(terms_from_describe(p), coeffs)['total_s'] * 1e3:.3f}ms"
        if key in measured_ms:
            cost_s += f" meas={measured_ms[key]:.3f}ms"
        durs = sorted(obs_ms.get(key, ()))
        if durs:
            p50 = durs[len(durs) // 2]
            p99 = durs[min(len(durs) - 1, int(len(durs) * 0.99))]
            cost_s += f" obs[n={len(durs)}]=p50:{p50:.3f}/p99:{p99:.3f}ms"
        d = (p.get("decision") or {}).get("backend")
        dec_s = (f"backend:{d['chosen']}/{len(d['candidates'])}cand"
                 f" [{d['calibration']['source']}]" if d else "-")
        print(
            f"{prefix}   {p['backend']:9s} {p['device']:4s} {p['structure']:9s} "
            f"{p['mkn']:>18s} batch={p['batch'] or '-'} blocks={blocks} "
            f"epi={epi_s:12s} flops={p['flops']:.2e}{grp_s} shard={shard_s} {cost_s}"
            f" decision={dec_s}"
        )
    return info


# The decode state's per-position KV caches, by family: decode writes at
# position pos, so `generate` grows them to prompt+gen capacity on their
# length axis (2).  Recurrent state (RWKV's wkv and shifts, Zamba's h and
# conv) and Whisper's enc_out are left as they are.
_GROWN_CACHES = {"dense": None, "moe": None, "vlm": None,  # None: every entry
                 "hybrid": ("kv_k", "kv_v"), "audio": ("k", "v"), "ssm": ()}


def generate(model, params, prompts: torch.Tensor, *, gen_len: int,
             ctx: ShardCtx = NO_SHARD, frames: Optional[torch.Tensor] = None):
    """Prefill the prompts then decode `gen_len` tokens greedily against a
    dense KV cache (attention is the plain `_sdpa`).  vlm prompts get zero
    stub patches and decode from t_prompt + num_stub_patches; audio prompts
    need their encoder input, `frames` (B, T_enc, D).

    prompts: (B, T_prompt) int32 on the parameters' device, the same on
    every rank under a mesh (`ctx`), where `params` is this rank's block.
    Returns (tokens (B, gen_len) int32, decode steps per second).
    """
    cfg = model.cfg
    b, t_prompt = prompts.shape
    prefill, serve = serving_steps(model, ctx)
    batch = {"tokens": prompts, "labels": prompts}
    if cfg.family == "audio":
        if frames is None:
            raise ValueError("audio (whisper) prompts need their frames batch (frames=)")
        batch["frames"] = frames
    if cfg.family == "vlm":
        batch["patches"] = torch.zeros((b, cfg.num_stub_patches, cfg.d_model),
                                       dtype=cfg.adtype, device=prompts.device)
    next_tok, state = prefill(params, batch)
    grown = _GROWN_CACHES[cfg.family]
    state = {
        name: (torch.nn.functional.pad(c, (0, 0, 0, 0, 0, gen_len))
               if grown is None or name in grown else c)
        for name, c in state.items()
    }
    pos = t_prompt + (cfg.num_stub_patches if cfg.family == "vlm" else 0)
    toks = [next_tok]
    t0 = time.monotonic()
    for i in range(gen_len - 1):
        next_tok, state = serve(params, toks[-1][:, None], state, pos + i)
        toks.append(next_tok)
    out = torch.stack(toks, dim=1)
    out.cpu()  # waits for the device
    dt = time.monotonic() - t0
    # Degenerate timings (gen_len == 1, a clock that did not advance) report
    # 0.0, never inf.
    steps_per_s = (gen_len - 1) / dt if dt > 0 and gen_len > 1 else 0.0
    return out, steps_per_s


def serve_requests(model, params, request_prompts, *, gen_len: int, prefix: str = "[serve]",
                   ctx: ShardCtx = NO_SHARD, request_frames=None):
    """Serve independent prompt batches via `generate`, isolating failures:
    a request that raises is reported, recorded in the ledger under
    `serve.request`, and skipped.  `request_frames`, parallel to
    `request_prompts`, holds audio requests' frames.  Returns a list
    parallel to `request_prompts`: (tokens, steps_per_s), or None for
    skipped ones."""
    results = []
    for i, prompts in enumerate(request_prompts):
        frames = None if request_frames is None else request_frames[i]
        try:
            with _obs.span("serve.request", request=i, batch=int(prompts.shape[0]),
                           gen=gen_len):
                _faults.check("serve.request", request=i)
                results.append(generate(model, params, prompts, gen_len=gen_len, ctx=ctx,
                                        frames=frames))
        except Exception as e:  # a request boundary: report, record, go on
            _rledger.record(
                "serve.request", cause=f"{type(e).__name__}: {e}", fallback="skip", request=i
            )
            print(f"{prefix} request {i} FAILED ({type(e).__name__}: {e}) — skipped")
            results.append(None)
    served = sum(r is not None for r in results)
    if served < len(results):
        print(f"{prefix} served {served}/{len(results)} requests")
    return results


def _silent(*_) -> None:
    """`print` on the ranks that do not print."""


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--device",
        default=None,
        help="cuda (the default; refuses to run without a CUDA device) or cpu",
    )
    ap.add_argument(
        "--requests",
        type=int,
        default=1,
        help="serve N independent prompt batches; a failing request is "
        "reported and skipped, not fatal",
    )
    ap.add_argument(
        "--scheduler",
        action="store_true",
        help="serve through the continuous-batching scheduler (paged KV "
        "cache, admission control, deadlines); each request becomes one "
        "single-prompt scheduler request",
    )
    ap.add_argument(
        "--plan-stats",
        action="store_true",
        help="print the GEMM plan cache after serving (one plan per spec)",
    )
    ap.add_argument(
        "--obs-export",
        default=None,
        metavar="PATH",
        help="enable structured tracing for the run and write a Chrome-trace "
        "timeline to PATH at exit (plus PATH.prom Prometheus metrics and "
        "PATH.jsonl raw spans); also bridges ledger events into metrics and "
        "feeds plan.execute spans to the cost-model calibration cache",
    )
    ap.add_argument(
        "--mesh",
        default=None,
        metavar="DxM",
        help="serve tensor-parallel under a ('data', 'model') mesh of D x M ranks,"
        " one process each (torchrun or a rendezvous; ranks past D x M take no"
        " part); rank 0 prints",
    )
    args = ap.parse_args(argv)

    if args.obs_export:
        # Tracing + both bridge feeds go live BEFORE any model work so the
        # timeline covers warmup, planning, and every request.  Exports are
        # written once, at the end of main — the serving path stays I/O-free.
        from repro_torch.obs import bridge as _bridge

        _obs.enable()
        _bridge.install()

    device = resolve_device(args.device)
    ctx, lead = NO_SHARD, True
    if args.mesh:
        from repro_torch.launch.mesh import init_distributed, make_local_mesh

        shape = tuple(int(x) for x in args.mesh.lower().split("x"))
        _, rank = init_distributed(device)
        ctx = ShardCtx(make_local_mesh(shape, ("data", "model")))
        if rank >= shape[0] * shape[1]:
            return  # this rank is not in the mesh
        lead = rank == 0
    out = print if lead else _silent
    if args.mesh:
        out(f"[serve] mesh: data={shape[0]} model={shape[1]}")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.family == "audio":
        raise SystemExit("audio (whisper) serving is exercised in tests with a frames batch")
    model = get_model(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model.init(gen, device)
    if ctx.active:
        from repro_torch.interop import shard_params

        params = shard_params(params, model, ctx)
    request_prompts = []
    for r in range(max(args.requests, 1)):
        g = torch.Generator(device=device).manual_seed(args.seed + 1 + r)
        request_prompts.append(
            torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len), generator=g,
                          device=device, dtype=torch.int32)
        )

    _faults.install_env_plan()
    if args.scheduler:
        from repro_torch.launch.scheduler import ContinuousBatchingServer, Request, ServeConfig

        total_len = args.prompt_len + args.gen
        if cfg.family == "vlm":
            total_len += cfg.num_stub_patches
        pages_per_seq = -(-total_len // 8)  # ceil
        scfg = ServeConfig(
            max_slots=args.batch,
            page_size=8,
            num_pages=1 + args.batch * pages_per_seq,
            max_pages_per_seq=pages_per_seq,
            queue_capacity=max(args.requests, 1),
            warmup_prompt_lens=(args.prompt_len,),
        )
        server = ContinuousBatchingServer(model, params, scfg, ctx, device=device)
        server.warmup()
        reqs = [
            Request(rid=f"req{r}", prompt=p[0].cpu().numpy(), max_new_tokens=args.gen)
            for r, p in enumerate(request_prompts)
        ]
        t0 = time.monotonic()
        results_by_rid = server.run(reqs)
        dt = time.monotonic() - t0
        out(
            f"[serve] {args.arch} scheduler slots={scfg.max_slots} "
            f"pages={scfg.num_pages}x{scfg.page_size} prompt={args.prompt_len} "
            f"gen={args.gen} ticks={server.counters['ticks']} device={device}"
        )
        for r in reqs:
            res = results_by_rid[r.rid]
            out(
                f"[serve] {res.rid}: {res.status:9s} {len(res.tokens)} tokens "
                f"lat={res.latency_s * 1e3:.1f}ms {res.tokens[:16]}"
            )
        rate = server.counters["decode_tokens"] / dt if dt > 0 else 0.0
        out(f"[serve] {server.counters}, {rate:.1f} tok/s")
    else:
        results = serve_requests(model, params, request_prompts, gen_len=args.gen, ctx=ctx)
        out(
            f"[serve] {args.arch} batch={args.batch} prompt={args.prompt_len} "
            f"gen={args.gen} device={device}"
        )
        for r, res in enumerate(results):
            if res is None:
                continue
            toks, rate = res
            out(
                f"[serve] req {r}: decode steps/s {rate:.2f} "
                f"({rate * args.batch:.1f} tok/s batched), row 0: {toks[0].tolist()[:16]}"
            )
    if args.plan_stats and lead:
        report_plan_cache()
        if _obs.is_enabled():
            st = _obs.stats()
            out(
                f"[serve] obs: {st['finished']} spans "
                f"({st['retained']} retained, {st['dropped']} dropped, "
                f"{st['suppressed_in_trace']} suppressed-in-trace)"
            )
    if _rledger.count():
        out(_rledger.format_summary("[serve]"))

    if args.obs_export and lead:
        from repro_torch.obs import bridge as _bridge
        from repro_torch.obs import export as _export

        ingested = _bridge.flush_calibration()
        _export.write_chrome_trace(
            args.obs_export,
            metadata={
                "arch": args.arch,
                "requests": max(args.requests, 1),
                "scheduler": bool(args.scheduler),
                "device": str(device),
                "calibration": _bridge.calibration_stamp(),
            },
        )
        _export.write_prometheus(args.obs_export + ".prom")
        _export.write_spans_jsonl(args.obs_export + ".jsonl")
        out(
            f"[serve] obs export: {args.obs_export} (+.prom, +.jsonl), "
            f"{ingested} calibration records ingested"
        )


if __name__ == "__main__":
    main()
