"""Continuous-batching serve loop over a paged KV cache.

Port of `repro.launch.scheduler`.  A fixed set of decode *slots* advances
one token per tick, and sequences are admitted into and retired out of
slots every step — a finished request frees its slot and KV pages at once
for the next queued request.

KV state is a paged pool per layer (fixed-size pages, per-sequence block
tables, host-side free-list allocator — `PageAllocator`), attended through
`kernels/paged_attention` (the CUDA kernel on the card, the bitwise
`_sdpa`-mirroring gather on the CPU).  Page 0 is reserved scratch: empty
slots carry an all-zero block table and harmlessly read/write it.

Robustness contract:

  admission     bounded queue; overflow and never-fits requests are SHED
                (`serve.shed` ledger events), never queued forever
  deadlines     per-request tick budgets; expired requests — queued or
                running — are evicted and their pages reclaimed
                (`serve.timeout`)
  preemption    page-allocator exhaustion evicts the lowest-priority
                (youngest among ties) running sequence and retries
                (`serve.preempt`); a victimless failure evicts the
                requester itself, so the loop always makes progress
  fault sites   `serve.admit` (fires -> that request is shed),
                `serve.step` (fires -> the tick is skipped, not the
                server), `kv.page_alloc` (fires -> the allocation is
                deferred/stalled one tick and retried)
  warmup        server start reads the cost model's coefficients once
                (so no plan built in a tick reads the calibration file),
                builds a guarded canary GEMM plan on the model's backend
                (building the CUDA kernels before any request), runs it
                through `dispatch` and directly, and runs the prefill and
                decode steps once
  drain         `drain()` / context-manager exit runs the loop until every
                admitted request has retired (graceful shutdown), then
                folds the obs bridge's buffered calibration records into
                the cost-model cache: the loop's one I/O point, and the one
                place where the device time of traced GEMMs is read

Observability (`repro_torch.obs`): the reference's counters and histograms
(requests by status, admissions, ticks by outcome, decode tokens, TTFT,
TPOT) and spans (`serve.tick`, nesting `serve.prefill` and
`serve.decode`).  With tracing off a span costs one attribute check.

Families: dense and moe serve through the paged path (the families ported).
The decode step runs at a fixed (max_slots,) shape; each tick writes its
new K/V rows into the pools in place (see `attention_paged_decode`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _obs
from repro_torch.resilience import faults, ledger

__all__ = [
    "ContinuousBatchingServer",
    "PageAllocator",
    "PagesExhausted",
    "Request",
    "RequestResult",
    "ServeConfig",
]

_SCHEDULABLE = ("dense", "moe")


class PagesExhausted(RuntimeError):
    """Free-list is smaller than the requested allocation."""


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Scheduler capacity + policy knobs (all counts, no wall-clock)."""

    max_slots: int = 4  # concurrent decode lanes (the batched step's S)
    page_size: int = 8  # tokens per KV page
    num_pages: int = 64  # pool size INCLUDING the reserved scratch page 0
    max_pages_per_seq: int = 8  # block-table width
    queue_capacity: int = 16  # bounded admission queue
    default_deadline: int = 512  # ticks from submission before eviction
    impl: Optional[str] = None  # paged-attention impl (None = capability door)
    warmup_prompt_lens: Tuple[int, ...] = ()  # prefill shapes to run at warmup

    def __post_init__(self):
        if self.max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {self.max_slots}")
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")
        if self.num_pages < 2:
            raise ValueError(
                f"num_pages must be >= 2 (page 0 is reserved scratch), got {self.num_pages}"
            )
        if self.max_pages_per_seq < 1 or self.queue_capacity < 1:
            raise ValueError(f"invalid capacities in {self}")


@dataclasses.dataclass(frozen=True)
class Request:
    rid: str
    prompt: np.ndarray  # (T,) int32 token ids
    max_new_tokens: int
    priority: int = 0  # higher survives preemption longer
    deadline: Optional[int] = None  # ticks from submission (None = config)
    arrival: int = 0  # tick at which `run()` submits this request


@dataclasses.dataclass
class RequestResult:
    rid: str
    status: str  # "ok" | "shed" | "timeout" | "preempted"
    tokens: List[int]  # generated tokens (possibly partial on eviction)
    reason: str = ""
    submitted_tick: int = -1
    finished_tick: int = -1
    latency_s: float = 0.0


class PageAllocator:
    """Host-side free-list over pool pages 1..num_pages-1 (0 = scratch).

    `alloc` is a fault site (`kv.page_alloc`): an injected failure surfaces
    exactly like transient exhaustion and the scheduler retries next tick.
    """

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError(f"need >= 2 pages (page 0 is scratch), got {num_pages}")
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, 0, -1))  # pop() -> 1 first

    @property
    def free_count(self) -> int:
        return len(self._free)

    def alloc(self, n: int, *, reason: str, rid: str = "") -> List[int]:
        faults.check("kv.page_alloc", reason=reason, rid=rid)
        if n > len(self._free):
            raise PagesExhausted(
                f"need {n} pages, {len(self._free)} free (rid={rid!r}, {reason})"
            )
        return [self._free.pop() for _ in range(n)]

    def free(self, pages: Sequence[int]) -> None:
        for p in pages:
            if not 0 < p < self.num_pages:
                raise ValueError(f"page {p} out of range (pool {self.num_pages})")
            if p in self._free:
                raise ValueError(f"double free of page {p}")
            self._free.append(p)


@dataclasses.dataclass(eq=False)
class _Seq:
    """One admitted sequence occupying a decode slot.

    Identity semantics (eq=False): membership checks against `_active` must
    mean "this exact sequence object is still live", never field equality.
    """

    req: Request
    slot: int
    pages: List[int]
    pos: int  # next write position == current length
    tokens: List[int]
    deadline_tick: int
    admit_tick: int
    submitted_tick: int
    submitted_at: float
    stalled: bool = False  # page-alloc fault this tick: skip, retry next


class ContinuousBatchingServer:
    """Admit/step/retire serving loop; see the module docstring.

    Typical use::

        server = ContinuousBatchingServer(model, params, ServeConfig(...))
        server.warmup()
        results = server.run(requests)      # or submit() + step() + drain()

    Runs on `device` (cuda unless the caller names another); the parameters
    must already live there.
    """

    def __init__(self, model, params, cfg: ServeConfig, *, device=None):
        fam = model.cfg.family
        if fam not in _SCHEDULABLE:
            raise NotImplementedError(
                f"family {fam!r} is not schedulable (supported: {_SCHEDULABLE})"
            )
        self.device = resolve_device(device)
        if params is not None and params["embed"].device.type != self.device.type:
            raise ValueError(
                f"parameters live on {params['embed'].device}, the server on {self.device}"
            )
        self.model = model
        self.params = params
        self.cfg = cfg
        self._tick = 0
        self._queue: List[Tuple[Request, int, float]] = []  # (req, tick, t_submit)
        self._active: List[_Seq] = []
        self._free_slots = list(range(cfg.max_slots - 1, -1, -1))
        self.results: Dict[str, RequestResult] = {}
        self.counters = {
            "served": 0, "shed": 0, "timeout": 0, "preempted": 0,
            "ticks": 0, "skipped_ticks": 0, "decode_tokens": 0,
            # device steps run, warmup included: kernel launches per step
            # times these counts are the launches a run must show
            "prefills": 0, "decode_steps": 0,
        }
        # Obs instruments: the typed, label-aware mirror of `self.counters`
        # — process-global (labels aggregate across server instances) where
        # the dict above stays per-instance.
        self._m_requests = _metrics.counter(
            "serve_requests_total", "request outcomes by status",
            labels=("status",),
        )
        self._m_admitted = _metrics.counter(
            "serve_admitted_total", "requests admitted into decode slots")
        self._m_ticks = _metrics.counter(
            "serve_ticks_total", "scheduler ticks by outcome",
            labels=("outcome",),
        )
        self._m_tokens = _metrics.counter(
            "serve_decode_tokens_total", "tokens produced by decode ticks")
        self._m_ttft = _metrics.histogram(
            "serve_ttft_seconds", "submission -> first token latency")
        self._m_tpot = _metrics.histogram(
            "serve_tpot_seconds", "per-tick decode wall time (time per token)")
        self.alloc = PageAllocator(cfg.num_pages)
        self.pools = {
            name: torch.zeros(shape, dtype=dtype, device=self.device)
            for name, (shape, dtype) in model.paged_pool_specs(
                cfg.num_pages, cfg.page_size
            ).items()
        }
        from repro_torch.launch.serve import serving_steps

        self._prefill, _ = serving_steps(model)

    # -- device steps ----------------------------------------------------------

    @torch.inference_mode()
    def _decode(self, tokens: np.ndarray, tables: np.ndarray, positions: np.ndarray):
        dev = self.device
        self.counters["decode_steps"] += 1
        logits, self.pools = self.model.paged_decode(
            self.params,
            torch.as_tensor(tokens, device=dev),
            self.pools,
            torch.as_tensor(tables, device=dev),
            torch.as_tensor(positions, device=dev),
            impl=self.cfg.impl,
        )
        return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)

    @torch.inference_mode()
    def _scatter(self, caches, pages: List[int]) -> None:
        """Write a prefill's (L, 1, T, KV, hd) caches into `pages` of the
        pools.  T is padded up to len(pages)*page_size; the zero tail is
        masked by `lengths` in attention and overwritten as decode goes on."""
        idx = torch.as_tensor(pages, dtype=torch.long, device=self.device)
        for name in ("k", "v"):
            pool, c = self.pools[name], caches[name]
            layers, _, t, kvh, hd = c.shape
            n, ps = len(pages), pool.shape[2]
            c2 = torch.nn.functional.pad(c[:, 0], (0, 0, 0, 0, 0, n * ps - t))
            pool[:, idx] = c2.reshape(layers, n, ps, kvh, hd).to(pool.dtype)

    # -- capacity arithmetic -------------------------------------------------

    def _prefill_len(self, req: Request) -> int:
        return int(req.prompt.shape[0])

    def _pages_for(self, length: int) -> int:
        return -(-length // self.cfg.page_size)  # ceil

    def _deadline_ticks(self, req: Request) -> int:
        # `is not None`, not truthiness: an explicit deadline=0 means "expire
        # immediately", not "use the default".
        return req.deadline if req.deadline is not None else self.cfg.default_deadline

    def _fits(self, req: Request) -> Optional[str]:
        """None if the request can ever be served, else the shed reason."""
        total = self._prefill_len(req) + req.max_new_tokens
        if self._pages_for(total) > self.cfg.max_pages_per_seq:
            return "too_long:block_table"
        if self._pages_for(total) > self.cfg.num_pages - 1:
            return "too_long:pool"
        return None

    # -- lifecycle events ----------------------------------------------------

    def _finish(self, rid: str, status: str, tokens: List[int], *,
                reason: str, submitted_tick: int, submitted_at: float) -> None:
        self.results[rid] = RequestResult(
            rid=rid,
            status=status,
            tokens=tokens,
            reason=reason,
            submitted_tick=submitted_tick,
            finished_tick=self._tick,
            latency_s=time.monotonic() - submitted_at,
        )
        key = {"ok": "served", "shed": "shed", "timeout": "timeout",
               "preempted": "preempted"}[status]
        self.counters[key] += 1
        self._m_requests.inc(status=key)

    def _shed(self, req: Request, reason: str, *, submitted_tick: int,
              submitted_at: float) -> None:
        ledger.record("serve.shed", cause=reason, fallback="shed", rid=req.rid)
        self._finish(req.rid, "shed", [], reason=reason,
                     submitted_tick=submitted_tick, submitted_at=submitted_at)

    def _evict(self, seq: _Seq, status: str, reason: str) -> None:
        if seq.pages:
            self.alloc.free(seq.pages)
            seq.pages = []  # retired sequences must never grow or double-free
        self._free_slots.append(seq.slot)
        self._active.remove(seq)
        self._finish(seq.req.rid, status, seq.tokens, reason=reason,
                     submitted_tick=seq.submitted_tick,
                     submitted_at=seq.submitted_at)

    # -- submission ----------------------------------------------------------

    def submit(self, req: Request) -> None:
        """Enqueue a request; over-capacity and never-fits are shed NOW."""
        now = time.monotonic()
        if req.rid in self.results or any(
            q.rid == req.rid for q, _, _ in self._queue
        ) or any(s.req.rid == req.rid for s in self._active):
            raise ValueError(f"duplicate request id {req.rid!r}")
        reason = self._fits(req)
        if reason is not None:
            self._shed(req, reason, submitted_tick=self._tick, submitted_at=now)
            return
        if len(self._queue) >= self.cfg.queue_capacity:
            self._shed(req, "queue_full", submitted_tick=self._tick, submitted_at=now)
            return
        self._queue.append((req, self._tick, now))

    # -- the tick ------------------------------------------------------------

    def step(self) -> None:
        """One scheduler tick: expire, admit, grow, decode, retire."""
        self._tick += 1
        self.counters["ticks"] += 1
        # The per-tick span nests everything the tick does (admission
        # prefills, the decode step) and costs one attribute check when
        # tracing is off; exports flush at drain/exit, never here.
        with _obs.span("serve.tick", tick=self._tick,
                       active=len(self._active), queued=len(self._queue)):
            try:
                faults.check("serve.step", tick=self._tick)
            except Exception as e:  # injected (any FaultSpec.error): skip the tick
                ledger.record(
                    "serve.step",
                    cause=f"{type(e).__name__}: {e}",
                    fallback="skip_tick",
                    tick=self._tick,
                )
                self.counters["skipped_ticks"] += 1
                self._m_ticks.inc(outcome="skipped")
                return
            self._m_ticks.inc(outcome="ok")
            self._expire_deadlines()
            self._admit()
            self._ensure_pages()
            self._decode_tick()

    def _expire_deadlines(self) -> None:
        for seq in list(self._active):
            if self._tick >= seq.deadline_tick:
                ledger.record(
                    "serve.timeout", cause="deadline", fallback="evict",
                    rid=seq.req.rid, tick=self._tick,
                )
                self._evict(seq, "timeout", "deadline")
        still = []
        for req, tick, t0 in self._queue:
            if self._tick >= tick + self._deadline_ticks(req):
                ledger.record(
                    "serve.timeout", cause="deadline_queued", fallback="evict",
                    rid=req.rid, tick=self._tick,
                )
                self._finish(req.rid, "timeout", [], reason="deadline_queued",
                             submitted_tick=tick, submitted_at=t0)
            else:
                still.append((req, tick, t0))
        self._queue = still

    def _admit(self) -> None:
        while self._queue and self._free_slots:
            req, submitted_tick, submitted_at = self._queue[0]
            try:
                faults.check("serve.admit", rid=req.rid)
            except Exception as e:  # injected (any FaultSpec.error): shed it
                self._queue.pop(0)
                self._shed(req, f"{type(e).__name__}: {e}",
                           submitted_tick=submitted_tick, submitted_at=submitted_at)
                continue

            prefill_len = self._prefill_len(req)
            # Optimistic admission: pages for the prompt plus the first decode
            # token; growth pages are claimed tick by tick (and contended
            # through preemption).
            try:
                pages = self.alloc.alloc(
                    self._pages_for(prefill_len + 1), reason="admit", rid=req.rid
                )
            except PagesExhausted:
                break  # wait for retirements; the deadline bounds the wait
            except Exception as e:  # injected: defer one tick
                ledger.record(
                    "kv.page_alloc",
                    cause=f"{type(e).__name__}: {e}",
                    fallback="defer_admission",
                    rid=req.rid,
                )
                break

            self._queue.pop(0)
            slot = self._free_slots.pop()
            with _obs.span("serve.prefill", rid=req.rid, tokens=prefill_len):
                first_tok, caches = self._run_prefill(req)
            self._m_admitted.inc()
            self._scatter(caches, pages)
            # TTFT: submission -> first token on the host (prefill emits it
            # greedily; reading it waits for the prefill).
            first = int(first_tok[0])
            self._m_ttft.observe(time.monotonic() - submitted_at)
            seq = _Seq(
                req=req,
                slot=slot,
                pages=pages,
                pos=prefill_len,
                tokens=[first],
                deadline_tick=submitted_tick + self._deadline_ticks(req),
                admit_tick=self._tick,
                submitted_tick=submitted_tick,
                submitted_at=submitted_at,
            )
            self._active.append(seq)
            if len(seq.tokens) >= req.max_new_tokens:
                self._evict(seq, "ok", "")

    def _run_prefill(self, req: Request):
        self.counters["prefills"] += 1
        prompts = torch.as_tensor(np.asarray(req.prompt, np.int32), device=self.device)[None, :]
        return self._prefill(self.params, {"tokens": prompts, "labels": prompts})

    def _ensure_pages(self) -> None:
        """Every active sequence needs page pos//page_size before decoding."""
        for seq in list(self._active):
            # An earlier sequence's _preempt_for may have evicted this one
            # (identity check: _Seq is eq=False); a retired sequence must not
            # claim fresh pages — they would leak — or preempt live peers.
            if seq not in self._active:
                continue
            seq.stalled = False
            needed = seq.pos // self.cfg.page_size + 1
            while len(seq.pages) < needed:
                try:
                    seq.pages += self.alloc.alloc(1, reason="grow", rid=seq.req.rid)
                except PagesExhausted:
                    if not self._preempt_for(seq):
                        # seq itself was the victim: stop growing IT, but the
                        # remaining active sequences still need their pages
                        # before this tick decodes (a missed growth here would
                        # silently write KV through scratch page 0).
                        break
                except faults.FaultError as e:
                    # Transient (injected) allocator failure: the sequence
                    # sits out this tick and retries, it is NOT evicted.
                    ledger.record(
                        "kv.page_alloc",
                        cause=f"{type(e).__name__}: {e}",
                        fallback="stall",
                        rid=seq.req.rid,
                    )
                    seq.stalled = True
                    break

    def _preempt_for(self, seq: _Seq) -> bool:
        """Evict the lowest-priority (youngest among ties) active sequence to
        free pages for `seq`.  Returns False iff `seq` itself was the victim
        (the caller must stop growing it)."""
        victim = min(self._active, key=lambda s: (s.req.priority, -s.admit_tick))
        ledger.record(
            "serve.preempt",
            cause="pages_exhausted",
            fallback="evict",
            rid=victim.req.rid,
            for_rid=seq.req.rid,
            tick=self._tick,
        )
        self._evict(victim, "preempted", f"pages_exhausted(for={seq.req.rid})")
        return victim is not seq

    def _decode_tick(self) -> None:
        ready = [s for s in self._active if not s.stalled]
        if not ready:
            return
        s_max = self.cfg.max_slots
        tokens = np.zeros((s_max, 1), np.int32)
        positions = np.zeros((s_max,), np.int32)
        tables = np.zeros((s_max, self.cfg.max_pages_per_seq), np.int32)
        for seq in ready:
            tokens[seq.slot, 0] = seq.tokens[-1]
            positions[seq.slot] = seq.pos
            tables[seq.slot, : len(seq.pages)] = seq.pages
        # The decode span covers the step AND the host read of its tokens,
        # so its duration is the per-tick decode wall time the tpot
        # histogram records.
        t0 = time.monotonic()
        with _obs.span("serve.decode", slots=len(ready), tick=self._tick):
            nxt = self._decode(tokens, tables, positions).cpu().numpy()  # host sync
        self._m_tpot.observe(time.monotonic() - t0)
        for seq in ready:
            seq.tokens.append(int(nxt[seq.slot]))
            seq.pos += 1
            self.counters["decode_tokens"] += 1
            self._m_tokens.inc()
            if len(seq.tokens) >= seq.req.max_new_tokens:
                self._evict(seq, "ok", "")

    # -- driving -------------------------------------------------------------

    @property
    def pending(self) -> int:
        return len(self._queue) + len(self._active)

    def warmup(self) -> None:
        """Build a guarded canary GEMM plan on the model's backend (on the
        card this builds and loads the CUDA kernels before any request), run
        it once through `dispatch(...).block()` and once directly, as the
        reference does, then run the prefill shapes of `warmup_prompt_lens`
        and one decode step whose all-zero tables touch only the scratch
        page.  The canary's guard (`zero_and_record`) takes an armed
        `kernel.output` fault, scrubbing the poison and recording a
        `guard.nonfinite` event, before any request runs.  First it reads
        the cost model's coefficients for the server's device (one
        calibration-file read, memoized), so no plan built inside a tick
        touches the filesystem."""
        from repro_torch.kernels import api

        try:
            from repro_torch.costmodel import current_coefficients

            current_coefficients(self.device.type)
        except Exception:
            pass  # the planner degrades to the shipped coefficients on its own

        backend = "cuda_mesh" if self.model.cfg.use_mesh_kernel else "torch"
        a = torch.ones((8, 8), dtype=torch.float32, device=self.device)
        canary = api.plan(
            api.GemmSpec.from_operands(a, a, blocks=(8, 8, 8)),
            backend=backend,
            device=self.device,
            guard_nonfinite="zero_and_record",
        )
        canary.dispatch(a, a).block()
        canary(a, a).cpu()
        for t in self.cfg.warmup_prompt_lens:
            self._run_prefill(
                Request(rid=f"__warmup_{t}", prompt=np.zeros(t, np.int32), max_new_tokens=1)
            )
        s_max = self.cfg.max_slots
        self._decode(
            np.zeros((s_max, 1), np.int32),
            np.zeros((s_max, self.cfg.max_pages_per_seq), np.int32),
            np.zeros((s_max,), np.int32),
        ).cpu()

    def drain(self, *, max_ticks: int = 1_000_000) -> None:
        """Run until every admitted request has retired (graceful shutdown).
        Liveness is deadline-bounded: even permanently stalled sequences are
        evicted when their tick budget runs out."""
        ticks = 0
        while self.pending:
            self.step()
            ticks += 1
            if ticks > max_ticks:
                raise RuntimeError(f"drain exceeded {max_ticks} ticks")
        # Drain is the scheduler's I/O point: ticks never touch the
        # filesystem or wait for traced GEMMs' events, so buffered
        # span->calibration records are folded into the cost-model cache
        # here, after the loop empties.
        from repro_torch.obs import bridge as _bridge

        if _bridge.installed():
            _bridge.flush_calibration()

    def run(self, requests: Sequence[Request]) -> Dict[str, RequestResult]:
        """Submit `requests` at their arrival ticks, drive to completion."""
        todo = sorted(requests, key=lambda r: r.arrival)
        i = 0
        while i < len(todo) or self.pending:
            while i < len(todo) and todo[i].arrival <= self._tick:
                self.submit(todo[i])
                i += 1
            self.step()
        return dict(self.results)

    def __enter__(self) -> "ContinuousBatchingServer":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.drain()
