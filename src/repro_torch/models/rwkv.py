"""RWKV-6 "Finch" (arXiv:2404.05892): attention-free LM with data-dependent
decay (port of `repro.models.rwkv`).

Per layer: time-mix (the WKV linear recurrence with per-channel
data-dependent decay w_t, bonus u and data-dependent token-shift
interpolation through a shared LoRA) and channel-mix.  The WKV state is
(H, K, V) per sequence, O(1) in sequence length.

The recurrence S_t = diag(w_t) S_{t-1} + k_t^T v_t runs per token
(`_wkv_scan`, the faithful form, which decode takes) or chunk-parallel
(`_wkv_chunked`, with cfg.wkv_chunked when the length is a multiple of
cfg.wkv_chunk: `tuned()` turns it on).  Both are plain torch ops: the
reference writes them in XLA, not Pallas.  As in the reference, each chunk
of the chunked form, and each 128-step chunk of the scan when T is a larger
multiple of 128, runs under a checkpoint where autograd records
(`torch.utils.checkpoint`, the reference's `jax.checkpoint`): the backward
keeps one (B, H, K, V) state a chunk and recomputes the chunk's
intermediates, with the same values and gradients bit for bit.  At 2 x
2048 tokens the chunked form's (B, C, C, H, K) intermediates would
otherwise hold about 1.7 GiB a layer of RWKV-6, and the scan one state a
step.  `chunk_checkpoint(False)` turns it off (a memory reading).  Every
projection goes through `layers.gemm` (kernel
K1 under cfg.use_mesh_kernel, with the silu, relu and sigmoid epilogues
fused); the LoRA einsums stay `torch.einsum` in the activation type, as in
the reference.

Entry points mirror the transformer's: `rwkv_specs` / `rwkv_forward` /
`rwkv_prefill` / `rwkv_decode`, with stacked per-layer states {"wkv",
"tm_shift", "cm_shift"}; the shift carries hold the *normalised* last token
(time-mix and channel-mix receive rmsnorm(x)).

Tensor parallelism (a `ShardCtx` with a live mesh), SPMD by hand as in
`transformer`: wr, wk, wv and wg are column-parallel in whole WKV heads
(`interop.shard_params`), so each process runs the recurrence, its state
and the per-head group norm on its own heads; the per-channel parameters
of those heads (the decay LoRA's ww2 columns, w0, u, gn_g, gn_b) are
sliced from their replicated copies, and each output column is computed
as without a mesh (in training those leaves are replicated, so each
rank's gradient of them is a share: `interop.ModelBlocks`).  wo is row-parallel (f32 partial sums, one all-reduce:
`layers.dense_rows`).  The channel-mix's cm_wk is column-parallel over
'mlp' and cm_wv row-parallel; cm_wr (embed x embed) stays replicated.  The
embedding and the head are vocab-parallel (`transformer.embed_tokens`,
`unembed`).  The shift carries stay whole; the wkv state holds this
process's heads (`rwkv_state_specs(cfg, batch, ctx)`).
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import (
    NO_SHARD,
    PSpec,
    ShardCtx,
    dense_rows,
    gemm,
    padded_vocab,
    rmsnorm,
)
from repro_torch.models.transformer import (
    _layers,
    seq_whole,
    layer_entry,
    top_weights,
    embed_tokens,
    stack_specs,
    unembed,
)

__all__ = [
    "chunk_checkpoint", "rwkv_specs", "rwkv_forward", "rwkv_prefill", "rwkv_decode",
    "rwkv_state_specs",
]

_LORA = 32  # ddlerp LoRA rank
_DECAY_LORA = 64
_WKV_CHUNK = 128  # the scan's checkpointed chunk, in steps
_CHECKPOINT = [True]


@contextlib.contextmanager
def chunk_checkpoint(enabled: bool):
    """Scoped switch of the WKV chunk checkpoint (on by default)."""
    prev = _CHECKPOINT[0]
    _CHECKPOINT[0] = bool(enabled)
    try:
        yield
    finally:
        _CHECKPOINT[0] = prev


def _chunked(fn, *args):
    """fn(*args), under a checkpoint where autograd records and the switch
    is on: the backward then keeps `args` and recomputes fn's
    intermediates."""
    if _CHECKPOINT[0] and torch.is_grad_enabled() and any(a.requires_grad for a in args):
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def _layer_specs(cfg) -> Dict[str, Any]:
    d, f = cfg.d_model, cfg.d_ff
    out_scale = 0.02 / max(1.0, (2 * cfg.num_layers) ** 0.5)
    return {
        "ln1": PSpec((d,), ("embed",), init="ones"),
        "ln2": PSpec((d,), ("embed",), init="ones"),
        # time-mix
        "mu_x": PSpec((d,), ("embed",), 0.5),
        "mu_rkvwg": PSpec((5, d), (None, "embed"), 0.5),
        "tm_w1": PSpec((d, 5 * _LORA), ("embed", None), 0.02),
        "tm_w2": PSpec((5, _LORA, d), (None, None, "embed"), 0.02),
        "w0": PSpec((d,), ("embed",), 0.5),
        "ww1": PSpec((d, _DECAY_LORA), ("embed", None), 0.02),
        "ww2": PSpec((_DECAY_LORA, d), (None, "embed"), 0.02),
        "u": PSpec((d,), ("embed",), 0.5),
        "wr": PSpec((d, d), ("embed", "heads"), 0.02),
        "wk": PSpec((d, d), ("embed", "heads"), 0.02),
        "wv": PSpec((d, d), ("embed", "heads"), 0.02),
        "wg": PSpec((d, d), ("embed", "heads"), 0.02),
        "wo": PSpec((d, d), ("heads", "embed"), out_scale),
        "gn_g": PSpec((d,), ("embed",), init="ones"),
        "gn_b": PSpec((d,), ("embed",), init="zeros"),
        # channel-mix
        "cm_mu_k": PSpec((d,), ("embed",), 0.5),
        "cm_mu_r": PSpec((d,), ("embed",), 0.5),
        "cm_wk": PSpec((d, f), ("embed", "mlp"), 0.02),
        "cm_wv": PSpec((f, d), ("mlp", "embed"), out_scale),
        "cm_wr": PSpec((d, d), ("embed", "embed"), 0.02),
    }


def rwkv_specs(cfg) -> Dict[str, Any]:
    return {
        "embed": PSpec((padded_vocab(cfg), cfg.d_model), ("vocab", "embed"), 0.02),
        "blocks": stack_specs(_layer_specs(cfg), cfg.num_layers),
        "final_norm": PSpec((cfg.d_model,), ("embed",), init="ones"),
        "lm_head": PSpec((cfg.d_model, padded_vocab(cfg)), ("embed", "vocab"), 0.02),
    }


def rwkv_state_specs(cfg, batch: int, ctx: ShardCtx = NO_SHARD):
    """Stacked per-layer recurrent state, as {name: (shape, dtype)}; under
    a mesh `wkv` holds this process's heads."""
    h, k = ctx.part("heads", cfg.num_heads).size, cfg.head_dim_
    L, d = cfg.num_layers, cfg.d_model
    return {
        "wkv": ((L, batch, h, k, k), torch.float32),
        "tm_shift": ((L, batch, d), cfg.adtype),
        "cm_shift": ((L, batch, d), cfg.adtype),
    }


def _zero_state(cfg, batch: int, device, ctx: ShardCtx = NO_SHARD):
    return {name: torch.zeros(shape, dtype=dt, device=device)
            for name, (shape, dt) in rwkv_state_specs(cfg, batch, ctx).items()}


def _ddlerp(p, x, x_prev):
    """Data-dependent token-shift interpolation for (r, k, v, w, g)."""
    base = x + (x_prev - x) * p["mu_x"].to(x.dtype)
    lora = torch.einsum("btd,dr->btr", base, p["tm_w1"].to(x.dtype))
    lora = lora.reshape(*x.shape[:-1], 5, _LORA)
    adj = torch.einsum("btir,ird->btid", torch.tanh(lora), p["tm_w2"].to(x.dtype))
    mus = p["mu_rkvwg"].to(x.dtype) + adj  # (B, T, 5, D)
    return [x + (x_prev - x) * mus[..., i, :] for i in range(5)]


def _wkv_chunked(r, k, v, w, u, s0, chunk: int = 16):
    """Chunk-parallel (GEMM-form) WKV, exact; the reference's derivation:

      S_t = diag(w_t) S_{t-1} + k_t v_t^T;   o_t = r_t (S_{t-1} + u k_t v_t^T)
      With cumulative log-decay cw_t = sum_{i<=t} log w_i inside a chunk:
        o_t = (r_t . e^{cw_{t-1}}) S_in                       [inter-chunk]
            + sum_{j<t} [ sum_c r_tc k_jc e^{cw_{t-1,c}-cw_{j,c}} ] v_j
            + (sum_c r_tc u_c k_tc) v_t                        [bonus diag]
        S_out = diag(e^{cw_C}) S_in + sum_j (e^{cw_C - cw_j} . k_j) v_j^T

    Every exponent is a difference of a decreasing sequence at j <= t-1 (or
    masked to -1e30 first), hence <= 0: no overflow for any decay.
    r/k/v/w: (B, T, H, K) f32; u: (H, K); s0: (B, H, K, V).  T must divide
    by `chunk`.
    """
    b, t, h, kdim = r.shape
    vdim = s0.shape[-1]
    c = chunk
    nc = t // c
    if nc * c != t:
        raise ValueError(f"T={t} not divisible by wkv chunk={c}")

    def resh(a):
        return a.reshape(b, nc, c, h, kdim).movedim(1, 0)  # (nc, B, C, H, K)

    rc, kc, vc = resh(r), resh(k), resh(v)
    lw = torch.log(torch.clamp_min(resh(w), 1e-38))  # <= 0
    cw = torch.cumsum(lw, dim=2)  # inclusive cumulative log decay
    cw_prev = cw - lw  # exclusive (cw_{t-1}; row 0 = 0)
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device), diagonal=-1)

    def body(s, rj, kj, vj, cwj, cwp):  # (B, C, H, K) each
        # intra-chunk attention matrix A[t, j] (strictly causal, decayed)
        diff = cwp[:, :, None] - cwj[:, None, :]  # (B, C, C, H, K): t, j
        diff = torch.where(tri[None, :, :, None, None], diff, -1e30)
        a_mat = torch.einsum("bthk,bjhk,btjhk->bthj", rj, kj, torch.exp(diff))
        dg = torch.einsum("bthk,hk,bthk->bth", rj, u, kj)  # bonus diagonal
        o = torch.einsum("bthj,bjhv->bthv", a_mat, vj) + dg[..., None] * vj
        o = o + torch.einsum("bthk,bhkv->bthv", rj * torch.exp(cwp), s)
        # chunk-final state
        wj = torch.exp(cwj[:, -1:, :, :] - cwj)  # e^{cw_C - cw_j} <= 1
        s = s * torch.exp(cwj[:, -1])[..., None] + torch.einsum("bjhk,bjhv->bhkv", kj * wj, vj)
        return s, o

    s, outs = s0, []
    for i in range(nc):
        s, o = _chunked(body, s, rc[i], kc[i], vc[i], cw[i], cw_prev[i])
        outs.append(o)
    o = torch.stack(outs, dim=1).reshape(b, t, h, vdim)
    return o, s


def _wkv_scan(r, k, v, w, u, s0):
    """S_t = diag(w_t) S_{t-1} + k_t v_t^T;  o_t = r_t (S_{t-1} + u k_t v_t^T).

    r/k/v/w: (B, T, H, K) f32; u: (H, K); s0: (B, H, K, V).
    Returns (o (B, T, H, V), s_final).

    As in the reference, the time loop runs in chunks of _WKV_CHUNK steps,
    each under a checkpoint (`_chunked`), when T is a multiple of the chunk
    and longer than one; otherwise it is one flat loop.
    """

    def steps(s, rc, kc, vc, wc):  # (B, C, H, K) each
        outs = []
        for i in range(rc.shape[1]):
            rt, kt, vt, wt = rc[:, i], kc[:, i], vc[:, i], wc[:, i]  # (B, H, K) each
            kv = kt[..., None] * vt[..., None, :]  # (B, H, K, V)
            s_eff = s + u[None, :, :, None] * kv
            outs.append(torch.einsum("bhk,bhkv->bhv", rt, s_eff))
            s = wt[..., None] * s + kv
        return s, torch.stack(outs, dim=1)

    t = r.shape[1]
    if t % _WKV_CHUNK or t <= _WKV_CHUNK:
        s, o = steps(s0, r, k, v, w)
        return o, s
    s, outs = s0, []
    for c0 in range(0, t, _WKV_CHUNK):
        c1 = c0 + _WKV_CHUNK
        s, o = _chunked(steps, s, r[:, c0:c1], k[:, c0:c1], v[:, c0:c1], w[:, c0:c1])
        outs.append(o)
    return torch.cat(outs, dim=1), s


def _heads(t: torch.Tensor, hp, hd: int) -> torch.Tensor:
    """The columns of this process's heads (`hp`) of a per-channel (..., D)
    parameter."""
    return t if hp.count == 1 else t.narrow(-1, hp.start * hd, hp.size * hd)


def _time_mix(p, x, cfg, ctx, state_wkv, x_last):
    """x: (B, T, D); x_last: (B, D) previous-token carry.  Returns (y, wkv', last')."""
    b, t, d = x.shape
    hd = cfg.head_dim_
    hp = ctx.part("heads", cfg.num_heads)
    h = hp.size  # this process's heads
    x_prev = torch.cat([x_last[:, None, :], x[:, :-1, :]], dim=1)
    xr, xk, xv, xw, xg = _ddlerp(p, x, x_prev)

    f32 = torch.float32
    r = gemm(xr, p["wr"].to(x.dtype), cfg).reshape(b, t, h, hd).to(f32)
    k = gemm(xk, p["wk"].to(x.dtype), cfg).reshape(b, t, h, hd).to(f32)
    v = gemm(xv, p["wv"].to(x.dtype), cfg).reshape(b, t, h, hd).to(f32)
    g = gemm(xg, p["wg"].to(x.dtype), cfg, activation="silu")

    # data-dependent decay w_t in (0, 1): exp(-exp(w0 + lora(xw)))
    dec = _heads(p["w0"], hp, hd).to(f32) + torch.einsum(
        "btr,rd->btd",
        torch.tanh(torch.einsum("btd,dr->btr", xw.to(f32), p["ww1"].to(f32))),
        _heads(p["ww2"], hp, hd).to(f32),
    )
    w = torch.exp(-torch.exp(dec)).reshape(b, t, h, hd)
    u = _heads(p["u"], hp, hd).to(f32).reshape(h, hd)

    if cfg.wkv_chunked and t > 1 and t % cfg.wkv_chunk == 0:
        o, s_final = _wkv_chunked(r, k, v, w, u, state_wkv, chunk=cfg.wkv_chunk)
    else:
        o, s_final = _wkv_scan(r, k, v, w, u, state_wkv)
    o = o.reshape(b, t, h * hd).to(x.dtype)
    # per-head group norm (jnp.var is the biased variance)
    og = o.reshape(b, t, h, hd).to(f32)
    mean = og.mean(-1, keepdim=True)
    var = og.var(-1, keepdim=True, unbiased=False)
    og = ((og - mean) * torch.rsqrt(var + 64e-5)).reshape(b, t, h * hd).to(x.dtype)
    o = og * _heads(p["gn_g"], hp, hd).to(x.dtype) + _heads(p["gn_b"], hp, hd).to(x.dtype)
    o = o * g
    if hp.count > 1:
        o = ctx.c(o, ("batch", "seq", "heads"), (None, t, d))
    y = dense_rows(o, p["wo"].to(x.dtype), cfg, ctx, hp, ("batch", "seq", "embed"),
                   (None, t, d))
    return y, s_final, x[:, -1, :]


def _channel_mix(p, x, cfg, ctx, x_last):
    t = x.shape[1]
    fp = ctx.part("mlp", cfg.d_ff)
    x_prev = torch.cat([x_last[:, None, :], x[:, :-1, :]], dim=1)
    xk = x + (x_prev - x) * p["cm_mu_k"].to(x.dtype)
    xr = x + (x_prev - x) * p["cm_mu_r"].to(x.dtype)
    kk = torch.square(gemm(xk, p["cm_wk"].to(x.dtype), cfg, activation="relu"))
    kk = ctx.c(kk, ("batch", "seq", "mlp"), (None, t, cfg.d_ff))
    vv = dense_rows(kk, p["cm_wv"].to(x.dtype), cfg, ctx, fp, ("batch", "seq", "embed"),
                    (None, t, cfg.d_model))
    rr = gemm(xr, p["cm_wr"].to(x.dtype), cfg, activation="sigmoid")
    return rr * vv, x[:, -1, :]


def _run(params, tokens, cfg, ctx, state):
    t = tokens.shape[1]
    params, specs = top_weights(params, rwkv_specs, cfg, ctx)
    x = embed_tokens(params, tokens, cfg, ctx)
    x = ctx.c(x, ("batch", "seq_sp", "embed"), (None, t, cfg.d_model))
    new = {"wkv": [], "tm_shift": [], "cm_shift": []}
    for i, lp in enumerate(_layers(params["blocks"], cfg.num_layers)):
        lp, x = layer_entry(lp, x, ctx, t, specs)
        xin = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        y, wkv, tm_last = _time_mix(lp, xin, cfg, ctx, state["wkv"][i], state["tm_shift"][i])
        x = x + y
        xin2 = rmsnorm(x, lp["ln2"], cfg.norm_eps)
        y2, cm_last = _channel_mix(lp, xin2, cfg, ctx, state["cm_shift"][i])
        x = ctx.c(x + y2, ("batch", "seq_sp", "embed"), (None, t, cfg.d_model))
        for name, val in (("wkv", wkv), ("tm_shift", tm_last), ("cm_shift", cm_last)):
            new[name].append(val)
    logits = unembed(params, seq_whole(x, ctx, t), cfg, ctx)
    return logits, {name: torch.stack(vals) for name, vals in new.items()}


def rwkv_forward(params, tokens, cfg, ctx: ShardCtx = NO_SHARD):
    logits, _ = rwkv_prefill(params, tokens, cfg, ctx)
    return logits, {}


def rwkv_prefill(params, tokens, cfg, ctx: ShardCtx = NO_SHARD):
    state = _zero_state(cfg, tokens.shape[0], params["embed"].device, ctx)
    return _run(params, tokens, cfg, ctx, state)


def rwkv_decode(params, tokens, state, pos, cfg, ctx: ShardCtx = NO_SHARD):
    """pos unused (the state is position-free): kept for the API."""
    del pos
    return _run(params, tokens, cfg, ctx, state)
