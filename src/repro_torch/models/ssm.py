"""Mamba2 (SSD) layers and the Zamba2 hybrid (arXiv:2411.15242) (port of
`repro.models.ssm`).

Mamba2's scalar-per-head decay keeps the chunked SSD form numerically safe
(every exponent it uses is a difference of a monotone cumulative log-decay,
hence <= 0), so prefill runs the matmul-rich chunked form (`ssd_chunked`) and
decode carries the (H, P, N) state with an O(1) step (`ssd_step`); the
sequential `ssd_scan` is the oracle.  All three are plain torch ops: the
reference writes them in XLA, not Pallas.  The projections go through
`layers.gemm` (kernel K1 under cfg.use_mesh_kernel).

`dt` goes through `torch.nn.functional.softplus`, which returns x itself
above 20 where the reference's `logaddexp(x, 0)` adds log1p(exp(-x)), under
1e-8 relative there.

Zamba2: `num_layers` Mamba2 blocks with one *shared-weight* transformer
block (attention + SwiGLU) applied after every `shared_attn_period` Mamba
layers — n_seg applications, each with its own KV cache.  Parameters
{"mamba_seg": (n_seg, period, ...), "mamba_tail": (tail, ...), "shared":
one block}; caches stacked (n_seg, B, T, KV, hd).  The shared block's
attention takes the chunked path (kernel K6 on the card) for prompts that
are a multiple of cfg.attn_chunk.

Tensor parallelism (a `ShardCtx` with a live mesh), SPMD by hand: each
process runs the Mamba2 block on its whole SSM heads (`ctx.part("mlp",
ssm_num_heads)`; every head replicates where they do not divide the
axis).  The fused in_proj's columns are laid out by `MAMBA_LAYOUT`: this
process's heads of z, x and dt, and B and C whole (n_groups is 1, so
every head reads them); conv_w / conv_b hold its x channels beside the
whole B and C channels, out_norm its x channels and out_proj their rows
(`interop.shard_params` cuts the tree so; a flat split of in_proj's 8384
columns would give rank 0 all of z).  The gated RMSNorm over d_in
normalises across the processes: each sums its channels' squares in f32,
one all-reduce makes the sum whole (in training it carries the gradient:
`parallel.collectives`).  out_proj is row-parallel (f32
partials, one all-reduce: `layers.dense_rows`).  The shared block runs the
dense family's tensor-parallel attention and SwiGLU.  The decode state
holds this process's heads (`h`), its conv channels (`conv`) and its kv
heads (`kv_k`, `kv_v`: `attention.HeadLayout.kv`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.attention import attention, attn_specs, cache_len, head_layout
from repro_torch.models.layers import (
    NO_SHARD,
    PSpec,
    ShardCtx,
    dense_rows,
    gemm,
    padded_vocab,
    rmsnorm,
)
from repro_torch.models.moe import swiglu, swiglu_specs
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
    "MAMBA_LAYOUT",
    "mamba_segments",
    "ssd_chunked",
    "ssd_scan",
    "ssd_step",
    "zamba_decode",
    "zamba_forward",
    "zamba_prefill",
    "zamba_specs",
    "zamba_state_specs",
]

_CHUNK = 128
_CONV_K = 4


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------


def ssd_step(h, x, dt, a_log, b, c, d_skip):
    """One decode step.  x: (B, H, P); dt: (B, H); b, c: (B, N);
    h: (B, H, P, N).  Returns (y, h)."""
    a = torch.exp(-torch.exp(a_log) * dt)  # (B, H)
    h = h * a[..., None, None] + (dt[..., None] * x)[..., None] * b[:, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", h, c) + d_skip[None, :, None] * x
    return y, h


def ssd_scan(x, dt, a_log, b, c, d_skip, h0):
    """Sequential oracle.  x: (B, T, H, P); dt: (B, T, H); a_log: (H,);
    b, c: (B, T, N); d_skip: (H,); h0: (B, H, P, N).  Returns (y, h_final)."""
    h, ys = h0, []
    for i in range(x.shape[1]):
        y, h = ssd_step(h, x[:, i], dt[:, i], a_log, b[:, i], c[:, i], d_skip)
        ys.append(y)
    return torch.stack(ys, dim=1), h


def ssd_chunked(x, dt, a_log, b, c, d_skip, h0, chunk: int = _CHUNK):
    """Chunk-parallel SSD (matmul form).  Same signature as `ssd_scan`; T is
    padded up to a multiple of `chunk` and the output cut back."""
    B, T, H, P = x.shape
    N = b.shape[-1]
    nc = -(-T // chunk)
    pad = nc * chunk - T
    if pad:
        def padt(t):
            return F.pad(t, [0, 0] * (t.dim() - 2) + [0, pad])

        x, dt, b, c = padt(x), padt(dt), padt(b), padt(c)
    C = chunk
    xc = x.reshape(B, nc, C, H, P)
    dtc = dt.reshape(B, nc, C, H)
    bc = b.reshape(B, nc, C, N)
    cc = c.reshape(B, nc, C, N)

    la = torch.cumsum(-torch.exp(a_log)[None, None, None] * dtc, dim=2)  # <= 0, decreasing
    # Intra-chunk: y[t] += sum_{j<=t} exp(la_t - la_j) dt_j (C_t.B_j) x_j
    diff = la[:, :, :, None, :] - la[:, :, None, :, :]  # (B, nc, C, C, H): t, j
    mask = torch.tril(torch.ones((C, C), dtype=torch.bool, device=x.device))
    # Above the diagonal (j > t) the exponent is >= 0 and may overflow: it is
    # masked to -inf BEFORE the exp, which gives the 0 the reference's
    # where-after-exp gives (the same values, bit for bit), while the
    # backward never forms 0 * inf.  The reference's gradients turn NaN where
    # a masked exponent overflows (la falling by more than 88 in a chunk).
    L = torch.exp(diff.masked_fill(~mask[None, None, :, :, None], float("-inf")))
    G = torch.einsum("bktn,bkjn->bktj", cc, bc)  # (B, nc, C, C)
    M = G[..., None] * L * dtc[:, :, None, :, :]  # weight for (t, j, h)
    y = torch.einsum("bktjh,bkjhp->bkthp", M, xc)
    # Inter-chunk: y[t] += exp(la_t) C_t . h_in; carry h across chunks.
    decay_in = torch.exp(la)  # (B, nc, C, H)
    a_prod = torch.exp(la[:, :, -1, :])  # (B, nc, H)
    # per-chunk state contribution: sum_j exp(la_C - la_j) dt_j (x_j (x) B_j)
    wj = torch.exp(la[:, :, -1:, :] - la) * dtc  # (B, nc, C, H)
    h_chunk = torch.einsum("bkjhp,bkjn->bkhpn", wj[..., None] * xc, bc)

    h, h_ins = h0, []
    for k in range(nc):
        h_ins.append(h)  # h_in of chunk k
        h = h * a_prod[:, k, :, None, None] + h_chunk[:, k]
    h_in = torch.stack(h_ins, dim=1)  # (B, nc, H, P, N)
    y = y + torch.einsum("bkthn,bkhpn->bkthp", decay_in[..., None] * cc[:, :, :, None, :], h_in)
    y = y.reshape(B, nc * C, H, P)[:, :T]
    y = y + d_skip[None, None, :, None] * x[:, :T].reshape(B, T, H, P)
    return y, h


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------


def _mamba_specs(cfg) -> Dict[str, Any]:
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    n = cfg.ssm_state_size
    h = cfg.ssm_num_heads
    conv_dim = d_in + 2 * n
    out_scale = 0.02 / max(1.0, (2 * cfg.num_layers) ** 0.5)
    return {
        "ln": PSpec((d,), ("embed",), init="ones"),
        "in_proj": PSpec((d, 2 * d_in + 2 * n + h), ("embed", "mlp"), 0.02),
        "conv_w": PSpec((_CONV_K, conv_dim), (None, "mlp"), 0.2),
        "conv_b": PSpec((conv_dim,), ("mlp",), init="zeros"),
        "a_log": PSpec((h,), (None,), 0.5),
        "dt_bias": PSpec((h,), (None,), 0.5),
        "d_skip": PSpec((h,), (None,), init="ones"),
        "out_norm": PSpec((d_in,), ("mlp",), init="ones"),
        "out_proj": PSpec((d_in, d), ("mlp", "embed"), out_scale),
    }


# The segments of the Mamba2 weights' 'mlp' dim, by key: "heads" is a
# segment of ssm_num_heads units of `unit` channels, of which each process
# holds its heads' (z, x, dt and their channels), "whole" one that every
# process holds whole (B and C: n_groups is 1).
MAMBA_LAYOUT = {
    "in_proj": (("heads", "p"), ("heads", "p"), ("whole", "n"), ("whole", "n"), ("heads", 1)),
    "conv_w": (("heads", "p"), ("whole", "n"), ("whole", "n")),
    "conv_b": (("heads", "p"), ("whole", "n"), ("whole", "n")),
    "out_norm": (("heads", "p"),),
    "out_proj": (("heads", "p"),),
}


def mamba_segments(cfg, key: str):
    """[(kind, units, unit)] of `MAMBA_LAYOUT[key]` at cfg's sizes, in
    order: `units` heads of `unit` channels ("heads"), or one whole block
    of `unit` channels ("whole")."""
    h = cfg.ssm_num_heads
    sizes = {"p": cfg.ssm_expand * cfg.d_model // h, "n": cfg.ssm_state_size, 1: 1}
    return [(kind, h if kind == "heads" else 1, sizes[u]) for kind, u in MAMBA_LAYOUT[key]]


def _split_proj(cfg, z_xbc_dt, heads: Optional[int] = None):
    """(z, x, B, C, dt) at the reference's split *indices* (tensor_split),
    for `heads` of the cfg's SSM heads (None: all of them)."""
    h = cfg.ssm_num_heads
    d_in = cfg.ssm_expand * cfg.d_model * (h if heads is None else heads) // h
    n = cfg.ssm_state_size
    return torch.tensor_split(
        z_xbc_dt, [d_in, 2 * d_in, 2 * d_in + n, 2 * d_in + 2 * n], dim=-1)


def _causal_conv(xbc, w, bias, conv_state=None):
    """Depthwise causal conv (K=4) by shifted adds.  xbc: (B, T, Cd).

    conv_state: (B, K-1, Cd) previous inputs, before the activation (decode);
    returns (y, new_state)."""
    b, t, cd = xbc.shape
    if conv_state is None:
        conv_state = torch.zeros((b, _CONV_K - 1, cd), dtype=xbc.dtype, device=xbc.device)
    full = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)  # (B, T+3, Cd)
    y = sum(full[:, i : i + t, :] * w[i][None, None, :].to(xbc.dtype) for i in range(_CONV_K))
    y = F.silu(y + bias[None, None].to(xbc.dtype))
    return y, full[:, -(_CONV_K - 1):, :]


def _gated_norm(y, z, gamma, cfg, ctx: ShardCtx, hp, d_in: int):
    """rmsnorm(y, gamma) * silu(z) over the whole d_in: under a mesh `y`
    holds this process's channels, and its f32 sum of squares is
    all-reduced before the scale (the one f32 mean of `rmsnorm`, summed in
    another order)."""
    if hp.count == 1:
        return rmsnorm(y, gamma, cfg.norm_eps) * F.silu(z)
    yf = y.float()
    ss = torch.sum(yf * yf, dim=-1, keepdim=True)
    ss = ctx.c(ss, ("batch", "seq", None), (None, y.shape[1], 1), partial=hp)
    out = (yf * torch.rsqrt(ss / d_in + cfg.norm_eps)).to(y.dtype) * gamma.to(y.dtype)
    return out * F.silu(z)


def _mamba_block(p, x, cfg, ctx, state, *, chunked: bool):
    """state = {"h": (B, H, P, N), "conv": (B, 3, Cd)}; returns (y, new_state).
    Under a mesh H, Cd and the channels are this process's (module
    docstring)."""
    b, t, d = x.shape
    d_in = cfg.ssm_expand * d
    n = cfg.ssm_state_size
    p_dim = d_in // cfg.ssm_num_heads
    hp = ctx.part("mlp", cfg.ssm_num_heads)
    h, d_loc = hp.size, hp.size * p_dim  # this process's heads and x channels
    f32 = torch.float32

    zxbcdt = gemm(x, p["in_proj"].to(x.dtype), cfg)
    z, xin, bmat, cmat, dt = _split_proj(cfg, zxbcdt, h)
    xbc = torch.cat([xin, bmat, cmat], dim=-1)
    xbc, conv_state = _causal_conv(xbc, p["conv_w"], p["conv_b"], state["conv"])
    xin, bmat, cmat = torch.tensor_split(xbc, [d_loc, d_loc + n], dim=-1)

    def mine(v):  # this process's heads of a per-head (H,) parameter
        return v if hp.count == 1 else v.narrow(0, hp.start, h)

    xh = xin.reshape(b, t, h, p_dim).to(f32)
    dtv = F.softplus(dt.to(f32) + mine(p["dt_bias"]).to(f32))
    bf, cf = bmat.to(f32), cmat.to(f32)
    a_log, d_skip = mine(p["a_log"]).to(f32), mine(p["d_skip"]).to(f32)

    if t == 1:
        y, h_new = ssd_step(state["h"], xh[:, 0], dtv[:, 0], a_log, bf[:, 0], cf[:, 0], d_skip)
        y = y[:, None]
    elif chunked:
        y, h_new = ssd_chunked(xh, dtv, a_log, bf, cf, d_skip, state["h"])
    else:
        y, h_new = ssd_scan(xh, dtv, a_log, bf, cf, d_skip, state["h"])

    y = y.reshape(b, t, d_loc).to(x.dtype)
    y = _gated_norm(y, z, p["out_norm"], cfg, ctx, hp, d_in)
    if hp.count > 1:
        y = ctx.c(y, ("batch", "seq", "mlp"), (None, t, d_in))
    out = dense_rows(y, p["out_proj"].to(x.dtype), cfg, ctx, hp, ("batch", "seq", "embed"),
                     (None, t, d))
    return out, {"h": h_new, "conv": conv_state}


# ---------------------------------------------------------------------------
# Zamba2 hybrid model
# ---------------------------------------------------------------------------


def _segments(cfg) -> Tuple[int, int, int]:
    period = cfg.shared_attn_period
    n_seg = cfg.num_layers // period
    tail = cfg.num_layers - n_seg * period
    return n_seg, period, tail


def zamba_specs(cfg) -> Dict[str, Any]:
    n_seg, period, tail = _segments(cfg)
    one = _mamba_specs(cfg)
    specs: Dict[str, Any] = {
        "embed": PSpec((padded_vocab(cfg), cfg.d_model), ("vocab", "embed"), 0.02),
        "mamba_seg": stack_specs(stack_specs(one, period), n_seg),
        "shared": {
            "ln1": PSpec((cfg.d_model,), ("embed",), init="ones"),
            "ln2": PSpec((cfg.d_model,), ("embed",), init="ones"),
            "attn": attn_specs(cfg),
            "mlp": swiglu_specs(cfg, cfg.d_ff),
        },
        "final_norm": PSpec((cfg.d_model,), ("embed",), init="ones"),
        "lm_head": PSpec((cfg.d_model, padded_vocab(cfg)), ("embed", "vocab"), 0.02),
    }
    if tail:
        specs["mamba_tail"] = stack_specs(one, tail)
    return specs


def zamba_state_specs(cfg, batch: int, max_len: int, ctx: ShardCtx = NO_SHARD, *,
                      caches: bool = True):
    """Decode state as {name: (shape, dtype)}: per-layer SSM and conv
    states, per-application KV caches (left out with `caches` False);
    under a mesh, this process's SSM heads, conv channels and kv heads,
    and under 'kv_seq' its block of the caches' positions."""
    n_seg, _, _ = _segments(cfg)
    d_in = cfg.ssm_expand * cfg.d_model
    n, h = cfg.ssm_state_size, cfg.ssm_num_heads
    hl = ctx.part("mlp", h).size
    cd = d_in // h * hl + 2 * n
    kv, hd = head_layout(cfg, ctx).kv.size, cfg.head_dim_
    L = cfg.num_layers
    out = {
        "h": ((L, batch, hl, d_in // h, n), torch.float32),
        "conv": ((L, batch, _CONV_K - 1, cd), cfg.adtype),
    }
    if caches:
        t = cache_len(ctx, max_len)
        out["kv_k"] = ((n_seg, batch, t, kv, hd), cfg.adtype)
        out["kv_v"] = ((n_seg, batch, t, kv, hd), cfg.adtype)
    return out


def _zero_state(cfg, batch: int, max_len: int, device, ctx: ShardCtx = NO_SHARD):
    return {name: torch.zeros(shape, dtype=dt, device=device)
            for name, (shape, dt) in zamba_state_specs(cfg, batch, max_len, ctx,
                                                       caches=False).items()}


def _shared_block(p, x, cfg, ctx, kv=None, cache_pos=None, write_cache=False):
    h, new_cache = attention(
        p["attn"],
        rmsnorm(x, p["ln1"], cfg.norm_eps),
        cfg,
        ctx,
        cache=kv,
        cache_pos=cache_pos,
        write_cache=write_cache,
    )
    x = x + h
    x = x + swiglu(p["mlp"], rmsnorm(x, p["ln2"], cfg.norm_eps), cfg, ctx)
    return x, new_cache


def _run(params, tokens, cfg, ctx, state, *, mode: str, pos=None, chunked=True):
    """mode: 'forward' (no cache IO) | 'prefill' | 'decode'."""
    n_seg, period, tail = _segments(cfg)
    t = tokens.shape[1]
    params, specs = top_weights(params, zamba_specs, cfg, ctx,
                                stacked=("mamba_seg", "mamba_tail"))
    x = embed_tokens(params, tokens, cfg, ctx)
    x = ctx.c(x, ("batch", "seq_sp", "embed"), (None, t, cfg.d_model))
    L = cfg.num_layers
    new_h, new_conv, new_k, new_v = [], [], [], []

    def mamba_stack(x, stacked, n, lo, name):
        for i, lp in enumerate(_layers(stacked, n)):
            lp, x = layer_entry(lp, x, ctx, t, specs, name)
            st = {"h": state["h"][lo + i], "conv": state["conv"][lo + i]}
            y, st_new = _mamba_block(lp, x, cfg, ctx, st, chunked=chunked)
            x = ctx.c(x + y, ("batch", "seq_sp", "embed"), (None, t, cfg.d_model))
            new_h.append(st_new["h"])
            new_conv.append(st_new["conv"])
        return x

    for seg, stacked in enumerate(_layers(params["mamba_seg"], n_seg)):
        x = seq_whole(mamba_stack(x, stacked, period, seg * period, "mamba_seg"), ctx, t)
        if mode == "forward":
            x, _ = _shared_block(params["shared"], x, cfg, ctx)
            continue
        if mode == "prefill":
            x, kvc = _shared_block(params["shared"], x, cfg, ctx, write_cache=True)
        else:  # decode
            kv = {"k": state["kv_k"][seg], "v": state["kv_v"][seg]}
            x, kvc = _shared_block(params["shared"], x, cfg, ctx, kv=kv, cache_pos=pos)
        new_k.append(kvc["k"])
        new_v.append(kvc["v"])
    if tail:
        x = mamba_stack(x, params["mamba_tail"], tail, L - tail, "mamba_tail")

    logits = unembed(params, seq_whole(x, ctx, t), cfg, ctx)
    new_state = {"h": torch.stack(new_h), "conv": torch.stack(new_conv)}
    if mode != "forward":
        new_state["kv_k"] = torch.stack(new_k)
        new_state["kv_v"] = torch.stack(new_v)
    return logits, new_state


def zamba_forward(params, tokens, cfg, ctx: ShardCtx = NO_SHARD, *, chunked=True):
    state = _zero_state(cfg, tokens.shape[0], 1, params["embed"].device, ctx)
    logits, _ = _run(params, tokens, cfg, ctx, state, mode="forward", chunked=chunked)
    return logits, {}


def zamba_prefill(params, tokens, cfg, ctx: ShardCtx = NO_SHARD, *, chunked=True):
    state = _zero_state(cfg, tokens.shape[0], 1, params["embed"].device, ctx)
    return _run(params, tokens, cfg, ctx, state, mode="prefill", chunked=chunked)


def zamba_decode(params, tokens, state, pos, cfg, ctx: ShardCtx = NO_SHARD):
    return _run(params, tokens, cfg, ctx, state, mode="decode", pos=int(pos))
