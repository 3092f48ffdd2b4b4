"""The plain reference of the decoder-only models the port runs, dense
(Qwen2-7B) and with routed experts (OLMoE-1B-7B), in float32.

It computes the function the port's `models.transformer` computes, from
the equations and not from the port's code: pre-norm blocks of RMSNorm,
grouped-query causal attention with rotary positions (pairs (even, odd)
rotated, as the port and its JAX original rotate them; the published
models rotate halves, which is the same function up to an order of each
head's dims and makes no difference with random weights), and SwiGLU, or
a router whose softmax picks the top k experts, their weights
renormalised to sum to 1 (the published OLMoE does not renormalise and
adds QK-norm; the port does neither, and the reference follows the port,
which is what is judged), each expert taking at most `capacity` pairs in
token order.  Every product is a float32 matmul with TF32 off;
`fp8=True` rounds both operands of every product to float8 e4m3 with a
per-tensor scale first: the control, the precision below the bfloat16
the configurations state.

Weights come as a tree of the port's layout (stacked layers, gate|up side
by side in `wi`); the reference reads only their values.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

E4M3_MAX = 448.0


def fake_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale; the gradient
    passes straight through."""
    s = x.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
    y = (x.detach() / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    return x + (y - x).detach()


def mm(a: torch.Tensor, b: torch.Tensor, fp8: bool) -> torch.Tensor:
    if fp8:
        a, b = fake_fp8(a), fake_fp8(b)
    return torch.matmul(a, b)


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * g


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (..., T, H, hd), pos (T,): rotate each pair (x[2i], x[2i+1])."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = pos.to(torch.float32)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).reshape(x.shape)


def attend(q, k, v, fp8: bool, block: int = 512) -> torch.Tensor:
    """Causal grouped-query attention of one sequence: q (T, H, hd) at
    positions 0..T-1, k and v (T, KV, hd); query head h reads kv head
    h // (H / KV).  Queries in blocks, each over the keys it may see."""
    t, h, hd = q.shape
    kv = k.shape[1]
    rep = h // kv
    outs = []
    for s in range(0, t, block):
        qb = q[s:s + block]
        b, end = qb.shape[0], s + qb.shape[0]
        qg = qb.reshape(b, kv, rep, hd).permute(1, 2, 0, 3)  # (KV, rep, b, hd)
        kg = k[:end].permute(1, 2, 0)  # (KV, hd, end)
        vg = v[:end].permute(1, 0, 2)  # (KV, end, hd)
        scores = mm(qg, kg[:, None], fp8) / math.sqrt(hd)  # (KV, rep, b, end)
        qpos = torch.arange(s, end, device=q.device)[:, None]
        allowed = torch.arange(end, device=q.device)[None, :] <= qpos
        scores = scores.masked_fill(~allowed, float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        o = mm(probs, vg[:, None], fp8)  # (KV, rep, b, hd)
        outs.append(o.permute(2, 0, 1, 3).reshape(b, h, hd))
    return torch.cat(outs, dim=0)


def capacity(n: int, t: int, e: int, k: int, factor: float = 1.25) -> int:
    """Rows an expert may take: the n tokens are cut into groups of s
    tokens (up to 1024, halved until they divide n), each group granting
    factor·s·k/e rows an expert; groups of 256 tokens or fewer route every
    pair."""
    s = min(1024, t) if t > 1 else min(1024, n)
    while n % s:
        s //= 2
    if s <= 256:
        return n
    return (n // s) * max(1, int(factor * s * k / e))


def moe(h: torch.Tensor, w: Dict[str, torch.Tensor], cfg, t: int, fp8: bool):
    """Routed experts on h (n, d): (output (n, d), load-balance loss,
    router z-loss)."""
    n, _ = h.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    logits = mm(h, w["router"], fp8)
    probs = torch.softmax(logits, dim=-1)
    topi = torch.argsort(probs.detach(), dim=-1, descending=True, stable=True)[:, :k]
    topv = torch.gather(probs, 1, topi)
    topv = topv / topv.sum(dim=-1, keepdim=True)
    flat_e = topi.reshape(-1)
    tok = torch.arange(n * k, device=h.device) // k
    counts = torch.bincount(flat_e, minlength=e)
    # each pair's rank among its expert's pairs, in token order
    order = torch.argsort(flat_e, stable=True)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(flat_e)
    rank[order] = torch.arange(n * k, device=h.device) - starts[flat_e[order]]
    keep = rank < capacity(n, t, e, k)
    gates = topv.reshape(-1)
    f = w["ewi"].shape[-1] // 2
    out = torch.zeros_like(h)
    for ex in range(e):
        sel = torch.nonzero((flat_e == ex) & keep)[:, 0]
        if sel.numel() == 0:
            continue
        rows = h[tok[sel]]
        gu = mm(rows, w["ewi"][ex], fp8)
        y = mm(F.silu(gu[:, :f]) * gu[:, f:], w["ewo"][ex], fp8)
        out = out.index_add(0, tok[sel], y * gates[sel, None])
    load = counts.to(torch.float32) / n
    lb = e * torch.sum(load * probs.mean(dim=0)) / k
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return out, lb, z


def layer(x: torch.Tensor, w: Dict[str, torch.Tensor], cfg, fp8: bool):
    """One block on x (B, T, d) at positions 0..T-1: (x, lb, z)."""
    b, t, d = x.shape
    h_, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    pos = torch.arange(t, device=x.device)
    a = rmsnorm(x, w["ln1"], cfg.norm_eps)

    def proj(name, bias):
        y = mm(a, w[name], fp8)
        return y + w[bias] if bias in w else y

    q = rope(proj("wq", "bq").reshape(b, t, h_, hd), pos, cfg.rope_theta)
    kk = rope(proj("wk", "bk").reshape(b, t, kv, hd), pos, cfg.rope_theta)
    v = proj("wv", "bv").reshape(b, t, kv, hd)
    att = torch.stack([attend(q[i], kk[i], v[i], fp8) for i in range(b)])
    x = x + mm(att.reshape(b, t, h_ * hd), w["wo"], fp8)
    a2 = rmsnorm(x, w["ln2"], cfg.norm_eps)
    zero = torch.zeros((), device=x.device)
    if "router" in w:
        y, lb, z = moe(a2.reshape(b * t, d), w, cfg, t, fp8)
        return x + y.reshape(b, t, d), lb, z
    f = w["wi"].shape[-1] // 2
    gu = mm(a2, w["wi"], fp8)
    return x + mm(F.silu(gu[..., :f]) * gu[..., f:], w["wo_mlp"], fp8), zero, zero


def layer_weights(params, i: int, dtype=None) -> Dict[str, torch.Tensor]:
    """Layer i's weights from the stacked tree, flat: attention's under
    their names, the dense feed-forward's as `wi` and `wo_mlp`, the
    router's as `router` and the experts' as `ewi` and `ewo`; upcast to
    `dtype` if given."""
    blocks = params["blocks"]
    out = {"ln1": blocks["ln1"][i], "ln2": blocks["ln2"][i]}
    out.update({k: v[i] for k, v in blocks["attn"].items()})
    if "mlp" in blocks:
        out["wi"], out["wo_mlp"] = blocks["mlp"]["wi"][i], blocks["mlp"]["wo"][i]
    else:
        moe_w = blocks["moe"]
        out["router"], out["ewi"], out["ewo"] = (moe_w[k][i] for k in ("router", "wi", "wo"))
    return out if dtype is None else {k: v.to(dtype) for k, v in out.items()}


@torch.no_grad()
def served_logits(params, cfg, seqs: Sequence[torch.Tensor], rows: Sequence[Tuple[int, int]],
                  fp8: bool = False) -> List[torch.Tensor]:
    """Logits (float32) at positions rows[j] = [lo, hi) of each sequence
    seqs[j] (token ids), the whole sequence run causally from position 0.
    Layer by layer over all sequences, each layer's weights upcast once,
    so it fits beside nothing else the card holds."""
    xs = [params["embed"][s.long()].to(torch.float32)[None] for s in seqs]
    for i in range(cfg.num_layers):
        w = layer_weights(params, i, torch.float32)
        xs = [layer(x, w, cfg, fp8)[0] for x in xs]
        del w
    head = params["lm_head"].to(torch.float32)
    gain = params["final_norm"].to(torch.float32)
    return [mm(rmsnorm(x[0, lo:hi], gain, cfg.norm_eps), head, fp8)
            for x, (lo, hi) in zip(xs, rows)]


def loss(params, batch: Dict[str, torch.Tensor], cfg, fp8: bool = False,
         rows: Optional[int] = None, chunk: int = 2048) -> torch.Tensor:
    """Mean next-token cross-entropy of the batch (its first `rows` rows if
    given), plus for experts 0.01·mean load-balance loss and 1e-3·mean
    router z-loss over the layers.  Each layer and each chunk of the head
    is recomputed in the backward, so one layer's activations live at a
    time."""
    tokens, labels = batch["tokens"], batch["labels"]
    if rows is not None:
        tokens, labels = tokens[:rows], labels[:rows]
    x = params["embed"][tokens.long()]
    lbs, zs = [], []
    for i in range(cfg.num_layers):
        w = layer_weights(params, i)
        names = sorted(w)

        def body(x, *ws, names=names):
            return layer(x, dict(zip(names, ws)), cfg, fp8)

        x, lb, z = checkpoint(body, x, *(w[n] for n in names), use_reentrant=False)
        lbs.append(lb)
        zs.append(z)
    hidden = x.reshape(-1, x.shape[-1])
    gold = labels.reshape(-1).long()

    def head(hc, gc, gain, w):
        lg = mm(rmsnorm(hc, gain, cfg.norm_eps), w, fp8)
        return torch.sum(torch.logsumexp(lg, dim=-1) - lg.gather(1, gc[:, None])[:, 0])

    total = sum(checkpoint(head, hidden[s:s + chunk], gold[s:s + chunk], params["final_norm"],
                           params["lm_head"], use_reentrant=False)
                for s in range(0, hidden.shape[0], chunk))
    out = total / hidden.shape[0]
    if cfg.is_moe:
        out = out + cfg.router_aux_coef * torch.stack(lbs).mean() + 1e-3 * torch.stack(zs).mean()
    return out
