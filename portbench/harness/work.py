"""The yardstick: operations and bytes that a cell's inputs need, from the
configuration and the shapes alone.

Work is the logical work the inputs need, whatever implements it: a
product counts 2·M·K·N operations and reads each input byte once and
writes each output byte once (bf16, 2 bytes, the type every configuration
states); attention counts its two products over the causal keys each query
needs.  The serving head counts the positions whose logits are used (the
last prompt position, each decode token), so work a program does beyond
that shows as a lower share.  Nothing here reads the port's plans.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

ITEM = 2  # bytes of a bf16 element

Product = Tuple[int, int, int, bool]  # (M, K, N, has bias)


def gemm_flops(m: int, k: int, n: int) -> int:
    return 2 * m * k * n


def gemm_bytes(m: int, k: int, n: int, bias: bool = False) -> int:
    return ITEM * (m * k + k * n + m * n + (n if bias else 0))


def bound_s(flops: float, nbytes: float, peaks: Dict[str, float]) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / peaks["bf16_flops_per_s"], nbytes / peaks["hbm_bytes_per_s"])


def layer_products(cfg) -> List[Tuple[str, int, int, bool]]:
    """One layer's dense products (name, K, N, bias): the attention
    projections and, for a dense model, the SwiGLU's fused gate|up and its
    down projection."""
    d, hd, h, kv = cfg.d_model, cfg.head_dim_, cfg.num_heads, cfg.num_kv_heads
    out = [("wq", d, h * hd, cfg.qkv_bias), ("wk", d, kv * hd, cfg.qkv_bias),
           ("wv", d, kv * hd, cfg.qkv_bias), ("wo", h * hd, d, False)]
    if not cfg.is_moe:
        out += [("wi", d, 2 * cfg.d_ff, False), ("wo_mlp", cfg.d_ff, d, False)]
    return out


def expert_products(cfg) -> List[Tuple[str, int, int]]:
    """One routed pair's expert products (name, K, N)."""
    d, f = cfg.d_model, cfg.moe_d_ff
    return [("wi", d, 2 * f), ("wo", f, d)]


def forward_products(cfg, m_layers: int, m_head: int) -> List[Product]:
    """Every dense product of one forward: the layers' at M = m_layers rows,
    the head's at M = m_head rows (0: none)."""
    rows: List[Product] = []
    for _ in range(cfg.num_layers):
        rows += [(m_layers, k, n, b) for _, k, n, b in layer_products(cfg)]
    if m_head:
        rows.append((m_head, cfg.d_model, cfg.vocab_size, False))
    return rows


def products_bound_s(products: Iterable[Product], peaks, *, backward: bool = False) -> float:
    """Sum of each product's roofline bound; with `backward`, also its two
    gradient products dA = dZ·Bᵀ (M, N, K) and dB = Aᵀ·dZ (K, M, N)."""
    total = 0.0
    for m, k, n, b in products:
        total += bound_s(gemm_flops(m, k, n), gemm_bytes(m, k, n, b), peaks)
        if backward:
            total += bound_s(gemm_flops(m, n, k), gemm_bytes(m, n, k), peaks)
            total += bound_s(gemm_flops(k, m, n), gemm_bytes(k, m, n), peaks)
    return total


def grouped_bound_s(cfg, pairs: int, peaks, *, backward: bool = False) -> float:
    """The routed experts' products of one forward (every layer) for
    `pairs` (token, expert) pairs: operations 2·pairs·K·N a product, bytes
    the pairs' rows in and out and every expert's weights once."""
    e = cfg.num_experts
    total = 0.0
    for _, k, n in expert_products(cfg):
        w = e * k * n
        fl = gemm_flops(pairs, k, n)
        total += bound_s(fl, ITEM * (pairs * k + w + pairs * n), peaks)
        if backward:
            total += 2 * bound_s(fl, ITEM * (pairs * k + w + pairs * n), peaks)
    return cfg.num_layers * total


def causal_keys(t_q: int, t0: int = 0) -> int:
    """Keys attended by t_q queries at positions t0 .. t0 + t_q - 1, each
    seeing the keys at and before its own position."""
    return t_q * t0 + t_q * (t_q + 1) // 2


def attention_flops(cfg, t_q: int, t0: int = 0) -> int:
    """Every layer's QKᵀ and PV products for those queries."""
    return cfg.num_layers * 4 * cfg.num_heads * cfg.head_dim_ * causal_keys(t_q, t0)


def attention_bytes(cfg, rows: int, t: int) -> int:
    """Every layer's q, k, v read once and the output written once."""
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    return cfg.num_layers * ITEM * rows * t * hd * (2 * h + 2 * kv)


def product_params(cfg) -> int:
    """Parameters a token multiplies in one forward: every layer's products
    (for an MoE, its router and experts_per_token experts) and the head.
    The embedding is a lookup, not a product."""
    layer = sum(k * n for _, k, n, _ in layer_products(cfg))
    if cfg.is_moe:
        layer += cfg.d_model * cfg.num_experts
        layer += cfg.num_experts_per_tok * sum(k * n for _, k, n in expert_products(cfg))
    return cfg.num_layers * layer + cfg.d_model * cfg.vocab_size


def train_step_flops(cfg, rows: int, t: int) -> int:
    """Needed operations of one training step: 6 per product parameter and
    token (forward and both gradients), attention three times its forward.
    Recomputation is not counted."""
    return 6 * product_params(cfg) * rows * t + 3 * rows * attention_flops(cfg, t)


def prefill_flops(cfg, t: int) -> int:
    """A prompt of t tokens: the layers' products at every position,
    attention, and the head at the last position only."""
    layers = product_params(cfg) - cfg.d_model * cfg.vocab_size
    return 2 * layers * t + attention_flops(cfg, t) + gemm_flops(1, cfg.d_model, cfg.vocab_size)


def decode_flops(cfg, context: int) -> int:
    """One decode token whose query sees `context` keys (itself included)."""
    return 2 * product_params(cfg) + cfg.num_layers * 4 * cfg.num_heads * cfg.head_dim_ * context


def k1_launches_train(cfg) -> int:
    """K1 launches a training step assumes: each layer product and the head
    once forward and twice backward (dA, dB)."""
    return 3 * (cfg.num_layers * len(layer_products(cfg)) + 1)


def k5_launches_train(cfg) -> int:
    """K5 launches a training step assumes: two expert products a layer,
    each once forward and twice backward."""
    return 3 * cfg.num_layers * len(expert_products(cfg)) if cfg.is_moe else 0


def serve_k1_products(cfg, prefills: Sequence[int], decode_slots: Sequence[int]) -> List[Product]:
    """The needed dense products of some prefills (prompt lengths) and some
    decode ticks (active slots of each)."""
    rows: List[Product] = []
    for t in prefills:
        rows += forward_products(cfg, t, 1)
    for s in decode_slots:
        rows += forward_products(cfg, s, s)
    return rows
