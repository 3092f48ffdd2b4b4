"""Port: the launch plans of K4 (split-context paged attention) and K1 (the
mesh GEMM's tile families), which the host computes from shapes alone.

K4 splits each slot's block table into runs of `split_pages` pages, one CTA
per (slot, kv head, split) for each chunk of at most 8 of a KV head's rep
query rows (`rep_chunks`), then combines the per-split partials (m, l,
acc).  The split is a pure function of the table width, the number of
(slot, kv head) pairs and the SM count, never of `lengths`, so choosing it
never waits for the device.  The partials and the combine rule are written
out here in torch and held against the plain version `paged_attention_torch`
(f32: the two differ in summation order only, 1e-6 of the output's scale);
on the card, the partials the kernel writes and its combine's output are
held against them.

K1's tile is a pure function of (M, N, K, blocks, dtype): every mesh-paper
prefill and training product in bf16 takes the tensor-core tile, every f32
product of the `_mm` backward the f32 tile, decode (M <= 16) the decode
tile, every K1 product of RWKV-6's, Zamba2's and Whisper's full-width
prefill and decode step (recorded on meta tensors) a tensor-core tile, and
the 8/16-wide blocks of the on-card tests the first SIMT tiles.  None of
this needs a card.
"""

import inspect

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import api  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels.mesh_matmul import TILE_CONFIGS, tile_config  # noqa: E402

SMS = (108, 114, 132)  # A100, H100 PCIe, H100 SXM
QWEN2 = dict(slots=4, kv_heads=4, rep=7, pages=-(-(4096 + 16) // 8))  # chip_smoke's serve_qwen2


# -- K4: the split ---------------------------------------------------------------


@pytest.mark.parametrize(
    "n_pages,pairs,sms",
    [
        (1, 1, 132),  # a one-page table
        (3, 64, 108),  # fewer pages than the least split
        (22, 256, 132),  # more pairs than CTAs wanted: the least split
        (20, 64, 132),  # mesh-paper's decode: 64 (slot, head) pairs
        (130, 16, 132),  # chip_smoke's split-boundary table
        (QWEN2["pages"], 16, 114),  # Qwen2-7B's decode on an H100 PCIe
        (2052, 8, 132),  # a 16k-token context
        (8000, 1, 132),  # one pair: the largest split
    ],
)
def test_split_plan_covers_every_page_once(n_pages, pairs, sms):
    split_pages, n_splits = pa.split_plan(n_pages, pairs, sms)
    assert pa._MIN_SPLIT_PAGES <= split_pages <= pa._MAX_SPLIT_PAGES
    # The splits tile the table: every page in exactly one split, no split
    # wholly past the table's end.
    assert (n_splits - 1) * split_pages < n_pages <= n_splits * split_pages
    owners = np.arange(n_pages) // split_pages
    assert owners.max() == n_splits - 1 and np.all(np.bincount(owners) <= split_pages)


def test_split_plan_reads_no_device_value():
    # Its inputs are host integers: the table width, the pair count and the
    # SM count; `lengths` is not among them, so the grid never waits for it.
    assert list(inspect.signature(pa.split_plan).parameters) == ["n_pages", "pairs", "sm_count"]
    plans = {pa.split_plan(516, 16, 132) for _ in range(3)}
    assert plans == {(16, 33)}


@pytest.mark.parametrize("sms", SMS)
def test_split_plan_fills_the_card_at_qwen2_decode(sms):
    split_pages, n_splits = pa.split_plan(QWEN2["pages"], QWEN2["slots"] * QWEN2["kv_heads"], sms)
    ctas = QWEN2["slots"] * QWEN2["kv_heads"] * n_splits
    assert ctas >= 2 * sms, (split_pages, n_splits)


# -- K4: the combine rule --------------------------------------------------------


def _inputs(rng, s, h, kvh, hd, ps, n_pages, lengths):
    pool = 1 + s * n_pages
    q = rng.standard_normal((s, h, hd)).astype(np.float32)
    k = rng.standard_normal((pool, ps, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((pool, ps, kvh, hd)).astype(np.float32)
    bt = rng.permutation(np.arange(1, pool))[: s * n_pages].reshape(s, n_pages)
    arrays = (q, k, v, bt.astype(np.int32), np.asarray(lengths, np.int32))
    return [torch.from_numpy(x) for x in arrays]


def _split_partials(q, k_pool, v_pool, bt, lengths, split_pages):
    """What K4's first launch leaves: per (slot, kv head, split, row) the
    split's running max m over its valid keys, l = sum e^(s - m) and acc =
    sum e^(s - m) v; an empty split (no valid key) has m = -1e30, l = 0."""
    s, h, hd = q.shape
    ps, kvh = k_pool.shape[1], k_pool.shape[2]
    rep = h // kvh
    n_pages = bt.shape[1]
    n_splits = -(-n_pages // split_pages)
    k = pa.gather_pages(k_pool, bt)  # (S, T, KV, hd)
    v = pa.gather_pages(v_pool, bt)
    q5 = q.reshape(s, kvh, rep, hd)
    scores = torch.einsum("skrd,stkd->skrt", q5, k) * hd**-0.5  # (S, KV, rep, T)
    tok = torch.arange(n_pages * ps)
    m = torch.full((s, kvh, n_splits, rep), -1e30)
    l = torch.zeros(s, kvh, n_splits, rep)
    acc = torch.zeros(s, kvh, n_splits, rep, hd)
    for sp in range(n_splits):
        keys = (tok >= sp * split_pages * ps) & (tok < (sp + 1) * split_pages * ps)
        for i in range(s):
            valid = keys & (tok < lengths[i])
            if not valid.any():
                continue
            sc = scores[i][..., valid]  # (KV, rep, t)
            mx = sc.max(dim=-1).values
            p = torch.exp(sc - mx[..., None])
            m[i, :, sp] = mx
            l[i, :, sp] = p.sum(-1)
            acc[i, :, sp] = torch.einsum("krt,tkd->krd", p, v[i][valid])
    return m, l, acc


def _combine(m, l, acc):
    """K4's second launch: M = max m over the non-empty splits, out =
    sum acc_s e^(m_s - M) / sum l_s e^(m_s - M); empty splits (l == 0) add
    nothing, and l == 0 overall reads as 1."""
    live = l > 0
    big = torch.where(live, m, torch.full_like(m, -float("inf"))).amax(dim=2, keepdim=True)
    w = torch.where(live, torch.exp(m - big), torch.zeros_like(m))  # (S, KV, splits, rep)
    num = (acc * w[..., None]).sum(dim=2)
    den = (l * w).sum(dim=2)
    den = torch.where(den == 0, torch.ones_like(den), den)
    out = num / den[..., None]  # (S, KV, rep, hd)
    return out.reshape(out.shape[0], -1, out.shape[-1])


@pytest.mark.parametrize("seed", range(6))
def test_combine_of_split_partials_equals_plain_version(seed):
    rng = np.random.default_rng(seed)
    kvh, rep, hd, ps = (1, 2, 4)[seed % 3], (1, 3, 7, 8)[seed % 4], (16, 32)[seed % 2], 4
    s, n_pages = 4, int(rng.integers(6, 14))
    # Lengths across the table; a short one leaves the later splits empty.
    lengths = [1, int(rng.integers(2, n_pages * ps + 1)), n_pages * ps, ps * 2]
    split_pages = int(rng.integers(1, n_pages + 1))
    q, kp, vp, bt, ln = _inputs(rng, s, kvh * rep, kvh, hd, ps, n_pages, lengths)
    got = _combine(*_split_partials(q, kp, vp, bt, ln, split_pages))
    want = pa.paged_attention_torch(q, kp, vp, bt, ln)
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-6 * scale, (split_pages, lengths)


def test_combine_reads_an_empty_slot_as_zero():
    # length 0: every split is empty (l == 0), so the output is 0 / 1, as in
    # the reference Pallas kernel (`l == 0` read as 1).
    rng = np.random.default_rng(7)
    q, kp, vp, bt, ln = _inputs(rng, 2, 4, 2, 16, 4, 8, [0, 13])
    m, l, acc = _split_partials(q, kp, vp, bt, ln, 3)
    assert torch.all(l[0] == 0) and torch.all(l[1, :, :2] > 0) and torch.all(l[1, :, 2:] == 0)
    got = _combine(m, l, acc)
    assert torch.all(got[0] == 0)
    want = pa.paged_attention_torch(q, kp, vp, bt, ln)
    assert (got[1] - want[1]).abs().max().item() <= 1e-6 * want[1].abs().max().item()


@pytest.mark.parametrize("rep", range(1, 17))
def test_rep_chunks_cover_each_query_row_once(rep):
    """The split kernel runs a KV head's rep query rows in chunks of at most
    `_MAX_REP` (rep 12 = 8 + 4): every row in exactly one chunk, in order."""
    chunks = pa.rep_chunks(rep)
    rows = [r for r0, n in chunks for r in range(r0, r0 + n)]
    assert rows == list(range(rep))
    assert all(1 <= n <= pa._MAX_REP for _, n in chunks)
    assert len(chunks) == -(-rep // pa._MAX_REP)
    if rep == 12:
        assert chunks == ((0, 8), (8, 4))


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the GPU machine")
    return torch.device("cuda")


def test_kernel_partials_and_combine_on_card(cuda):
    """The partials K4's split kernel writes are `_split_partials` (its m in
    log2 units), and its combine merges them as `_combine` does (f32:
    summation order only)."""
    rng = np.random.default_rng(11)
    s, kvh, rep, hd, ps, n_pages = 3, 2, 3, 32, 4, 40
    lengths = [1, 75, n_pages * ps]  # slot 0 has one live split, slot 1 a few
    arrays = _inputs(rng, s, kvh * rep, kvh, hd, ps, n_pages, lengths)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    split_pages, n_splits = pa.split_plan(n_pages, s * kvh, sms)
    assert n_splits >= 4, (split_pages, n_splits)
    out, m, l, acc = pa._launch(*[t.to(cuda) for t in arrays])
    torch.cuda.synchronize()
    m_ref, l_ref, acc_ref = _split_partials(*arrays, split_pages)
    m, l, acc, out = (t.cpu() for t in (m, l, acc, out))
    live = l_ref > 0
    assert torch.equal(l > 0, live) and torch.all(m[~live] == -1e30)
    assert not live[0, :, 1:].any() and live[2].all()
    m = torch.where(live, m * float(np.log(2)), m)  # natural-log units
    torch.testing.assert_close(m[live], m_ref[live], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(l[live], l_ref[live], atol=0, rtol=1e-5)
    scale = acc_ref.abs().max().item()
    torch.testing.assert_close(acc[live], acc_ref[live], atol=1e-5 * scale, rtol=0)
    # The combine never reads an empty split's acc, which stays unwritten.
    merged = _combine(m, l, torch.where(live[..., None], acc, 0.0))
    scale = merged.abs().max().item()
    torch.testing.assert_close(out, merged, atol=1e-5 * scale, rtol=0)


def test_kernel_partials_in_rep_chunks_on_card(cuda):
    """At rep 12 (two chunks, 8 + 4 rows), the partials of every row are
    written and match `_split_partials`, and the output the plain version."""
    rng = np.random.default_rng(12)
    s, kvh, rep, hd, ps, n_pages = 2, 2, 12, 64, 8, 24
    lengths = [150, 9]
    arrays = _inputs(rng, s, kvh * rep, kvh, hd, ps, n_pages, lengths)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    split_pages, _ = pa.split_plan(n_pages, s * kvh, sms)
    out, m, l, acc = pa._launch(*[t.to(cuda) for t in arrays])
    torch.cuda.synchronize()
    m_ref, l_ref, acc_ref = _split_partials(*arrays, split_pages)
    m, l, acc, out = (t.cpu() for t in (m, l, acc, out))
    live = l_ref > 0
    assert torch.equal(l > 0, live)
    torch.testing.assert_close(l[live], l_ref[live], atol=0, rtol=1e-5)
    scale = acc_ref.abs().max().item()
    torch.testing.assert_close(acc[live], acc_ref[live], atol=1e-5 * scale, rtol=0)
    want = pa.paged_attention_torch(*arrays)
    assert (out - want).abs().max().item() <= 1e-5 * want.abs().max().item()


# -- K1: the tile families -------------------------------------------------------


def _mesh_paper_gemms():
    """(K, N) of mesh-paper's GEMMs: wq/wk/wv/wo, fused gate+up, mlp wo,
    lm_head."""
    cfg = get_config("mesh-paper")
    d, ff, vocab = cfg.d_model, cfg.d_ff, cfg.vocab_size
    return [(d, d), (d, 2 * ff), (ff, d), (d, vocab)]


@pytest.mark.parametrize("m", [17, 128, 2 * 2048])  # prefill rows, 2 x 2048 training tokens
def test_mesh_paper_bf16_products_take_the_tensor_core_tile(m):
    for k, n in _mesh_paper_gemms():
        assert tile_config(m, n, k, 128, 128, 128, torch.bfloat16) == "tc128", (m, k, n)


@pytest.mark.parametrize("activation", [None, "gelu"])
def test_mm_backward_f32_products_take_the_f32_tile(activation):
    """Every GEMM `mm_backward` runs (z remat, dA, dB) at mesh-paper's
    training shapes, recorded on meta tensors, takes the f32 tile."""
    calls = []

    def record(a, b, **kw):
        calls.append((a.shape[-2], b.shape[-1], a.shape[-1], kw, a.dtype, b.dtype))
        return torch.empty(a.shape[-2], b.shape[-1], dtype=kw["out_dtype"], device=a.device)

    m = 2 * 2048
    for k, n in _mesh_paper_gemms():
        meta = dict(dtype=torch.bfloat16, device="meta")
        g, a, b = torch.empty(m, n, **meta), torch.empty(m, k, **meta), torch.empty(k, n, **meta)
        opts = api.MMOpts(128, 128, 128, True, False, torch.bfloat16, activation)
        api.mm_backward(g, a, b, torch.empty(n, **meta), None, opts, matmul=record)
    assert len(calls) == 4 * (3 if activation else 2)
    for mm, nn, kk, kw, da, db in calls:
        assert da == db == torch.float32
        tile = tile_config(mm, nn, kk, kw["block_m"], kw["block_n"], kw["block_k"], da)
        assert tile == "f32_128", (mm, kk, nn, kw)


@pytest.mark.parametrize("m", [1, 4, 8, 16])
def test_decode_rows_take_the_decode_tile(m):
    for k, n in _mesh_paper_gemms():
        assert tile_config(m, n, k, 128, 128, 128, torch.bfloat16) == "tc_decode", (m, k, n)


def test_olmoe_kernel_path_gemms_take_new_tiles():
    # OLMoE-1B-7B on the kernel path runs K1 for its attention projections
    # and lm_head (vocab 50304, a multiple of 8).
    cfg = get_config("olmoe-1b-7b")
    d = cfg.d_model
    for k, n in [(d, cfg.num_heads * cfg.head_dim_), (cfg.num_heads * cfg.head_dim_, d),
                 (d, cfg.vocab_size)]:
        assert tile_config(128, n, k, 128, 128, 128, torch.bfloat16) == "tc128"
        assert tile_config(4, n, k, 128, 128, 128, torch.bfloat16) == "tc_decode"


# chip_smoke's kernel-path phases of the other families: (prefill batch, the
# decode step's rows).  RWKV-6 serves 128-token prompts on 4 slots, Zamba2
# 2 x 2048-token prompts, Whisper 2 x 2048 frames and 2 x 256 tokens.
OTHER_FAMILIES = {
    "rwkv6-1.6b": (lambda cfg: {"tokens": torch.zeros(1, 128, dtype=torch.int32)}, 4),
    "zamba2-1.2b": (lambda cfg: {"tokens": torch.zeros(2, 2048, dtype=torch.int32)}, 2),
    "whisper-medium": (lambda cfg: {"frames": torch.zeros(2, 2048, cfg.d_model),
                                    "tokens": torch.zeros(2, 256, dtype=torch.int32)}, 2),
}


@pytest.mark.parametrize("arch", sorted(OTHER_FAMILIES))
def test_other_families_kernel_path_gemms_take_new_tiles(arch, monkeypatch):
    """Every GEMM the full-width prefill and decode step run on K1, recorded
    on meta tensors (no product is computed), takes the tensor-core tile:
    the prefill's the 128-wide one, the decode step's the decode tile, the
    ragged N of Zamba2's in_proj (8384) and of Whisper's padded head (51968)
    included."""
    import dataclasses

    from repro_torch.kernels.mesh_matmul import kernel_n
    from repro_torch.models import attention, get_model

    rows, products = [], []

    def plan(spec, *, backend=None, device=None, **_):
        def run(a, b, bias=None, residual=None):
            products.append((rows[-1], a.numel() // a.shape[-1], spec.k, spec.n,
                             spec.epilogue.activation, backend))
            return torch.empty(*a.shape[:-1], spec.n, dtype=a.dtype, device=a.device)
        return run

    monkeypatch.setattr(api, "plan", plan)
    monkeypatch.setattr(attention, "flash_attention",
                        lambda q, k, v, **_: torch.empty_like(q))
    cfg = dataclasses.replace(get_config(arch).tuned(), use_mesh_kernel=True)
    batch_of, slots = OTHER_FAMILIES[arch]
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "meta")
    with torch.inference_mode():
        rows.append("prefill")
        batch = {k: v.to("meta") for k, v in batch_of(cfg).items()}
        _, state = model.prefill(params, batch)
        if arch == "rwkv6-1.6b":  # the server's stacked state of 4 slots
            state = {k: v.expand(v.shape[0], slots, *v.shape[2:]) for k, v in state.items()}
        rows.append("decode")
        tokens = torch.zeros(slots, 1, dtype=torch.int32, device="meta")
        model.decode(params, tokens, state, 0)
    acts = {p[4] for p in products}
    assert {p[5] for p in products} == {"cuda_mesh"}
    assert (acts == {None, "silu", "relu", "sigmoid"}) == (arch == "rwkv6-1.6b"), acts
    assert {p[0] for p in products} == {"prefill", "decode"}
    # A decode step's rows are the slots, but for Whisper's cross K/V,
    # recomputed from the 2 x 2048 encoder frames every step.
    cross = {2 * 2048} if arch == "whisper-medium" else set()
    for phase, m, k, n, _, _ in products:
        assert m in ({slots} | cross if phase == "decode" else {128, 512, 4096}), (phase, m)
        want = "tc_decode" if m <= 16 else "tc128"
        got = tile_config(m, kernel_n(n, 128, torch.bfloat16), k, 128, 128, 128, torch.bfloat16)
        assert got == want, (phase, m, k, n)


@pytest.mark.parametrize(
    "m,n,k,blocks,dtype,want",
    [
        (32, 32, 64, (8, 8, 16), torch.float32, "simt64"),
        (40, 72, 96, (16, 16, 32), torch.float32, "simt64"),
        (24, 56, 40, (16, 16, 16), torch.bfloat16, "simt64"),
        (4, 384, 256, (8, 8, 16), torch.bfloat16, "simt_decode"),
        (8, 8, 8, (8, 8, 8), torch.float32, "simt_decode"),  # the server's warmup canary
        (128, 200, 2004, (128, 128, 128), torch.bfloat16, "simt64"),  # K not in 16-byte rows
        (128, 512, 512, (128, 128, 16), torch.bfloat16, "simt64"),  # k block under the k step
        (200, 200, 2008, (128, 128, 128), torch.bfloat16, "tc128"),
        (200, 196, 2004, (128, 128, 128), torch.float32, "f32_128"),
        (4, 256, 384, (128, 128, 128), torch.float32, "f32_128"),
    ],
)
def test_narrow_or_unaligned_blocks_keep_the_first_tiles(m, n, k, blocks, dtype, want):
    got = tile_config(m, n, k, *blocks, dtype)
    assert got == want and got in TILE_CONFIGS
