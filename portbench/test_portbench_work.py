"""The yardstick's operations and bytes against counts made by hand."""

import dataclasses
import json
from pathlib import Path

import pytest

pytest.importorskip("torch")

from portbench.harness import spec, work  # noqa: E402

PEAKS = {"bf16_flops_per_s": 989e12, "hbm_bytes_per_s": 3.35e12}
ROOT = Path(__file__).resolve().parents[1]


def config(name):
    return spec.arch_config(json.loads((ROOT / "portbench" / "configs" / f"{name}.json")
                                       .read_text()))


def test_gemm_counts():
    assert work.gemm_flops(2, 3, 5) == 60
    assert work.gemm_bytes(2, 3, 5) == 2 * (6 + 15 + 10)
    assert work.gemm_bytes(2, 3, 5, bias=True) == 2 * (6 + 15 + 10 + 5)
    # 4096^3: compute-bound; a 1-row product: byte-bound
    assert work.bound_s(2 * 4096**3, 3 * 2 * 4096**2, PEAKS) == pytest.approx(2 * 4096**3 / 989e12)
    assert work.bound_s(2 * 4096**2, 2 * 4096**2, PEAKS) == pytest.approx(2 * 4096**2 / 3.35e12)


def test_qwen2_stage_counts():
    cfg = config("qwen2-7b.pp4")
    # per layer: q 3584^2, k and v 3584 x 512, o 3584^2, gate|up 3584 x 37888,
    # down 18944 x 3584: 233.0M
    layer = 2 * 3584**2 + 2 * 3584 * 512 + 3584 * 37888 + 18944 * 3584
    assert sum(k * n for _, k, n, _ in work.layer_products(cfg)) == layer == 233_046_016
    assert work.product_params(cfg) == 7 * layer + 3584 * 152064
    t = 4096
    attn = 7 * 4 * 28 * 128 * (t * (t + 1) // 2)
    assert work.attention_flops(cfg, t) == attn
    step = 6 * (7 * layer + 3584 * 152064) * 2 * t + 3 * 2 * attn
    assert work.train_step_flops(cfg, 2, t) == step
    assert step / (2 * t) / 1e9 == pytest.approx(13.68, abs=0.01)  # GFLOP a token
    assert work.k1_launches_train(cfg) == 3 * (7 * 6 + 1)


def test_olmoe_stage_counts():
    cfg = config("olmoe-1b-7b.pp4")
    attn = 4 * 2048**2
    experts = 8 * 3 * 2048 * 1024
    assert work.product_params(cfg) == 4 * (attn + experts + 2048 * 64) + 2048 * 50304
    per_token = work.train_step_flops(cfg, 4, 4096) / (4 * 4096) / 1e9
    assert per_token == pytest.approx(2.43, abs=0.01)
    assert work.k1_launches_train(cfg) == 3 * (4 * 4 + 1)
    assert work.k5_launches_train(cfg) == 3 * 4 * 2
    pairs = 4 * 4096 * 8
    fwd = sum(max(2 * pairs * k * n / 989e12, 2 * (pairs * k + 64 * k * n + pairs * n) / 3.35e12)
              for k, n in ((2048, 2048), (1024, 2048)))
    assert work.grouped_bound_s(cfg, pairs, PEAKS, backward=True) == pytest.approx(4 * 3 * fwd)


def test_serving_work():
    cfg = config("qwen2-7b")
    layers = work.product_params(cfg) - 3584 * 152064
    t = 1344
    assert work.prefill_flops(cfg, t) == (2 * layers * t + work.attention_flops(cfg, t)
                                          + 2 * 3584 * 152064)
    assert work.decode_flops(cfg, 2000) == 2 * work.product_params(cfg) + 28 * 4 * 28 * 128 * 2000
    # one decode tick of 5 slots: each product's weights read once
    rows = work.serve_k1_products(cfg, [], [5])
    assert len(rows) == 28 * 6 + 1 and rows[-1] == (5, 3584, 152064, False)
    weights = sum(k * n for _, k, n, _ in rows)
    assert work.products_bound_s(rows, PEAKS) >= 2 * weights / 3.35e12
    assert work.causal_keys(3, 2) == 3 + 4 + 5


def test_widths_are_checked():
    raw = json.loads((ROOT / "portbench" / "configs" / "qwen2-7b.json").read_text())
    raw["port"]["overrides"]["d_ff"] = 1024
    with pytest.raises(ValueError, match="d_ff"):
        spec.arch_config(raw)
    assert dataclasses.replace(config("qwen2-7b"), d_ff=1).d_ff == 1
