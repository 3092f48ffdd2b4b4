"""A whole run at the port's tiny sizes on the CPU, in a copy of the
benchmark with tiny cells (the serving cell and the two held training
cells of `held_cells.json`): the last line's format, a new configuration,
mix and metric picked up with no edit, the guard against JAX, and
`correct` coming out false under each fault a cell can have (serving: a
token altered where it is produced, a decode step whose cache writes are
lost, half of the slots left out; training: a step that returns its state
unchanged, half of the batch left out, the mean taken over the rest) and
under the control (the reference at float8 in the program's place).  The
tiny cells hold the CPU's float32 program to tight limits; the chip's
limits and their readings are in PERF.md."""

import copy
import json
import shutil
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from portbench.harness import check, result, spec, train, traffic  # noqa: E402
from portbench.run import run_cell  # noqa: E402

PB = Path(__file__).resolve().parent
REAL = {"qwen2-7b.serve.rag": "t.serve", "olmoe-1b-7b.train.seq4k": "t.moe",
        "qwen2-7b.train.seq4k": "t.dense"}
TINY_RAG = {"kind": "serve", "why": "tiny", "arrivals": {"process": "poisson", "rate_per_s": 6.0},
            "schedule_seed": 3,
            "prompt": [{"part": "shared", "tokens": 8},
                       {"part": "corpus", "tokens": 8, "count": [1, 3], "corpus_size": 16},
                       {"part": "distinct", "tokens": 4}],
            "answer_tokens": [8, 16], "decoding": "greedy"}
TINY_TRAIN = {"kind": "train", "why": "tiny", "seq_len": 32}


def make_root(tmp_path) -> Path:
    """A checkout's copy of the benchmark whose cells are tiny."""
    root = tmp_path / "root"
    shutil.copytree(PB, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "test_*"))
    bench = json.loads((PB.parent / "BENCHMARK.json").read_text())
    held = json.loads((PB / "held_cells.json").read_text())
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        bench[key] += held[key]
    for w in bench["workloads"]:
        w["name"] = REAL[w["name"]]
        w["traffic"] = "tiny_rag" if w["traffic"] == "rag" else "tiny_train"
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [REAL[x] for x in m["workloads"]]
    for c in bench["configs"]:
        raw = json.loads((PB.parent / c["file"]).read_text())
        if "serve" in raw:
            longest = traffic.longest_request(TINY_RAG)
            pages = -(-longest // 4) + 1
            raw["serve"].update(max_slots=4, page_size=4, max_pages_per_seq=pages,
                                num_pages=1 + 4 * pages)
            # every served request compared, wherever the window's timing put it
            raw["correct"] = {"served_token_gap": 1e-3, "sample_tokens": 10**6}
        else:
            raw["correct"] = {"loss_rel_gap": 1e-4, "grad_norm_gap": 1e-4,
                              "change_norm_gap": 1e-4}
        (root / c["file"]).write_text(json.dumps(raw))
    (root / "portbench" / "traffic" / "tiny_rag.json").write_text(json.dumps(TINY_RAG))
    (root / "portbench" / "traffic" / "tiny_train.json").write_text(json.dumps(TINY_TRAIN))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run(root, cell, trace=False, seed=2**31 + 7, seconds=1.5, **faults):
    return run_cell(cell, seed, seconds, trace, root=root, device="cpu", reduced=True,
                    t_start=time.monotonic(), **faults)


def test_last_line_and_checks_format(tmp_path, capsys):
    root = make_root(tmp_path)
    got = run(root, "t.serve")
    assert got["correct"] is True and got["failed"] == 0 and got["attempted"] >= 5
    got.pop("_extra")
    # the line's format alone: a test process may hold JAX from other tests
    assert result.emit(got, modules=()) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(line["metrics"]) == {"ttft_p90_ms", "itl_p95_ms", "setup_s"}
    assert all(set(m) == {"value", "unit"} and m["value"] > 0 for m in line["metrics"].values())
    assert line["metrics"]["ttft_p90_ms"]["unit"] == "ms"
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert line["checks"]["served_token_gap"]["limit"] == 1e-3
    tail = err.strip().splitlines()[-2:]
    assert all(t.startswith("check ") and "limit" in t for t in tail)


def test_new_config_mix_and_metric_are_picked_up(tmp_path):
    root = make_root(tmp_path)
    pb = root / "portbench"
    raw = json.loads((pb / "configs" / "qwen2-7b.json").read_text())
    (pb / "configs" / "qwen2-7b.new.json").write_text(json.dumps(raw))
    (pb / "traffic" / "tiny_burst.json").write_text(
        json.dumps(dict(TINY_RAG, arrivals={"process": "poisson", "rate_per_s": 4.0})))
    (pb / "metrics" / "ticks_seen.serve.py").write_text(
        "def read(run):\n    return float(len(run.tick_end)) or None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="qwen2-7b.new",
                                 file="portbench/configs/qwen2-7b.new.json"))
    bench["workloads"].append({"name": "t.new", "config": "qwen2-7b.new",
                               "traffic": "tiny_burst", "chips": 1, "why": "new"})
    bench["per_layer"].append({"name": "ticks_seen.serve", "unit": "ticks", "better": "higher",
                               "source": "program_span", "layer": "scheduler",
                               "moves": "ttft_p90_ms", "workloads": ["t.new"]})
    for m in bench["end_to_end"]:
        if m["name"] in ("ttft_p90_ms", "itl_p95_ms"):
            m["workloads"].append("t.new")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.resolve_cell("t.new", root)
    assert cell.mix["arrivals"]["rate_per_s"] == 4.0
    assert [m["name"] for m in cell.per_layer][-1] == "ticks_seen.serve"
    got = run(root, "t.new", trace=True)
    assert got["metrics"]["ticks_seen.serve"]["value"] > 0
    assert got["metrics"]["ticks_seen.serve"]["unit"] == "ticks"
    assert got["correct"] is True


def test_guard_compares_whole_top_level_names(capsys):
    assert result.emit({"checks": {}}, modules=["jax.numpy", "torch"]) == 1
    out, err = capsys.readouterr()
    assert out == "" and "jax" in err
    assert result.forbidden_modules(["jax.numpy", "repro_torch.models", "repro", "jaxtyping",
                                     "repro.kernels", "flax.linen", "os"]) == [
        "flax", "jax", "repro"]
    assert result.forbidden_modules(["repro_torch", "reprox", "torch"]) == []


def tokens_altered(server):
    """Every decode step's tokens altered where they are produced."""
    inner = server._decode

    def decode(tokens, tables, positions):
        nxt, state = inner(tokens, tables, positions)
        return (nxt + 1) % server.model.cfg.vocab_size, state

    server._decode = decode


def state_unchanged(server):
    """Every decode step's writes to the KV pools lost."""
    inner = server.model.paged_decode

    def paged_decode(params, tokens, pools, *args, **kw):
        return inner(params, tokens, {k: v.clone() for k, v in pools.items()}, *args, **kw)

    server.model.paged_decode = paged_decode


def half_of_slots(server):
    """Every decode step's first half of the slots left out (fed token 0)."""
    inner = server.model.paged_decode

    def paged_decode(params, tokens, *args, **kw):
        tokens = tokens.clone()
        tokens[:tokens.shape[0] // 2] = 0
        return inner(params, tokens, *args, **kw)

    server.model.paged_decode = paged_decode


@pytest.mark.parametrize("fault", [tokens_altered, state_unchanged, half_of_slots])
def test_serving_faults_fail(tmp_path, fault):
    root = make_root(tmp_path)
    got = run(root, "t.serve", fault=fault)
    assert got["correct"] is False
    assert got["checks"]["served_token_gap"]["value"] > 1e-3


def test_control_fails_serving(tmp_path):
    root = make_root(tmp_path)
    got = run(root, "t.serve")
    extra = got["_extra"]
    cfg = spec.arch_config(spec.resolve_cell("t.serve", root).config, reduced=True)
    gap, n = check.served_token_gap(extra["params"], cfg, extra["samples"], control=True)
    assert n > 0 and gap > got["checks"]["served_token_gap"]["limit"]


def unchanged(step_fn):
    def step(state, batch):
        frozen = copy.deepcopy(state)
        _, metrics = step_fn(state, batch)
        return frozen, metrics

    return step


def half_batch(step_fn):
    def step(state, batch):
        rows = batch["tokens"].shape[0] // 2
        return step_fn(state, {k: v[:rows] for k, v in batch.items()})

    return step


@pytest.mark.parametrize("cell", ["t.moe", "t.dense"])
def test_training_faults_and_control_fail(tmp_path, cell):
    root = make_root(tmp_path)
    assert run(root, cell, seconds=0.5)["correct"] is True
    for fault in (unchanged, half_batch):
        got = run(root, cell, seconds=0.5, fault=fault)
        assert got["correct"] is False, fault.__name__
    c = spec.resolve_cell(cell, root)
    cfg = spec.arch_config(c.config, reduced=True)
    seeds = traffic.Seeds.of(2**31 + 7)
    refr = train.reference_readings(c, cfg, seeds, "cpu")
    control = check.train_numbers(train.reference_readings(c, cfg, seeds, "cpu", fp8=True), refr)
    assert any(v > c.config["correct"][k] for k, v in control.items())
