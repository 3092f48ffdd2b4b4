"""The port's hillclimb cells (`repro_torch.launch.hillclimb`: `CELLS`,
`run_variant`, `--cell`) against the reference's.

`CELLS` is read from the reference in a subprocess (its module sets
`XLA_FLAGS` when it is imported) and held equal to the port's: every
cell's arch and shape, its variant names in order, and each variant's
config overrides, sharding rules and parameter rules (their tables) and
remat.  Two cheap Granite-3 8B variants run through `run_variant`, the
port's dry run on a "fake" 256-rank group: C0 (the untuned layout) and C5
('seq_sp' + FSDP with `grad_accum` 8, a config field); each writes an
artifact with status "ok" that `roofline.analyze_artifact` reads.  Cell
D's untuned RWKV-6 variant (the per-token WKV scan, minutes) is not run.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import hillclimb, roofline  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

_REFERENCE = r"""
import json
from repro.launch import hillclimb as h
def rules(r):
    return None if r is None else [[k, list(v) if isinstance(v, tuple) else v] for k, v in r.table]
print("CELLS " + json.dumps({c: {"arch": s["arch"], "shape": s["shape"], "variants": [
    [n, v.get("cfg"), rules(v.get("rules")), rules(v.get("param_rules")), v.get("remat")]
    for n, v in s["variants"].items()]} for c, s in h.CELLS.items()}))
"""


def _rules(r):
    return None if r is None else [[k, list(v) if isinstance(v, tuple) else v]
                                   for k, v in r.table]


def test_cells_equal_the_reference():
    pytest.importorskip("jax")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", _REFERENCE], capture_output=True, text=True,
                         env=env, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    line = next(s for s in res.stdout.splitlines() if s.startswith("CELLS "))
    want = json.loads(line[len("CELLS "):])
    got = {c: {"arch": s["arch"], "shape": s["shape"], "variants": [
        [n, v.get("cfg"), _rules(v.get("rules")), _rules(v.get("param_rules")), v.get("remat")]
        for n, v in s["variants"].items()]} for c, s in hillclimb.CELLS.items()}
    assert json.loads(json.dumps(got)) == want


@pytest.mark.parametrize("variant", ["C0_baseline", "C5_fit_ga8"])
def test_run_variant_writes_an_ok_artifact(tmp_path, variant):
    art, row = hillclimb.run_variant("C", variant, str(tmp_path))
    saved = json.loads((tmp_path / f"C__{variant}.json").read_text())
    assert saved["status"] == "ok" and saved["variant"] == variant
    assert saved["arch"] == "granite-3-8b" and saved["shape"] == "train_4k"
    assert roofline.analyze_artifact(saved) == row
    assert row["dominant"] in ("compute", "memory", "collective")
    assert "probe" in saved and saved["flops_per_device_corrected"] > 0
    if variant == "C5_fit_ga8":
        # 'seq_sp' gathers its carriers; FSDP keeps the state a (data x model)
        # block; 8 microbatches bound the activations: under 80 GB a rank,
        # where the untuned cell is not.
        assert saved["collectives"]["all-gather"]["count"] > 0
        ma = saved["memory_analysis"]
        assert ma["argument_size_in_bytes"] + ma["temp_size_in_bytes"] < 80e9


def test_cli_runs_one_cell_variant(tmp_path, capsys):
    hillclimb.main(["--cell", "C", "--variant", "C0_baseline", "--out", str(tmp_path)])
    assert "C0_baseline" in capsys.readouterr().out
    assert json.loads((tmp_path / "C__C0_baseline.json").read_text())["status"] == "ok"
