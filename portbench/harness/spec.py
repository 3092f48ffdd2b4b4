"""Find a cell's pieces by name: `BENCHMARK.json`, the configuration's file,
the traffic mix's file and the per-layer metrics' readers.

Nothing here knows a particular cell.  A cell names a configuration and a
mix; the configuration's entry in `BENCHMARK.json` names its file; the mix
is `portbench/traffic/<mix>.json`; a per-layer metric is
`portbench/metrics/<metric>.py`.  So a later cell, mix or metric is a new
file and a new entry, and no edit of this module.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]
    mix: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]

    @property
    def kind(self) -> str:
        """'serve' or 'train': which driver runs the mix."""
        return self.mix["kind"]


def load_benchmark(root: Path = ROOT) -> Dict[str, Any]:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of `root/BENCHMARK.json` with its files read."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    mix = json.loads((root / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if m["moves"] in reported and _applies(m, name)]
    return Cell(name=name, chips=int(w["chips"]), config=config, mix=mix, end_to_end=e2e,
                per_layer=per_layer)


def metric_reader(name: str, root: Path = ROOT) -> ModuleType:
    """`portbench/metrics/<name>.py`, loaded by path (its name may hold dots)."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def arch_config(config: Dict[str, Any], *, reduced: bool = False):
    """The port's `ArchConfig` the configuration's file names, with its
    overrides.  Every published width the file maps onto a field
    (`port.widths`: field -> published key) must equal the port's value,
    so no override or later change of the port can cut a width unseen.
    `reduced=True` (CPU tests) takes the port's tiny variant instead and
    skips that check."""
    from repro_torch.configs import get_config

    port = config["port"]
    cfg = get_config(port["arch_id"])
    if reduced:
        cfg = cfg.reduced()
        over = {k: v for k, v in port["overrides"].items()
                if k not in ("num_layers", "param_dtype", "activation_dtype")}
        return dataclasses.replace(cfg, **over)
    cfg = dataclasses.replace(cfg, **port["overrides"])
    for field, key in port["widths"].items():
        got = getattr(cfg, field)
        if got != config[key]:
            raise ValueError(f"config {port['arch_id']}: {field}={got} but {key}={config[key]}")
    return cfg


def find_peaks(device_name: str, root: Path = ROOT) -> Optional[Dict[str, float]]:
    """The data sheet's peaks of the card named `device_name`, or None."""
    table = json.loads((root / "portbench" / "harness" / "peaks.json").read_text())
    for entry in table["cards"]:
        if entry["match"] in device_name:
            return entry
    return None
