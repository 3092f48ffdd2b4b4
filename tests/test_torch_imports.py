"""Import hygiene of the port, checked in fresh interpreters.

`repro_torch` must import neither `jax` nor anything of the reference
package `repro`; this test process cannot tell (tests/conftest.py imports
jax), so each check runs in a subprocess.  The entry points must refuse to
run on the CPU unless asked: with CUDA reported absent, calling them without
a device raises.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"


def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=300
    )


def test_port_imports_neither_jax_nor_reference():
    code = """
import importlib, pkgutil, sys
import repro_torch
names = sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."))
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(len(names), "modules")
print("BAD", bad)
print("WALKED", " ".join(names))
"""
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout
    assert int(res.stdout.split()[0]) >= 20  # every module was walked
    walked = res.stdout.split("WALKED")[1].split()
    for name in ("optim.adamw", "optim.schedules", "data.pipeline", "train.train_step",
                 "train.loop", "train.metrics", "checkpoint.manager", "launch.train",
                 "kernels.scramble", "kernels.ops", "kernels.grouped", "models.moe",
                 "configs.olmoe_1b_7b", "kernels.flash_attention", "configs.qwen2_7b",
                 "obs.trace", "obs.metrics", "obs.export", "obs.bridge", "costmodel.model",
                 "costmodel.calibrate", "costmodel.choose", "kernels.autotune",
                 "launch.roofline", "launch.hillclimb", "models.rwkv", "models.ssm",
                 "models.vlm", "models.whisper", "configs.rwkv6_1b6", "configs.zamba2_1b2",
                 "configs.pixtral_12b", "configs.whisper_medium", "parallel",
                 "parallel.collectives", "parallel.systolic", "parallel.sharding",
                 "launch.mesh", "parallel.compression", "parallel.pipeline", "optim.zero",
                 "launch.dryrun", "launch.hlo_stats"):
        assert "repro_torch." + name in walked, name


def test_entry_points_refuse_cpu_without_device():
    code = """
import torch
torch.cuda.is_available = lambda: False  # a machine with no CUDA card
from repro_torch.configs import get_config
from repro_torch.launch import hillclimb, serve, train
from repro_torch.launch.scheduler import ContinuousBatchingServer, ServeConfig
from repro_torch.models import get_model
model = get_model(get_config("mesh-paper").reduced())
moe = get_model(get_config("olmoe-1b-7b").reduced())
qwen = get_model(get_config("qwen2-7b").reduced())
rwkv = get_model(get_config("rwkv6-1.6b").reduced())
pixtral = get_model(get_config("pixtral-12b").reduced())
calls = {
    "init": lambda: model.init(torch.Generator()),
    "init moe": lambda: moe.init(torch.Generator()),
    "init qwen": lambda: qwen.init(torch.Generator()),
    "server moe": lambda: ContinuousBatchingServer(moe, None, ServeConfig()),
    "server qwen": lambda: ContinuousBatchingServer(qwen, None, ServeConfig()),
    "server": lambda: ContinuousBatchingServer(model, None, ServeConfig()),
    "main": lambda: serve.main(["--arch", "mesh-paper", "--reduced"]),
    "train": lambda: train.main(["--arch", "mesh-paper", "--reduced", "--steps", "1"]),
    "hillclimb": lambda: hillclimb.main(["--gemm"]),
    "init rwkv": lambda: rwkv.init(torch.Generator()),
    "server rwkv": lambda: ContinuousBatchingServer(rwkv, None, ServeConfig()),
    "server pixtral": lambda: ContinuousBatchingServer(pixtral, None, ServeConfig()),
    "main zamba": lambda: serve.main(["--arch", "zamba2-1.2b", "--reduced"]),
    "train rwkv": lambda: train.main(["--arch", "rwkv6-1.6b", "--reduced", "--steps", "1"]),
}
for name, call in calls.items():
    try:
        call()
    except RuntimeError as e:
        assert "CUDA" in str(e), e
        print("refused", name)
    else:
        print("RAN", name)
train.main(["--arch", "mesh-paper", "--reduced", "--device", "cpu", "--steps", "1",
            "--batch", "2", "--seq", "8"])
"""
    res = _run(code)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.split("\n")
    assert lines[:14] == ["refused init", "refused init moe", "refused init qwen",
                          "refused server moe", "refused server qwen", "refused server",
                          "refused main", "refused train", "refused hillclimb",
                          "refused init rwkv", "refused server rwkv",
                          "refused server pixtral", "refused main zamba",
                          "refused train rwkv"], res.stdout
    assert "[done] mesh-paper steps=1" in res.stdout and "device=cpu" in res.stdout


def test_kernel_layer_imports_no_model_module():
    """The kernels (and their plain versions) sit below the models: importing
    every `repro_torch.kernels` module loads nothing of `repro_torch.models`."""
    code = """
import importlib, pkgutil, sys
import repro_torch.kernels as kernels
names = sorted(m.name for m in pkgutil.walk_packages(kernels.__path__, "repro_torch.kernels."))
for name in names:
    importlib.import_module(name)
print(len(names), "kernel modules")
print("MODELS", sorted(m for m in sys.modules if m.startswith("repro_torch.models")))
"""
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[0]) >= 8, res.stdout  # every kernel module was walked
    assert "MODELS []" in res.stdout, res.stdout
