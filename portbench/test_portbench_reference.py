"""The frozen reference against the port at the port's tiny sizes on the
CPU (float32): prefill and paged-decode logits, dense and with experts,
and the training loss and gradients.  It shows the reference is the same
model the port runs; the reference itself imports nothing of the port."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from portbench.harness import check, spec  # noqa: E402
from portbench.harness.weights import make_params  # noqa: E402
from portbench.reference import model as ref  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ("qwen2-7b", "olmoe-1b-7b.pp4")


def tiny(name):
    from repro_torch.models import get_model

    raw = json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())
    cfg = spec.arch_config(raw, reduced=True)
    model = get_model(cfg)
    return cfg, model, make_params(model.specs(), cfg, 1234, "cpu")


@pytest.mark.parametrize("name", CONFIGS)
def test_prefill_and_paged_decode_logits(name):
    cfg, model, params = tiny(name)
    g = torch.Generator().manual_seed(5)
    t, steps, page = 21, 6, 4
    seq = torch.randint(0, cfg.vocab_size, (t + steps,), generator=g, dtype=torch.int32)
    with torch.no_grad():
        logits, caches = model.prefill(params, {"tokens": seq[None, :t], "labels": seq[None, :t]})
        n_pages = -(-(t + steps) // page)
        pools = {k: torch.zeros(shape, dtype=dt) for k, (shape, dt)
                 in model.paged_pool_specs(1 + n_pages, page).items()}
        for k in ("k", "v"):
            c = torch.nn.functional.pad(caches[k][:, 0], (0, 0, 0, 0, 0, n_pages * page - t))
            pools[k][:, 1:] = c.reshape(cfg.num_layers, n_pages, page, *c.shape[2:])
        table = torch.arange(1, 1 + n_pages, dtype=torch.int32)[None]
        decoded = []
        for j in range(steps):
            lg, pools = model.paged_decode(params, seq[None, t + j:t + j + 1], pools, table,
                                           torch.tensor([t + j], dtype=torch.int32))
            decoded.append(lg[0, -1])
    want = ref.served_logits(params, cfg, [seq.long()], [(0, t + steps)])[0]
    got = torch.cat([logits[0].float(), torch.stack(decoded).float()])
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 2e-5 * scale


@pytest.mark.parametrize("name", CONFIGS)
def test_training_loss_and_gradients(name):
    cfg, model, params = tiny(name)
    g = torch.Generator().manual_seed(6)
    x = torch.randint(0, cfg.vocab_size, (2, 33), generator=g, dtype=torch.int32)
    batch = {"tokens": x[:, :-1], "labels": x[:, 1:]}
    port = {p: v.clone().requires_grad_(True) for p, v in check.flat(params).items()}
    mine = {p: v.clone().requires_grad_(True) for p, v in check.flat(params).items()}
    with torch.enable_grad():
        lp, _ = model.loss(check.unflat(port), batch)
        gp = torch.autograd.grad(lp, list(port.values()))
        lr_ = ref.loss(check.unflat(mine), batch, cfg)
        gr = torch.autograd.grad(lr_, list(mine.values()))
    assert float(lp.detach()) == pytest.approx(float(lr_.detach()), rel=1e-6)
    for path, a, b in zip(port, gp, gr):
        assert float((a - b).norm()) <= 1e-4 * float(b.norm()) + 1e-9, path


def test_reference_imports_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, 'src'); import portbench.reference.model;"
            " print(sorted({m.split('.')[0] for m in sys.modules}"
            " & {'repro_torch', 'repro', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in ("repro_torch", "repro", "jax"), (path, name)
