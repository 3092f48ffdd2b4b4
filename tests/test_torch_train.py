"""Port parity of the training slice: reduced mesh-paper, end to end.

The JAX reference initializes parameters and train states; `interop`
carries them into the port, and both packages train on the same numpy
batches.  The reference's Pallas kernels run in interpret mode, as its own
tests run them.

  * the mesh GEMM's gradients (the `_mm` custom VJP) agree within
    atol = rtol = 1e-5 (f32: the GEMM k order and reduction orders differ);
  * softmax_xent, warmup_cosine and AdamW agree within 1e-6 in f32 and
    within one bf16 ulp for bf16 parameters (the update is cast once);
  * `SyntheticLM` batches are equal bitwise;
  * lm_forward logits agree within 1e-5, also where the scramble fires;
  * the loss and grad norm of three train steps agree within 1e-4;
  * checkpoints cross between the two packages bit for bit.

The port's own fault-tolerance contract (quarantine, crash resume, CLI) is
tested on the port alone.
"""

import dataclasses
import io
import os
import types
from contextlib import redirect_stdout

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.checkpoint import CheckpointManager, CorruptCheckpointError  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.interop import (  # noqa: E402
    params_from_numpy,
    train_state_from_numpy,
    train_state_to_numpy,
)
from repro_torch.kernels import api  # noqa: E402
from repro_torch.kernels.mesh_matmul import mesh_matmul, mesh_matmul_torch  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.layers import softmax_xent  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, warmup_cosine  # noqa: E402
from repro_torch.resilience import ledger  # noqa: E402
from repro_torch.train.loop import LoopConfig, train_loop  # noqa: E402
from repro_torch.train.metrics import MetricsLogger  # noqa: E402
from repro_torch.train.train_step import init_train_state, make_train_step  # noqa: E402
from repro_torch.tree import tree_paths  # noqa: E402

F32 = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def jx():
    """The JAX reference, imported when a test needs it."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.checkpoint.manager import CheckpointManager as JCkpt
    from repro.configs import get_config as get_cfg
    from repro.data.pipeline import DataConfig as JData
    from repro.data.pipeline import SyntheticLM as JSynth
    from repro.kernels import api as japi
    from repro.models import get_model as get_mdl
    from repro.models.layers import softmax_xent as jxent
    from repro.optim import adamw as jadamw
    from repro.optim.schedules import warmup_cosine as jcos
    from repro.train import train_step as jstep

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, Ckpt=JCkpt, get_config=get_cfg, Data=JData, Synth=JSynth,
        api=japi, get_model=get_mdl, xent=jxent, adamw=jadamw, cos=jcos, step=jstep,
    )


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the GPU machine")
    return torch.device("cuda")


def _np(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# -- the mesh GEMM's backward (api._mm VJP) ------------------------------------

MM_CASES = {
    "plain": dict(m=24, k=40, n=16),
    "bias+gelu+residual": dict(m=24, k=40, n=16, bias=True, act="gelu", residual=True),
    "scrambled": dict(m=24, k=16, n=24, bias=True, act="silu", residual=True, scramble=True),
}


@pytest.mark.parametrize("case", list(MM_CASES))
def test_mesh_gemm_grads_match_jax_mm_vjp(jx, case):
    c = dict(MM_CASES[case])
    m, k, n = c.pop("m"), c.pop("k"), c.pop("n")
    bias, act, residual, scramble = (c.get("bias", False), c.get("act"),
                                     c.get("residual", False), c.get("scramble", False))
    blocks = (8, 8, 8)
    ins = {"a": _np((m, k), 1), "b": _np((k, n), 2)}
    if bias:
        ins["bias"] = _np((n,), 3)
    if residual:
        ins["residual"] = _np((m, n), 4)
    ct = _np((m, n), 5)

    opts = (*blocks, True, scramble, jx.jnp.float32, True, act)

    def jfun(d):
        return jx.api._mm(d["a"], d["b"], d.get("bias"), d.get("residual"), opts)

    y_j, vjp = jx.jax.vjp(jfun, {kk: jx.jnp.asarray(v) for kk, v in ins.items()})
    (grads_j,) = vjp(jx.jnp.asarray(ct))

    t = {kk: torch.from_numpy(v).requires_grad_(True) for kk, v in ins.items()}
    spec = api.GemmSpec.from_operands(
        t["a"], t["b"], structure="scrambled" if scramble else "general",
        epilogue=api.Epilogue(bias=bias, activation=act, residual=residual),
        out_dtype=torch.float32, blocks=blocks,
    )
    y = api.plan(spec, backend="cuda_mesh")(t["a"], t["b"], bias=t.get("bias"),
                                            residual=t.get("residual"))
    assert y.grad_fn is not None
    y.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), **F32)
    for name in ins:
        np.testing.assert_allclose(t[name].grad.numpy(), np.asarray(grads_j[name]), **F32,
                                   err_msg=name)


def test_mm_backward_takes_the_gemm_it_runs():
    """The plain backward with mesh_matmul_torch equals the Function's own."""
    a, b = torch.from_numpy(_np((16, 24), 6)), torch.from_numpy(_np((24, 16), 7))
    g = torch.from_numpy(_np((16, 16), 8))
    opts = api.MMOpts(8, 8, 8, True, True, torch.float32, "tanh")
    got = api.mm_backward(g, a, b, None, None, opts, matmul=mesh_matmul_torch)
    want = api.mm_backward(g, a, b, None, None, opts, matmul=mesh_matmul)
    for x, y in zip(got[:2], want[:2]):
        assert torch.equal(x, y)
    assert got[2] is None and got[3] is None


# -- loss, schedule, optimizer, data --------------------------------------------


def test_softmax_xent_matches_jax(jx):
    logits = _np((2, 16, 256), 9) * 3
    labels = np.random.default_rng(10).integers(0, 256, (2, 16)).astype(np.int32)
    lj, aj = jx.xent(jx.jnp.asarray(logits), jx.jnp.asarray(labels))
    lt, at = softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-6)
    assert float(at) == float(aj)


def test_warmup_cosine_matches_jax(jx):
    jfn, tfn = jx.cos(1e-3, 5, 20), warmup_cosine(1e-3, 5, 20)
    for s in range(0, 24):
        want = float(jfn(jx.jnp.asarray(s, jx.jnp.int32)))
        got = float(tfn(torch.tensor(s, dtype=torch.int32)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


def _bf16_within_one_ulp(got: np.ndarray, want: np.ndarray) -> None:
    got, want = got.astype(np.float32), want.astype(np.float32)
    mag = np.maximum(np.abs(want), np.finfo(np.float32).tiny)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    assert np.all(np.abs(got - want) <= ulp), np.max(np.abs(got - want) / ulp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_three_steps_match_jax(jx, dtype):
    shapes = {"w": (8, 16), "b": (16,), "blocks": {"x": (2, 4, 4)}}
    jdt = getattr(jx.jnp, dtype)
    leaves = lambda tree, seed: {  # noqa: E731
        k: leaves(v, seed + i) if isinstance(v, dict) else
        jx.jnp.asarray(_np(v, seed + i) * 0.5, dtype=jdt) for i, (k, v) in enumerate(tree.items())
    }
    jp = leaves(shapes, 20)
    jopt = jx.adamw.adamw_init(jp)
    tp = params_from_numpy(jx.jax.tree.map(np.asarray, jp), "cpu")
    topt = adamw_init(tp)
    cfg = AdamWConfig(clip_norm=1.0)
    for step in range(3):
        jg = leaves(shapes, 100 * (step + 1))
        tg = params_from_numpy(jx.jax.tree.map(np.asarray, jg), "cpu")
        lr = 1e-2 * (step + 1)
        jp, jopt, jn = jx.adamw.adamw_update(jg, jopt, jp, jx.jnp.float32(lr), cfg)
        tp, topt, tn = adamw_update(tg, topt, tp, torch.tensor(lr, dtype=torch.float32), cfg)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    got = dict(tree_paths(train_state_to_numpy(tp)))
    for key, want in tree_paths(jx.jax.tree.map(np.asarray, jp)):
        if dtype == "bfloat16":
            got[key] = got[key].view(want.dtype)
        if dtype == "float32":
            np.testing.assert_allclose(got[key], want, rtol=1e-6, atol=1e-7, err_msg=key)
        else:
            _bf16_within_one_ulp(got[key], want)
    for part in ("m", "v"):
        got = dict(tree_paths(train_state_to_numpy(topt[part])))
        for key, want in tree_paths(jx.jax.tree.map(np.asarray, jopt[part])):
            np.testing.assert_allclose(got[key], want, rtol=1e-6, atol=1e-9, err_msg=key)
    assert int(topt["count"]) == int(jopt["count"]) == 3


def test_synthetic_lm_batches_equal_bitwise(jx):
    kw = dict(vocab_size=1000, seq_len=33, global_batch=4, seed=7, num_hosts=2, host_id=1)
    ours, ref = SyntheticLM(DataConfig(**kw), step=5), jx.Synth(jx.Data(**kw), step=5)
    for _ in range(3):
        a, b = next(ours), next(ref)
        for key in ("tokens", "labels"):
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])
    assert ours.state() == ref.state() == 8


# -- model forward and train steps ----------------------------------------------


def _models(jx, **changes):
    jcfg = dataclasses.replace(jx.get_config("mesh-paper").reduced(), **changes)
    tcfg = dataclasses.replace(get_config("mesh-paper").reduced(), **changes)
    return jx.get_model(jcfg), get_model(tcfg)


def _batch(vocab, b, t, seed):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, 1)}


@pytest.mark.parametrize("changes,t", [
    ({}, 16),
    # T = D = 256: a 2x2 block grid, so the scramble fires (K3 forward).
    (dict(d_model=256, head_dim=64), 256),
])
def test_lm_forward_logits_match_jax(jx, changes, t):
    jm, tm = _models(jx, **changes)
    jp = jm.init(jx.jax.random.PRNGKey(0))
    tp = params_from_numpy(jx.jax.tree.map(np.asarray, jp), "cpu")
    batch = _batch(256, 2, t, 11)
    lj, _ = jm.forward(jp, {k: jx.jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        lt, aux = tm.forward(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **F32)
    assert float(aux["lb_loss"]) == 0.0


def test_scramble_fires_and_changes_logits():
    cfg_on = dataclasses.replace(get_config("mesh-paper").reduced(), d_model=256, head_dim=64)
    cfg_off = dataclasses.replace(cfg_on, scramble_privacy=False)
    params = get_model(cfg_on).init(torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(_batch(256, 2, 256, 12)["tokens"])
    with torch.no_grad():
        on, _ = get_model(cfg_on).forward(params, {"tokens": tokens})
        off, _ = get_model(cfg_off).forward(params, {"tokens": tokens})
    assert torch.isfinite(on).all()
    assert (on - off).abs().max() > 1e-4


def test_three_train_steps_match_jax(jx):
    jm, tm = _models(jx)
    assert tm.cfg.use_mesh_kernel and jm.cfg.use_mesh_kernel
    jstate = jx.step.init_train_state(jm, jx.jax.random.PRNGKey(3))
    tstate = train_state_from_numpy(jx.jax.tree.map(np.asarray, jstate), "cpu")
    jfn = jx.jax.jit(jx.step.make_train_step(jm, jx.cos(1e-2, 1, 3)))
    tfn = make_train_step(tm, warmup_cosine(1e-2, 1, 3))
    data = SyntheticLM(DataConfig(vocab_size=256, seq_len=16, global_batch=2, seed=0))
    for _ in range(3):
        batch = next(data)
        jstate, jmet = jfn(jstate, {k: jx.jnp.asarray(v) for k, v in batch.items()})
        tstate, tmet = tfn(tstate, batch)
        for key in ("loss", "grad_norm", "lr", "accuracy"):
            np.testing.assert_allclose(float(tmet[key]), float(jmet[key]), rtol=1e-4,
                                       atol=1e-4, err_msg=key)
    assert int(tstate["step"]) == 3 and int(tstate["opt"]["count"]) == 3


def test_grad_accum_equals_full_batch_mean():
    model = get_model(get_config("mesh-paper").reduced())
    batch = SyntheticLM(DataConfig(vocab_size=256, seq_len=8, global_batch=4, seed=1))._host_batch(0)
    sched = lambda step: torch.tensor(0.0)  # noqa: E731  (lr 0: compare grads only)
    norms = []
    for accum in (1, 2):
        state = init_train_state(model, torch.Generator().manual_seed(0), "cpu")
        _, met = make_train_step(model, sched, grad_accum=accum)(state, batch)
        norms.append(float(met["grad_norm"]))
    np.testing.assert_allclose(norms[1], norms[0], rtol=1e-5)


# -- checkpoints, crash resume, CLI ---------------------------------------------


def _mixed_tree(jx):
    jnp = jx.jnp
    return {
        "params": {"w": jnp.asarray(_np((4, 8), 30), jnp.bfloat16),
                   "b": jnp.asarray(_np((8,), 31))},
        "opt": {"m": {"w": jnp.asarray(_np((4, 8), 32)), "b": jnp.asarray(_np((8,), 33))},
                "v": {"w": jnp.asarray(_np((4, 8), 34)), "b": jnp.asarray(_np((8,), 35))},
                "count": jnp.asarray(3, jnp.int32)},
        "step": jnp.asarray(5, jnp.int32),
    }


def test_train_state_from_numpy_rejects_other_layouts():
    w = np.zeros((2, 2), np.float32)
    with pytest.raises(ValueError):
        train_state_from_numpy({"params": {"w": w}, "step": np.int32(0)}, "cpu")
    with pytest.raises(ValueError):
        train_state_from_numpy({"params": {"w": w}, "opt": {"m": {"w": w}},
                                "step": np.int32(0)}, "cpu")


def test_jax_checkpoint_restores_into_port_bitwise(jx, tmp_path):
    jtree = _mixed_tree(jx)
    jx.Ckpt(str(tmp_path)).save(5, jtree, {"data_step": 5})
    like = train_state_from_numpy(jx.jax.tree.map(np.asarray, jtree), "cpu")
    got = CheckpointManager(str(tmp_path)).restore(5, like)
    assert got["params"]["w"].dtype == torch.bfloat16
    for (kg, g), (kw, w) in zip(tree_paths(got), tree_paths(like)):
        assert kg == kw and g.dtype == w.dtype and torch.equal(g, w), kg


def test_port_checkpoint_restores_into_jax_bitwise(jx, tmp_path):
    jtree = _mixed_tree(jx)
    ours = train_state_from_numpy(jx.jax.tree.map(np.asarray, jtree), "cpu")
    CheckpointManager(str(tmp_path)).save(5, ours, {"data_step": 5})
    got = jx.Ckpt(str(tmp_path)).restore(5, jtree)
    for a, b in zip(jx.jax.tree.leaves(got), jx.jax.tree.leaves(jtree)):
        assert a.dtype == b.dtype
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_corrupt_checkpoint_is_quarantined(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "step": torch.tensor(1, dtype=torch.int32)}
    mgr.save(1, tree)
    arrays = tmp_path / "step_00000001" / "arrays.npz"
    raw = bytearray(arrays.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    arrays.write_bytes(bytes(raw))
    ledger.clear()
    with pytest.raises(CorruptCheckpointError):
        mgr.restore(1, tree)
    assert mgr.all_steps() == []
    assert (tmp_path / "step_00000001.corrupt").is_dir()
    assert ledger.count("checkpoint.read") == 1
    ledger.clear()


def _reduced_trainer(steps):
    cfg = get_config("mesh-paper").reduced()
    return ttrain.build_trainer(cfg, batch=2, seq=8, lr=1e-2, total_steps=steps, device="cpu")


def test_crash_at_step_2_resumes_to_the_same_state(tmp_path):
    step_fn, clean, data = _reduced_trainer(4)
    clean = train_loop(step_fn, clean, data, LoopConfig(total_steps=4, log_every=100),
                       logger=MetricsLogger(stream=io.StringIO()))

    crashed = []

    def hook(step):
        if step == 2 and not crashed:
            crashed.append(step)
            raise RuntimeError("injected crash")

    step_fn, state, data = _reduced_trainer(4)
    log = io.StringIO()
    state = train_loop(step_fn, state, data, LoopConfig(total_steps=4, ckpt_every=1),
                       ckpt=CheckpointManager(str(tmp_path)), logger=MetricsLogger(stream=log),
                       failure_hook=hook)
    assert crashed == [2] and "restoring step 2" in log.getvalue()
    for (key, a), (_, b) in zip(tree_paths(state), tree_paths(clean)):
        assert torch.equal(a, b), key


def test_cli_trains_reduced_on_cpu(tmp_path):
    out = io.StringIO()
    argv = ["--arch", "mesh-paper", "--reduced", "--device", "cpu", "--steps", "3",
            "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    with redirect_stdout(out):
        ttrain.main(argv)
    assert "[done] mesh-paper steps=3" in out.getvalue()
    assert sorted(os.listdir(tmp_path)) == ["step_00000002", "step_00000003"]
    with redirect_stdout(io.StringIO()):
        ttrain.main(argv[:6] + ["4", *argv[7:], "--resume", "auto"])
    # --mesh local-dp with no process group: one rank on a (1, 1) mesh, the
    # single-process step's losses; --mesh prod needs 256 ranks.
    one = io.StringIO()
    with redirect_stdout(one):
        ttrain.main(argv[:11] + ["--mesh", "local-dp"])
    assert "mesh=local-dp rank=0/1" in one.getvalue()
    assert one.getvalue().split("final_loss=")[1].split()[0] == (
        out.getvalue().split("final_loss=")[1].split()[0])
    with pytest.raises(ValueError, match="256 ranks"):
        ttrain.main(["--arch", "mesh-paper", "--reduced", "--device", "cpu", "--mesh", "prod"])


# -- on the card --------------------------------------------------------------


def test_cuda_mesh_gemm_has_grad_fn_and_kernel_backward(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn(256, 384, generator=g, device=cuda).to(torch.bfloat16).requires_grad_(True)
    b = torch.randn(384, 256, generator=g, device=cuda).to(torch.bfloat16).requires_grad_(True)
    spec = api.GemmSpec.from_operands(a, b, epilogue=api.Epilogue(activation="gelu"),
                                      out_dtype=torch.bfloat16)
    y = api.plan(spec, backend="cuda_mesh", device=cuda)(a, b)
    assert y.grad_fn is not None
    ct = torch.randn(256, 256, generator=g, device=cuda).to(torch.bfloat16)
    y.backward(ct)
    opts = api.MMOpts(128, 128, 128, True, False, torch.bfloat16, "gelu")
    da, db, _, _ = api.mm_backward(ct, a.detach(), b.detach(), None, None, opts,
                                   matmul=mesh_matmul_torch)
    for got, want in ((a.grad, da), (b.grad, db)):
        # Both sides round the f32 result to bf16: adjacent bf16 values.
        tol = 2.0**-7 * want.float().abs().max().item()
        assert (got.float() - want.float()).abs().max().item() <= tol
