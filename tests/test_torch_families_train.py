"""Port parity of training across the eleven configs (reduced), and the WKV
chunk checkpoint.

The reference's `tests/test_models_smoke.py::test_one_train_step` step,
`constant(1e-3)` and AdamW, runs in both packages from the reference's
train state (carried over by `train_state_from_numpy`) on the reference's
batch (Whisper's `frames` and Pixtral's `patches` go through `Model.loss`
too).  f32 throughout:

  * the loss within 1e-5 relative, and every gradient leaf within
    1e-5·max|ref| of its leaf (reduction orders differ);
  * the updated parameters within 1e-5·max|ref| where the reference's
    |grad| exceeds 1e-3 of its leaf's max.  AdamW's first step moves a
    parameter by lr·sign(g) (m/sqrt(v) is ±1 on step one), so a gradient
    near 0 whose sign the two packages round differently moves it 2·lr
    apart: that is rounding, not a fault, and such entries are not held;
  * `constant` against the reference's.

The WKV checkpoint (`models/rwkv.chunk_checkpoint`) leaves outputs and
gradients bitwise equal, for the chunked form and for the scan's two-level
loop at T = 256, and in a reduced `tuned()` RWKV-6 step.  `launch/train.py`
trains reduced RWKV-6 and Zamba2 on the CPU, and the kernel path's GEMMs a
step follow the rule `chip_smoke.py`'s `[train_rwkv]` and `[train_zamba]`
hold K1's launches to: three a forward product (the product, dA and dB)
and one more for each fused activation (its pre-activation recomputed).
"""

import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import params_from_numpy, train_state_from_numpy  # noqa: E402
from repro_torch.kernels import api  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import rwkv as trwkv  # noqa: E402
from repro_torch.optim import AdamWConfig, constant  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402
from repro_torch.tree import tree_leaves, tree_paths  # noqa: E402

ARCHS = ("olmoe-1b-7b", "qwen2-moe-a2.7b", "granite-3-8b", "phi3-medium-14b", "qwen2-7b",
         "mistral-large-123b", "rwkv6-1.6b", "whisper-medium", "zamba2-1.2b", "pixtral-12b",
         "mesh-paper")


@pytest.fixture(scope="module")
def jx():
    """The JAX reference, imported when a test needs it."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as get_cfg
    from repro.models import get_model as get_mdl
    from repro.optim import adamw as jadamw
    from repro.optim import constant as jconstant

    return types.SimpleNamespace(jax=jax, jnp=jnp, get_config=get_cfg, get_model=get_mdl,
                                 adamw=jadamw, constant=jconstant)


def _np_tree(jx, tree):
    return jx.jax.tree.map(np.array, tree)


def _batch_for(jx, cfg, b=2, t=16, seed=3):
    """The reference smoke test's batch (`_batch_for`), as numpy."""
    jax, jnp = jx.jax, jx.jnp
    key = jax.random.PRNGKey(seed)
    toks = jax.random.randint(key, (b, t), 0, cfg.vocab_size).astype(jnp.int32)
    batch = {"tokens": toks, "labels": jnp.roll(toks, -1, axis=1)}
    if cfg.family == "audio":
        batch["frames"] = jax.random.normal(key, (b, t * cfg.dec_ratio, cfg.d_model), cfg.adtype)
    elif cfg.family == "vlm":
        batch["patches"] = jax.random.normal(key, (b, cfg.num_stub_patches, cfg.d_model),
                                             cfg.adtype)
    return {k: np.array(v) for k, v in batch.items()}


def _port_grads(model, params, batch):
    """(loss, gradients in tree order) of model.loss at `params`."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    with torch.enable_grad():
        loss, _ = model.loss(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    for p in leaves:
        p.requires_grad_(False)
    return float(loss.detach()), grads


def _reference_step(jx, arch):
    """The reference's state, batch, loss, gradients and first train step,
    each jitted: `make_train_step`'s step is value_and_grad of model.loss
    then `adamw_update` at the schedule's lr, here with the gradients kept."""
    jax, jnp = jx.jax, jx.jnp
    cfg = jx.get_config(arch).reduced()
    model = jx.get_model(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(2))
    state = {"params": params, "opt": jx.adamw.adamw_init(params),
             "step": jnp.zeros((), jnp.int32)}
    batch = _batch_for(jx, cfg)
    loss, grads = jax.jit(jax.value_and_grad(lambda p, b: model.loss(p, b)[0]))(params, batch)
    lr = jx.constant(1e-3)(state["opt"]["count"])
    new_params, _, gnorm = jax.jit(jx.adamw.adamw_update, static_argnums=4)(
        grads, state["opt"], params, lr, jx.adamw.AdamWConfig())
    return state, batch, float(loss), grads, new_params, float(gnorm)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step_matches_reference(jx, arch):
    jstate, batch, jloss, jgrads, jnew, jgnorm = _reference_step(jx, arch)
    ref_grads = [np.asarray(g) for g in jx.jax.tree.leaves(jgrads)]
    ref_new = [np.asarray(p) for p in jx.jax.tree.leaves(jnew)]

    model = get_model(get_config(arch).reduced())
    state = train_state_from_numpy(_np_tree(jx, jstate), "cpu")
    names = [path for path, _ in tree_paths(state["params"])]
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    loss, grads = _port_grads(model, state["params"], tbatch)
    assert abs(loss - jloss) <= 1e-5 * abs(jloss), (loss, jloss)
    assert len(grads) == len(ref_grads) == len(names)
    for name, g, ref in zip(names, grads, ref_grads):
        lim = 1e-5 * max(float(np.abs(ref).max()), 1e-30)
        err = float(np.abs(g.numpy() - ref).max())
        assert err <= lim, f"{arch} grad {name}: max |d| {err:.3e} > {lim:.3e}"

    new, met = make_train_step(model, constant(1e-3), AdamWConfig())(state, tbatch)
    assert abs(float(met["loss"]) - jloss) <= 1e-5 * abs(jloss)
    assert abs(float(met["grad_norm"]) - jgnorm) <= 1e-5 * jgnorm
    assert int(new["step"]) == 1
    for name, p, ref, g in zip(names, tree_leaves(new["params"]), ref_new, ref_grads):
        held = np.abs(g) > 1e-3 * np.abs(g).max()
        err = np.abs(p.detach().numpy() - ref)[held]
        lim = 1e-5 * max(float(np.abs(ref).max()), 1e-30)
        assert err.size == 0 or float(err.max()) <= lim, (
            f"{arch} updated {name}: max |d| {float(err.max()):.3e} > {lim:.3e}")


def test_constant_schedule_matches_reference(jx):
    step = torch.tensor(7, dtype=torch.int32)
    got = constant(3e-4)(step)
    want = np.asarray(jx.constant(3e-4)(jx.jnp.int32(7)))
    assert got.dtype == torch.float32 and got.shape == () and got.device == step.device
    assert got.numpy().tobytes() == want.astype(np.float32).tobytes()


# -- the WKV chunk checkpoint ---------------------------------------------------


def _wkv_outputs_and_grads(fn, t, on, **kw):
    g = torch.Generator().manual_seed(1)
    b, h, k = 2, 2, 8
    r, kk, v = (torch.randn(b, t, h, k, generator=g).requires_grad_() for _ in range(3))
    w = torch.sigmoid(torch.randn(b, t, h, k, generator=g)).requires_grad_()
    u = torch.randn(h, k, generator=g).requires_grad_()
    s0 = torch.randn(b, h, k, k, generator=g).requires_grad_()
    with trwkv.chunk_checkpoint(on):
        o, s = fn(r, kk, v, w, u, s0, **kw)
        (o.square().sum() + s.sum()).backward()
    return [o, s, r.grad, kk.grad, v.grad, w.grad, u.grad, s0.grad]


@pytest.mark.parametrize("form,t", [("chunked", 64), ("scan", 256)])
def test_wkv_chunk_checkpoint_is_bitwise(form, t):
    fn, kw = ((trwkv._wkv_chunked, dict(chunk=16)) if form == "chunked"
              else (trwkv._wkv_scan, {}))
    on = _wkv_outputs_and_grads(fn, t, True, **kw)
    off = _wkv_outputs_and_grads(fn, t, False, **kw)
    assert all(torch.equal(x, y) for x, y in zip(on, off))


def test_wkv_checkpoint_recomputes_each_chunk(monkeypatch):
    """The checkpoint runs where autograd records: one per chunk, and the
    backward recomputes each chunk's body once."""
    calls = []
    real = trwkv.checkpoint
    monkeypatch.setattr(trwkv, "checkpoint", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    _wkv_outputs_and_grads(trwkv._wkv_scan, 384, True)
    _wkv_outputs_and_grads(trwkv._wkv_chunked, 64, True, chunk=16)
    assert len(calls) == 3 + 4
    with torch.no_grad():
        trwkv._wkv_scan(*(torch.rand(1, 256, 1, 4) for _ in range(4)), torch.rand(1, 4),
                        torch.zeros(1, 1, 4, 4))
    assert len(calls) == 7  # nothing to save: no checkpoint


def test_rwkv_step_with_and_without_checkpoint_is_bitwise(jx):
    cfg = get_config("rwkv6-1.6b").tuned().reduced()
    assert cfg.wkv_chunked
    jparams = jx.get_model(jx.get_config("rwkv6-1.6b").tuned().reduced()).init(
        jx.jax.random.PRNGKey(1))
    model = get_model(cfg)
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 2 * cfg.wkv_chunk)), dtype=torch.int32)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    runs = []
    for on in (True, False):
        params = params_from_numpy(_np_tree(jx, jparams), "cpu")
        with trwkv.chunk_checkpoint(on):
            runs.append(_port_grads(model, params, batch))
    (l_on, g_on), (l_off, g_off) = runs
    assert l_on == l_off and all(torch.equal(x, y) for x, y in zip(g_on, g_off))


# -- the launcher and the kernel path's products ---------------------------------


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-1.2b"])
def test_train_cli_takes_two_steps(arch, capsys):
    ttrain.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "2",
                 "--batch", "2", "--seq", "32", "--log-every", "1"])
    out = capsys.readouterr().out
    assert "[step 2]" in out
    done = out.split("[done]")[1]
    assert f"{arch} steps=2" in done and "device=cpu" in done
    assert np.isfinite(float(done.split("final_loss=")[1].split()[0]))


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-1.2b"])
def test_kernel_path_gemms_per_step(arch, monkeypatch):
    """Counted at the kernel wrapper's seam (`api.mesh_matmul`): a forward
    product F runs once forward and twice backward (dA, dB), and a fused
    activation's pre-activation is recomputed once more."""
    cfg = dataclasses.replace(get_config(arch).tuned().reduced(), use_mesh_kernel=True)
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    seen = []
    real = api.mesh_matmul

    def counting(*args, **kw):
        seen.append(kw.get("activation"))
        return real(*args, **kw)

    monkeypatch.setattr(api, "mesh_matmul", counting)
    toks = torch.randint(0, cfg.vocab_size, (2, 32), generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    with torch.no_grad():
        model.loss(params, {"tokens": toks, "labels": toks})
    forward, acts = len(seen), sum(a not in (None, "none") for a in seen)
    seen.clear()
    _port_grads(model, params, {"tokens": toks, "labels": toks})
    assert len(seen) == 3 * forward + acts
    per_layer = {"rwkv6-1.6b": (8, 3), "zamba2-1.2b": None}[arch]
    if per_layer is not None:  # RWKV: 8 products a layer, 3 fused activations, the head
        assert (forward, acts) == (per_layer[0] * cfg.num_layers + 1,
                                   per_layer[1] * cfg.num_layers)
    else:  # Zamba2: no fused activation (swiglu's product is plain)
        assert acts == 0


def test_zamba_gradients_stay_finite_where_the_reference_overflows(jx):
    """`ssd_chunked` masks the exponents above the diagonal before the exp;
    the reference masks after it, and at T = 256 (one 128-step chunk whose
    cumulative log-decay falls by more than 88) its backward forms 0 * inf:
    NaN gradients.  The port's loss equals the reference's, and its
    gradients are finite; where the reference's are finite (T = 64) they
    agree within 1e-5·max|ref| (test_one_train_step_matches_reference)."""
    jax, jnp = jx.jax, jx.jnp
    jcfg = jx.get_config("zamba2-1.2b").tuned().reduced()
    jmodel = jx.get_model(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(2))
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(3), (2, 256), 0, jcfg.vocab_size),
                      np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p, b: jmodel.loss(p, b)[0]))(jparams, batch)
    assert not all(np.isfinite(np.asarray(g)).all() for g in jax.tree.leaves(jgrads))

    model = get_model(get_config("zamba2-1.2b").tuned().reduced())
    params = params_from_numpy(_np_tree(jx, jparams), "cpu")
    loss, grads = _port_grads(model, params, {k: torch.as_tensor(v) for k, v in batch.items()})
    assert abs(loss - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert all(bool(torch.isfinite(g).all()) for g in grads)
