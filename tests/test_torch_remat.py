"""`cfg.remat_policy` in the port's `lm_forward` (`models/transformer._remat`).

  * `none`, `dots` and `full` give the same loss and gradients bit for bit
    on the CPU (recompute repeats the same ops on the same inputs);
  * each is within 1e-5 of `jax.grad` of the reference's loss under the
    same policy, on reduced dense and moe configs;
  * what the recompute repeats, counted in dense products and grouped
    plan executions during one backward: nothing under `none`; under `dots`
    no dense product (their outputs are saved: the `repro_torch::gemm` op)
    and every grouped plan once; under `full` every plan of the layers once (the unembed sits
    outside them);
  * an unknown policy raises the reference's ValueError.

On the card the same counts hold in K1 and K5 launches.
"""

import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels import api  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

POLICIES = ["none", "dots", "full"]
# (arch, use_mesh_kernel): the dense family on K1's path, the moe family on
# both backends, and shared experts (the gate's N = 1 product).
MODELS = [("mesh-paper", True), ("olmoe-1b-7b", False), ("olmoe-1b-7b", True),
          ("qwen2-moe-a2.7b", True)]
MODEL_IDS = ["mesh-paper", "olmoe-torch", "olmoe-cuda_mesh", "qwen2-moe-cuda_mesh"]


@pytest.fixture(scope="module")
def jx():
    """The JAX reference, imported when a test needs it."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as get_cfg
    from repro.models import get_model as get_mdl

    return types.SimpleNamespace(jax=jax, jnp=jnp, get_config=get_cfg, get_model=get_mdl)


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the GPU machine")
    return torch.device("cuda")


def _cfg(arch, mesh, policy, **kw):
    return dataclasses.replace(get_config(arch).reduced(), use_mesh_kernel=mesh,
                               remat_policy=policy, **kw)


def _batch(device="cpu"):
    toks = torch.as_tensor(np.random.default_rng(7).integers(0, 256, (2, 16)), device=device)
    return {"tokens": toks.int(), "labels": torch.roll(toks, -1, 1).int()}


def _loss_and_grads(cfg, params, batch, counts=None):
    """Loss and every gradient; `counts` (if given) receives the dense
    products and grouped plan executions of the forward and of the
    backward."""
    ps = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
    model = get_model(cfg)
    seen = {"dense": 0, "grouped": 0}
    dense, execute = api._dense_forward, api.Plan._execute

    def counting_dense(*args):
        seen["dense"] += 1
        return dense(*args)

    def counting_execute(self, args):
        if self.spec.group is not None:
            seen["grouped"] += 1
        return execute(self, args)

    api._dense_forward, api.Plan._execute = counting_dense, counting_execute
    try:
        loss, _ = model.loss(ps, batch)
        fwd = dict(seen)
        seen.update(dense=0, grouped=0)
        grads = torch.autograd.grad(loss, tree_leaves(ps))
    finally:
        api._dense_forward, api.Plan._execute = dense, execute
    if counts is not None:
        counts.update(fwd=fwd, bwd=dict(seen))
    return loss.detach(), grads


@pytest.mark.parametrize("arch,mesh", MODELS, ids=MODEL_IDS)
def test_policies_agree_bitwise(arch, mesh):
    params = get_model(_cfg(arch, mesh, "none")).init(torch.Generator().manual_seed(0), "cpu")
    batch = _batch()
    loss0, grads0 = _loss_and_grads(_cfg(arch, mesh, "none"), params, batch)
    for policy in ("dots", "full"):
        loss, grads = _loss_and_grads(_cfg(arch, mesh, policy), params, batch)
        assert torch.equal(loss, loss0), policy
        for g, g0 in zip(grads, grads0):
            assert torch.equal(g, g0), policy


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch,mesh", MODELS, ids=MODEL_IDS)
def test_recompute_counts(arch, mesh, policy):
    cfg = _cfg(arch, mesh, policy)
    params = get_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    counts = {}
    _loss_and_grads(cfg, params, _batch(), counts)
    fwd, bwd = counts["fwd"], counts["bwd"]
    assert fwd["dense"] > 0 and (fwd["grouped"] > 0) == get_config(arch).is_moe
    want = {"none": {"dense": 0, "grouped": 0},
            "dots": {"dense": 0, "grouped": fwd["grouped"]},
            "full": {"dense": fwd["dense"] - 1, "grouped": fwd["grouped"]}}[policy]
    assert bwd == want


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ["qwen2-7b", "olmoe-1b-7b"])
def test_grads_match_reference_under_policy(jx, arch, policy):
    """Loss and every gradient within 1e-5 (gradients 1e-5·max|ref|) of
    jax.grad of the reference's loss under the same policy (`torch` against
    `xla`)."""
    jnp = jx.jnp
    jcfg = dataclasses.replace(jx.get_config(arch).reduced(), remat_policy=policy)
    jm = jx.get_model(jcfg)
    jp = jm.init(jx.jax.random.PRNGKey(0))
    batch = _batch()
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    (loss_j, _), gj = jx.jax.value_and_grad(lambda p: jm.loss(p, jbatch), has_aux=True)(jp)
    tp = params_from_numpy(jx.jax.tree.map(np.asarray, jp), "cpu")
    loss, grads = _loss_and_grads(_cfg(arch, False, policy), tp, batch)
    np.testing.assert_allclose(float(loss), float(loss_j), atol=1e-5, rtol=1e-5)
    want = tree_leaves(params_from_numpy(jx.jax.tree.map(np.asarray, gj), "cpu"))
    assert len(grads) == len(want)
    for got, ref in zip(grads, want):
        tol = 1e-5 * ref.abs().max().item()
        torch.testing.assert_close(got, ref, rtol=0, atol=max(tol, 1e-9))


def test_policy_defaults_match_reference(jx):
    for arch in ("mesh-paper", "olmoe-1b-7b", "qwen2-moe-a2.7b", "granite-3-8b"):
        tc, jc = get_config(arch), jx.get_config(arch)
        assert tc.remat_policy == jc.remat_policy == "dots"
        assert tc.reduced().remat_policy == jc.reduced().remat_policy == "none"


def test_unknown_policy_raises_the_reference_error(jx):
    toks = np.zeros((1, 8), np.int32)
    jcfg = dataclasses.replace(jx.get_config("olmoe-1b-7b").reduced(), remat_policy="most")
    jm = jx.get_model(jcfg)
    with pytest.raises(ValueError) as want:
        jm.forward(jm.init(jx.jax.random.PRNGKey(0)), {"tokens": jx.jnp.asarray(toks)})
    cfg = _cfg("olmoe-1b-7b", False, "most")
    params = get_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError) as got:
        get_model(cfg).forward(params, {"tokens": torch.as_tensor(toks)})
    assert str(got.value) == str(want.value) == "unknown remat policy 'most'"


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_launch_counts_on_card(cuda, policy):
    """Reduced Qwen1.5-MoE in bf16 on the kernel path: per step, K1 runs each
    dense plan once forward and twice backward (dA, dB; no model GEMM fuses
    an activation), plus the dense recompute of the policy; K5 runs each
    grouped plan once forward and once backward (dtokens; dW is a batched
    product), plus the grouped recompute."""
    from repro_torch.kernels.grouped import grouped_mesh_matmul
    from repro_torch.kernels.mesh_matmul import mesh_matmul

    cfg = _cfg("qwen2-moe-a2.7b", True, policy, param_dtype="bfloat16",
               activation_dtype="bfloat16")
    params = get_model(cfg).init(torch.Generator(device=cuda).manual_seed(0), cuda)
    counts = {}
    before = (mesh_matmul.launches, grouped_mesh_matmul.launches)
    _loss_and_grads(cfg, params, _batch(cuda), counts)
    torch.cuda.synchronize()
    k1 = mesh_matmul.launches - before[0]
    k5 = grouped_mesh_matmul.launches - before[1]
    fwd, bwd = counts["fwd"], counts["bwd"]
    assert k1 == 3 * fwd["dense"] + bwd["dense"]
    assert k5 == 2 * fwd["grouped"] + bwd["grouped"]
    assert bwd["dense"] == (fwd["dense"] - 1 if policy == "full" else 0)
