"""The port's `AsyncCheckpointer` against the reference's contract.

The reference's async-writer tests (`tests/test_fault_tolerance.py`,
`tests/test_resilience.py`) re-run against the port: writes land in step
order, the tree is snapshotted at `submit`, a transient `checkpoint.write`
fault is absorbed on the second attempt with a `retry#1` ledger event, a
write that always fails is raised on `wait()` and on `close()`, and
`__exit__` does not mask a running exception.  A checkpoint the port writes
asynchronously restores in the reference bit for bit, and `--async-ckpt`
through `launch/train.py` resumes to the uninterrupted run's losses bit for
bit.  On the card, `submit` makes no host sync.
"""

import threading

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.checkpoint import AsyncCheckpointer, CheckpointManager  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.resilience import faults, ledger  # noqa: E402
from repro_torch.train.metrics import MetricsLogger  # noqa: E402


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the GPU machine")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _clean_ledger():
    ledger.clear()
    yield
    ledger.clear()


def test_async_checkpointer(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    writer = AsyncCheckpointer(ckpt)
    tree = {"x": torch.arange(4, dtype=torch.float32)}
    for s in (1, 2, 3):
        writer.submit(s, {"x": tree["x"] + s}, {"data_step": s})
    writer.wait()
    assert ckpt.all_steps() == [1, 2, 3]
    assert ckpt.meta(2)["data_step"] == 2
    out = ckpt.restore(2, tree)
    np.testing.assert_array_equal(out["x"].numpy(), np.arange(4) + 2)
    writer.close()
    assert not writer._thread.is_alive()


@pytest.mark.parametrize("kind", ["numpy", "torch", "torch_bf16"])
def test_async_checkpointer_snapshot_semantics(tmp_path, kind):
    """The tree is snapshotted at submit(): mutating it afterwards (as the
    port's in-place AdamW does) cannot change the pending checkpoint."""
    ckpt = CheckpointManager(str(tmp_path))
    writer = AsyncCheckpointer(ckpt)
    if kind == "numpy":
        leaf = np.zeros(4, np.float32)
    else:
        leaf = torch.zeros(4, dtype=torch.float32 if kind == "torch" else torch.bfloat16)
    writer.submit(1, {"x": leaf})
    leaf += 99  # mutate after submit
    writer.wait()
    like = torch.zeros(4, dtype=torch.bfloat16 if kind == "torch_bf16" else torch.float32)
    out = ckpt.restore(1, {"x": like})
    assert out["x"].dtype == like.dtype
    np.testing.assert_array_equal(out["x"].float().numpy(), np.zeros(4))
    writer.close()


def test_async_checkpointer_holds_one_host_copy(tmp_path):
    """`submit` waits for the previous write, which still reads the host
    buffers, then reuses them: one host copy of the tree however often the
    loop submits."""
    ckpt = CheckpointManager(str(tmp_path))
    release, save = threading.Event(), ckpt.save

    def slow_save(*args, **kw):
        release.wait(10)
        return save(*args, **kw)

    ckpt.save = slow_save
    writer = AsyncCheckpointer(ckpt)
    writer.submit(1, {"x": torch.zeros(4), "y": np.zeros(2)})
    first = list(writer._host)
    second = threading.Thread(target=writer.submit, args=(2, {"x": torch.ones(4),
                                                              "y": np.ones(2)}))
    second.start()
    second.join(0.3)
    assert second.is_alive()  # waiting for write 1
    release.set()
    second.join(10)
    reused = all(a is b for a, b in zip(writer._host, first))
    writer.close()
    assert writer.waited_s > 0.2
    assert reused and first[0] is not None
    for step, value in ((1, 0.0), (2, 1.0)):
        out = ckpt.restore(step, {"x": torch.zeros(4), "y": np.zeros(2)})
        np.testing.assert_array_equal(out["x"].numpy(), np.full(4, value))
        np.testing.assert_array_equal(np.asarray(out["y"]), np.full(2, value))


def test_async_writer_retries_transient_write_fault(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    with faults.inject({"checkpoint.write": faults.FaultSpec(times=1, error=OSError)}):
        with AsyncCheckpointer(mgr, backoff=0.0) as ck:
            ck.submit(3, {"w": torch.arange(4.0)})
            ck.wait()  # the transient failure is absorbed by the bounded retry
    assert mgr.latest_step() == 3
    assert [e.fallback for e in ledger.events("checkpoint.write")] == ["retry#1"]


def test_async_writer_raises_permanent_failure_on_wait_and_close(tmp_path):
    ck = AsyncCheckpointer(CheckpointManager(str(tmp_path)), retries=1, backoff=0.0)
    with faults.inject({"checkpoint.write": faults.FaultSpec(times=99, error=OSError)}):
        ck.submit(1, {"w": torch.zeros(2)})
        with pytest.raises(RuntimeError, match="checkpoint write failed"):
            ck.wait()
        ck.submit(2, {"w": torch.zeros(2)})
        with pytest.raises(RuntimeError, match="checkpoint write failed"):
            ck.close()
    assert not ck._thread.is_alive()  # the worker stopped BEFORE the raise
    assert [e.fallback for e in ledger.events("checkpoint.write")] == ["retry#1"] * 2
    with pytest.raises(RuntimeError, match="closed"):
        ck.submit(3, {"w": torch.zeros(2)})


def test_async_writer_exit_preserves_body_exception(tmp_path):
    with pytest.raises(ValueError, match="body error"):
        with faults.inject({"checkpoint.write": faults.FaultSpec(times=9, error=OSError)}):
            with AsyncCheckpointer(CheckpointManager(str(tmp_path)), retries=0,
                                   backoff=0.0) as ck:
                ck.submit(1, {"w": torch.zeros(2)})
                raise ValueError("body error")


def test_async_checkpoint_restores_in_reference_bitwise(tmp_path):
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.checkpoint.manager import CheckpointManager as JaxManager

    rng = np.random.default_rng(0)
    tree = {"a": torch.from_numpy(rng.normal(size=(3, 5)).astype(np.float32)),
            "b": {"c": torch.from_numpy(rng.normal(size=(7,)).astype(np.float32))
                  .to(torch.bfloat16)}}
    with AsyncCheckpointer(CheckpointManager(str(tmp_path))) as ck:
        ck.submit(5, tree, {"data_step": 5})
    out = JaxManager(str(tmp_path)).restore(
        5, {"a": jnp.zeros((3, 5)), "b": {"c": jnp.zeros((7,), jnp.bfloat16)}})
    np.testing.assert_array_equal(np.asarray(out["a"]), tree["a"].numpy())
    np.testing.assert_array_equal(np.asarray(out["b"]["c"]).view(np.uint16),
                                  tree["b"]["c"].view(torch.int16).numpy().view(np.uint16))


def _train_cli(monkeypatch, argv):
    """launch/train.py main; returns the losses its loop logged, in order."""
    losses = []

    class Recording(MetricsLogger):
        def log(self, step, metrics):
            losses.append(metrics["loss"])
            super().log(step, metrics)

    monkeypatch.setattr(ttrain, "MetricsLogger", Recording)
    ttrain.main(argv)
    return losses


def test_async_ckpt_cli_resume_matches_uninterrupted(tmp_path, monkeypatch, capsys):
    """reduced OLMoE through `launch/train.py --async-ckpt`: 4 steps in one
    run, against 2 steps then a `--resume auto` run to step 4 — the resumed
    steps' losses and the step-4 checkpoints are equal bit for bit."""
    base = ["--arch", "olmoe-1b-7b", "--reduced", "--device", "cpu", "--batch", "2",
            "--seq", "16", "--ckpt-every", "2", "--async-ckpt", "--log-every", "1"]
    full = _train_cli(monkeypatch, base + ["--steps", "4", "--ckpt-dir", str(tmp_path / "a")])
    first = _train_cli(monkeypatch, base + ["--steps", "2", "--ckpt-dir", str(tmp_path / "b")])
    resumed = _train_cli(monkeypatch, base + ["--steps", "4", "--ckpt-dir", str(tmp_path / "b"),
                                              "--resume", "auto"])
    assert "[resume] restoring step 2" in capsys.readouterr().out
    assert len(full) == 4 and first == full[:2] and resumed == full[2:]
    a, b = CheckpointManager(str(tmp_path / "a")), CheckpointManager(str(tmp_path / "b"))
    assert a.all_steps() == b.all_steps() == [2, 4]
    with np.load(tmp_path / "a" / "step_00000004" / "arrays.npz") as fa, \
            np.load(tmp_path / "b" / "step_00000004" / "arrays.npz") as fb:
        assert sorted(fa.files) == sorted(fb.files)
        for key in fa.files:
            np.testing.assert_array_equal(fa[key], fb[key], err_msg=key)


def test_submit_makes_no_host_sync_on_card(cuda, tmp_path):
    """A CUDA tree snapshots into pinned host buffers behind an event:
    `submit` runs under CUDA's sync debug mode set to raise, an in-place
    update queued right after it does not reach the checkpoint, and the
    checkpoint restores bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(0)
    tree = {"w": torch.randn(1024, 1024, generator=g, device=cuda).to(torch.bfloat16),
            "m": torch.randn(1024, 1024, generator=g, device=cuda),
            "step": torch.zeros((), dtype=torch.int32, device=cuda)}
    want = {k: v.cpu() for k, v in tree.items()}
    ckpt = CheckpointManager(str(tmp_path))
    with AsyncCheckpointer(ckpt) as ck:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            ck.submit(1, tree)
            for v in tree.values():
                v.add_(1)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        ck.wait()
    out = ckpt.restore(1, tree)
    for k, v in want.items():
        assert out[k].device.type == "cuda" and torch.equal(out[k].cpu(), v), k
