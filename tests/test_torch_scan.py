"""Scan-over-layers in the port (CompiledNet._scan_runs / _apply_scan,
Solver.set_scan, the verbs' --scan on) against the JAX package's lax.scan
on tests/test_scan_layers.py's 3-block LM: the runs, the loss, the
gradients and the blobs a scanned forward leaves absent; on against off
and remat composing in the port."""

import contextlib
import io
import re

import numpy as np
import pytest
import jax

from sparknet_tpu.graph.compiler import CompiledNet as JNet
from sparknet_tpu.models import zoo as jzoo
from sparknet_tpu_torch import cli
from sparknet_tpu_torch.graph import TRAIN, CompiledNet as TNet
from sparknet_tpu_torch.graph.weights import params_from_numpy
from sparknet_tpu_torch.models import zoo as tzoo
from sparknet_tpu_torch.proto import Message
from sparknet_tpu_torch.solver import Solver


def _lm_net(zoo, layers=3):
    return zoo.transformer_lm(vocab_size=64, seq_len=32, batch_size=2,
                              d_model=32, num_layers=layers, num_heads=4,
                              flash=False)


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    toks = rs.randint(0, 64, (2, 33))
    return {"data": toks[:, :-1], "label": toks[:, 1:]}


@pytest.fixture(autouse=True)
def _defaults(monkeypatch):
    monkeypatch.setenv("SPARKNET_REMAT", "none")
    monkeypatch.setenv("SPARKNET_SCAN", "auto")


@pytest.fixture(scope="module")
def jax_scan():
    """The JAX package's loss, gradients and blob names under scan on,
    and its initial params as numpy."""
    net = JNet(_lm_net(jzoo), 0)
    net.scan = "on"
    params, state = net.init(jax.random.PRNGKey(0))
    batch = _batch()

    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: net.loss_fn(p, state, batch)[0]))(params)
    names = sorted(net.apply(params, state, batch, train=True)[0])
    as_np = lambda t: {k: [np.asarray(a) for a in v]   # noqa: E731
                       for k, v in t.items()}
    return float(loss), as_np(grads), names, as_np(params), net._scan_runs()


def _port(params_np, scan, remat="none"):
    net = TNet(_lm_net(tzoo), TRAIN, device="cpu")
    net.scan, net.remat = scan, remat
    params, state = params_from_numpy(net, params_np, {})
    ps = {k: [p.detach().clone().requires_grad_(True) for p in v]
          for k, v in params.items()}
    loss, (blobs, _) = net.loss_fn(ps, state, _batch())
    loss.backward()
    return loss.item(), {k: [p.grad.numpy() for p in v]
                         for k, v in ps.items()}, sorted(blobs), net


def test_runs_equal_the_jax_packages(jax_scan):
    net = TNet(_lm_net(tzoo), TRAIN, device="cpu")
    runs = net._scan_runs()
    assert runs == jax_scan[4]
    assert len(runs) == 1 and runs[0]["n"] == 3
    assert runs[0]["entry"] == "embed"
    assert TNet(_lm_net(tzoo, 1), TRAIN, device="cpu")._scan_runs() == []


def test_scan_on_matches_the_jax_package(jax_scan):
    loss, grads, names, params, _ = jax_scan
    got = _port(params, "on")
    np.testing.assert_allclose(got[0], loss, rtol=1e-5)
    assert set(got[1]) == set(grads)
    for k in grads:
        for a, b in zip(got[1][k], grads[k]):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5,
                                       err_msg=k)
    assert got[2] == names
    # the scan leaves the blocks' internal blobs out; the last boundary
    # blob survives
    full = _port(params, "off")[2]
    absent = set(full) - set(got[2])
    assert absent and all(n.startswith("block") for n in absent)
    assert jax_scan[4][0]["out"] in got[2]


@pytest.mark.parametrize("remat", ["none", "dots", "full"])
def test_scan_on_agrees_with_off_and_composes_with_remat(jax_scan, remat):
    params = jax_scan[3]
    off = _port(params, "off")
    on = _port(params, "on", remat=remat)
    # the same layer calls in the same order: bit for bit on the CPU
    assert on[0] == off[0]
    for k in off[1]:
        for a, b in zip(on[1][k], off[1][k]):
            assert np.array_equal(a, b), (remat, k)


def test_auto_does_not_scan_here_and_the_env_is_read(monkeypatch):
    net = TNet(_lm_net(tzoo), TRAIN, device="cpu")
    assert not net._scan_enabled()               # auto: a TPU-only scan
    monkeypatch.setenv("SPARKNET_SCAN", "on")
    assert net._scan_enabled()
    net.scan = "off"
    assert not net._scan_enabled()
    monkeypatch.setenv("SPARKNET_SCAN", "sometimes")
    net.scan = None
    with pytest.raises(ValueError, match="SPARKNET_SCAN"):
        net._scan_enabled()


def test_solver_set_scan():
    sp = Message("SolverParameter", base_lr=0.01, lr_policy="fixed",
                 display=0)
    solver = Solver(sp, net_param=_lm_net(tzoo), device="cpu",
                    log_fn=None)
    solver.set_scan("on")
    assert solver.net.scan == "on"
    with pytest.raises(ValueError, match="scan mode"):
        solver.set_scan("sometimes")
    loss_on = float(solver.train_step(_batch()))
    assert np.isfinite(loss_on)


def test_lm_verb_scan_on_exits_zero(monkeypatch):
    argv = ["lm", "--device", "cpu", "--vocab", "32", "--seq-len", "16",
            "--batch", "2", "--d-model", "16", "--layers", "3", "--heads",
            "2", "--display", "1", "--steps", "2"]
    runs = []
    for mode in ("on", "off"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli.main(argv + ["--scan", mode]) == 0
        runs.append(re.findall(r"Iteration \d+, loss = (\S+),",
                               buf.getvalue()))
    assert len(runs[0]) == 2 and runs[0] == runs[1]


@pytest.mark.parametrize("remat", ["none", "full"])
def test_lockstep_scan_matches_the_single_device_forward(jax_scan, remat):
    """The mesh path's lock step (two data slots) takes the scan policy
    as CompiledNet.apply does: the same loss, gradients and absent blobs
    as the single-device forward under scan on, with and without
    remat."""
    from sparknet_tpu_torch.parallel.lockstep import lockstep_apply
    from sparknet_tpu_torch.parallel.mesh import make_mesh
    want = _port(jax_scan[3], "on", remat=remat)
    net = want[3]
    params, state = params_from_numpy(net, jax_scan[3], {})
    ps = {k: [p.detach().clone().requires_grad_(True) for p in v]
          for k, v in params.items()}
    outs = lockstep_apply(net, make_mesh({"data": 2}), [ps, ps],
                          [state, state], [_batch(), _batch()])
    for blobs, _ in outs:
        assert sorted(blobs) == want[2]
    loss = sum(net.total_loss(b) for b, _ in outs) / 2
    loss.backward()
    assert loss.item() == want[0]
    for k in want[1]:
        for a, b in zip(ps[k], want[1][k]):
            assert np.array_equal(a.grad.numpy(), b), (remat, k)


@pytest.mark.parametrize("flags", [["--sp", "2"], ["--tp", "2", "--remat",
                                                    "full"]],
                         ids=["sp", "tp-remat"])
def test_lm_verb_mesh_branch_scan_on_agrees_with_off(flags, monkeypatch):
    monkeypatch.setenv("SPARKNET_FSDP", "off")
    monkeypatch.setenv("SPARKNET_TP", "0")
    argv = ["lm", "--device", "cpu", "--vocab", "32", "--seq-len", "16",
            "--batch", "4", "--d-model", "16", "--layers", "3", "--heads",
            "2", "--display", "1", "--steps", "2", "--no-flash"] + flags
    runs = []
    for mode in ("on", "off"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli.main(argv + ["--scan", mode]) == 0
        runs.append(re.findall(r"Iteration \d+, loss = (\S+),",
                               buf.getvalue()))
    assert len(runs[0]) == 2 and runs[0] == runs[1]
