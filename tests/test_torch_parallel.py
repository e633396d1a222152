"""The port's parallel solvers against the JAX package's on the CPU.

The JAX LocalSGDSolver and DataParallelSolver run on the virtual CPU
mesh of tests/conftest.py (one device per worker); the port's run the
same workers as slots on the CPU. Both start from the same weights,
which cross over through a JAX snapshot (.caffemodel + .solverstate),
and take the same numpy batches. The nets are zoo.cifar10_full (no
dropout) at a small batch.

Tolerance: params are read by their change over the run, history and
gradients by their size. For each blob, max |port - jax| over the
largest element of the JAX package's change (or history), worst blob,
within LIMIT = 1e-3. The params read 0.7e-4 to 1.1e-4 (f32 weights
rounded after each step, against a change of ~1e-3 of their size;
XLA:CPU and PyTorch's CPU convolutions also sum in different orders),
the histories ~1e-6. The round and step losses agree within rtol 1e-5.
The comparisons are not vacuous: the slots' histories differ from each
other by 1.7 to 3.9 of their size, so a wrong slot or a dropped
average would fail by three orders of magnitude.
"""

import json

import numpy as np
import pytest
import jax
import torch

from sparknet_tpu.models import zoo as jzoo
from sparknet_tpu.parallel import (DataParallelSolver as JDataParallel,
                                   LocalSGDSolver as JLocalSGD, make_mesh)
from sparknet_tpu.proto import Message as JMessage
from sparknet_tpu_torch.graph.compiler import blob_to_array
from sparknet_tpu_torch.models import zoo as tzoo
from sparknet_tpu_torch.parallel import DataParallelSolver, LocalSGDSolver
from sparknet_tpu_torch.proto import Message as TMessage, wire
from sparknet_tpu_torch.resilience import WorldMismatch, manifest_path
from sparknet_tpu_torch.solver import Solver

LIMIT = 1e-3
B, TAU = 4, 3


def _sp(message, momentum=0.9, base_lr=0.02):
    # CifarApp's solver, with a step policy that moves inside a round
    return message("SolverParameter", base_lr=base_lr, lr_policy="step",
                   gamma=0.5, stepsize=2, momentum=momentum,
                   weight_decay=0.004, random_seed=11, display=0)


def _round_batches(workers, seed, tau=TAU):
    rs = np.random.RandomState(seed)
    return {"data": rs.randn(tau, workers * B, 3, 32, 32).astype(np.float32),
            "label": rs.randint(0, 10, (tau, workers * B)).astype(np.int32)}


def _jax_local(workers, tau=TAU, momentum=0.9, **kw):
    return JLocalSGD(_sp(JMessage, momentum),
                     mesh=make_mesh({"data": workers}), tau=tau,
                     net_param=jzoo.cifar10_full(batch_size=B), log_fn=None,
                     **kw)


def _port_local(workers, tau=TAU, momentum=0.9, base_lr=0.02, **kw):
    return LocalSGDSolver(_sp(TMessage, momentum, base_lr), workers=workers,
                          tau=tau, net_param=tzoo.cifar10_full(batch_size=B),
                          device="cpu", log_fn=None, **kw)


def _jax_slots(leaf):
    """Each worker's copy of a JAX array, in mesh order."""
    by_device = {s.device: np.asarray(s.data)
                 for s in leaf.addressable_shards}
    return [by_device[d] for d in leaf.sharding.mesh.devices.flat]


def _worst(pairs):
    """max over blobs of max |got - ref| / max |ref| -> (error, blob)."""
    worst, where = 0.0, None
    for name, got, ref in pairs:
        scale = max(float(np.abs(ref).max()), 1e-30)
        e = float(np.abs(got - ref).max()) / scale
        if e > worst:
            worst, where = e, name
    return worst, where


def _params_np(params):
    return {n: [np.asarray(p.detach() if torch.is_tensor(p) else p,
                           np.float64) for p in ps]
            for n, ps in params.items()}


def _assert_params_match(ts, js, w0):
    """The port's params against the JAX package's, read by their change
    from ``w0``."""
    got, ref = _params_np(ts.params), _params_np(js.params)
    err, where = _worst(
        (f"{n}[{i}]", got[n][i] - w0[n][i], ref[n][i] - w0[n][i])
        for n in ref for i in range(len(ref[n])))
    assert err <= LIMIT, f"params differ by {err:.3e} of the change at {where}"
    return err


def _assert_slot_history_match(ts, js):
    """Every slot's history, the port's against the JAX package's; and
    the slots differ among themselves (or, averaged, agree)."""
    pairs, spread = [], 0.0
    for n, hss in js.history.items():
        for i, hs in enumerate(hss):
            for s, leaf in enumerate(hs):
                ref = _jax_slots(leaf)
                got = ts.slot_history[n][i][s].numpy()
                for w, r in enumerate(ref):
                    pairs.append((f"{n}[{i}][{s}] slot {w}", got[w], r))
                scale = max(float(np.abs(ref[0]).max()), 1e-30)
                spread = max(spread, max(float(np.abs(r - ref[0]).max())
                                         for r in ref) / scale)
    err, where = _worst(pairs)
    assert err <= LIMIT, f"history differs by {err:.3e} at {where}"
    return err, spread


def _start_together(tmp_path, js, ts):
    """The port solver takes the JAX solver's weights and history
    through a JAX snapshot; -> the starting params."""
    _, state = js.snapshot(str(tmp_path / "start"))
    ts.restore(state)
    return _params_np(js.params)


@pytest.mark.parametrize("workers,average_history",
                         [(2, False), (2, True), (4, False), (4, True)],
                         ids=["W2-per-slot", "W2-averaged", "W4-per-slot",
                              "W4-averaged"])
def test_local_sgd_rounds_match_jax(tmp_path, workers, average_history):
    js = _jax_local(workers, average_history=average_history)
    ts = _port_local(workers, average_history=average_history)
    w0 = _start_together(tmp_path, js, ts)
    for r in range(2):
        batches = _round_batches(workers, seed=20 + r)
        jl = float(js.train_round(batches))
        tl = float(ts.train_round(batches))
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        assert ts.iter == js.iter == TAU * (r + 1)
        _assert_params_match(ts, js, w0)
        _, spread = _assert_slot_history_match(ts, js)
        if average_history:
            assert spread == 0.0        # every slot holds the average
        else:
            assert spread > 100 * LIMIT  # the slots kept their own
    # after the average every slot holds the consensus params
    for ps in ts.slot_params.values():
        for P in ps:
            assert torch.equal(P[0].expand_as(P), P)


def test_data_parallel_steps_match_jax(tmp_path):
    workers = 4
    jd = JDataParallel(_sp(JMessage), mesh=make_mesh({"data": workers}),
                       net_param=jzoo.cifar10_full(batch_size=workers * B),
                       log_fn=None)
    td = DataParallelSolver(_sp(TMessage), workers=workers,
                            net_param=tzoo.cifar10_full(
                                batch_size=workers * B),
                            device="cpu", log_fn=None)
    w0 = _start_together(tmp_path, jd, td)
    for seed in (30, 31):
        batch = {k: v[0] for k, v in _round_batches(workers, seed, 1).items()}
        np.testing.assert_allclose(float(td.train_step(batch)),
                                   float(jd.train_step(batch)), rtol=1e-5)
    _assert_params_match(td, jd, w0)
    err, _ = _worst(
        (n, td.history[n][i][0].numpy(), np.asarray(jd.history[n][i][0]))
        for n in jd.history for i in range(len(jd.history[n])))
    assert err <= LIMIT, f"history differs by {err:.3e}"
    test = {k: v[0] for k, v in _round_batches(workers, 32, 1).items()}
    got, ref = td.test(iter([test])), jd.test(iter([test]))
    for k in ref:
        np.testing.assert_allclose(got[k], np.asarray(ref[k]), rtol=1e-5)


def test_tau1_local_sgd_is_one_data_parallel_step():
    """With tau = 1 and no momentum the average of the slots' SGD steps
    is the step on the averaged gradient: the two solvers agree
    (tests/test_parallel.py holds the same identity in the JAX
    package). The step is large (lr 1) so that it stands well above the
    rounding of the weights it is added to."""
    workers = 4
    ls = _port_local(workers, tau=1, momentum=0.0, base_lr=1.0)
    dp = DataParallelSolver(_sp(TMessage, 0.0, 1.0), workers=workers,
                            net_param=tzoo.cifar10_full(
                                batch_size=workers * B),
                            device="cpu", log_fn=None)
    with torch.no_grad():
        for n, ps in dp.params.items():
            for p, q in zip(ps, ls.params[n]):
                p.copy_(q)
    w0 = _params_np(dp.params)
    batches = _round_batches(workers, seed=40, tau=1)
    ls.train_round(batches)
    dp.train_step({k: v[0] for k, v in batches.items()})
    got, ref = _params_np(ls.params), _params_np(dp.params)
    err, where = _worst((f"{n}[{i}]", got[n][i] - w0[n][i],
                         ref[n][i] - w0[n][i])
                        for n in ref for i in range(len(ref[n])))
    assert err <= LIMIT, f"{err:.3e} of the change at {where}"


def _state_history(path):
    ss = wire.load(path, "SolverState")
    return int(ss.iter), [blob_to_array(b) for b in ss.history]


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_snapshots_cross_over(tmp_path, direction):
    """After one round from the same start, both packages' snapshots
    hold slot 0's history (the copy the JAX package's host read
    fetches); a fresh solver of each package restores the source's
    snapshot, and their next rounds agree."""
    workers = 2
    js, ts = _jax_local(workers), _port_local(workers)
    w0 = _start_together(tmp_path, js, ts)
    batches = _round_batches(workers, seed=50)
    js.train_round(batches)
    ts.train_round(batches)
    _, jstate = js.snapshot(str(tmp_path / "jax"))
    _, tstate = ts.snapshot(str(tmp_path / "port"))
    jit, jh = _state_history(jstate)
    tit, th = _state_history(tstate)
    assert jit == tit == TAU
    conv1 = _jax_slots(js.history["conv1"][0][0])
    np.testing.assert_array_equal(jh[0].reshape(conv1[0].shape), conv1[0])
    assert np.abs(conv1[1] - conv1[0]).max() > \
        100 * LIMIT * np.abs(conv1[0]).max()
    np.testing.assert_array_equal(
        th[0].reshape(conv1[0].shape),
        ts.slot_history["conv1"][0][0][0].numpy())
    err, _ = _worst(("history", t, j) for t, j in zip(th, jh))
    assert err <= LIMIT
    # the worlds are stamped alike
    stamps = [json.load(open(manifest_path(str(tmp_path / p))))["latest"]
              ["world"] for p in ("jax", "port")]
    assert stamps[0] == stamps[1] == {"processes": 1,
                                      "mesh": {"data": workers}}

    source = jstate if direction == "jax_to_port" else tstate
    jb, tb = _jax_local(workers), _port_local(workers)
    jb.restore(source)
    tb.restore(source)
    assert jb.iter == tb.iter == TAU
    nxt = _round_batches(workers, seed=51)
    np.testing.assert_allclose(float(tb.train_round(nxt)),
                               float(jb.train_round(nxt)), rtol=1e-5)
    _assert_params_match(tb, jb, w0)
    _assert_slot_history_match(tb, jb)


def test_restore_refuses_another_worker_count(tmp_path):
    js = _jax_local(2)
    _, jstate = js.snapshot(str(tmp_path / "jax"))
    ts = _port_local(2)
    _, tstate = ts.snapshot(str(tmp_path / "port"))
    for state in (jstate, tstate):
        with pytest.raises(WorldMismatch, match=r"mesh \{'data': 2\} vs "
                                                r"\{'data': 4\}"):
            _port_local(4).restore(state)
    # the one-device Solver, which names no mesh, restores either (as
    # the JAX package's does), and stamps its snapshots with no mesh
    single = Solver(_sp(TMessage), net_param=tzoo.cifar10_full(batch_size=B),
                    device="cpu", log_fn=None)
    single.restore(tstate)
    assert single.iter == 0
    single.snapshot(str(tmp_path / "single"))
    assert json.load(open(manifest_path(str(tmp_path / "single"))))[
        "latest"]["world"] == {"processes": 1}


def test_run_snapshots_and_resumes_auto(tmp_path):
    prefix = str(tmp_path / "run")
    log = []
    ts = LocalSGDSolver(_sp(TMessage), workers=2, tau=2,
                        net_param=tzoo.cifar10_full(batch_size=B),
                        device="cpu", log_fn=log.append)
    batch_fn = lambda tau: _round_batches(2, seed=60, tau=tau)  # noqa: E731
    test_fn = lambda: iter([{k: v[0, :B]  # noqa: E731
                             for k, v in batch_fn(1).items()}])
    ts.run(3, batch_fn, test_data_fn=test_fn, test_every=2,
           snapshot_prefix=prefix, snapshot_every=2)
    assert ts.iter == 6
    assert [m.split(":")[0] for m in log if "test loss" in m] == \
        ["round 0", "round 2"]
    resumed = LocalSGDSolver(_sp(TMessage), workers=2, tau=2,
                             net_param=tzoo.cifar10_full(batch_size=B),
                             device="cpu", log_fn=log.append)
    resumed.run(1, batch_fn, snapshot_prefix=prefix, resume="auto")
    assert any("restored iter 4" in m for m in log)
    assert resumed.iter == 6


def test_refuses_what_is_not_ported(tmp_path):
    # host_axis, staleness and the arms are the JAX solver's now; what is
    # refused is a host axis of another name and a grid that does not
    # divide the workers
    for kw, what in ((dict(host_axis="model"), "host_axis"),
                     (dict(host_axis="host", hosts=3), "not divisible"),
                     (dict(hosts=2), "hosts needs host_axis")):
        with pytest.raises(ValueError, match=what):
            _port_local(2, **kw)
    assert _port_local(2, staleness=1).staleness == 1
    ts = _port_local(2)
    assert ts.arm_elastic(quorum=1).n == 2
    assert ts.arm_staleness(2).staleness == 2
    hb = ts.arm_heartbeat(str(tmp_path / "hb"), relay=False)
    assert hb.n == 1 and ts._relay is None
    ts.close()
    with pytest.raises(ValueError, match="batch 6 not divisible by mesh "
                                         "axis size 4"):
        DataParallelSolver(_sp(TMessage), workers=4,
                           net_param=tzoo.cifar10_full(batch_size=6),
                           device="cpu", log_fn=None)
    with pytest.raises(ValueError, match="feed blob 'data': got shape"):
        ts.train_round(_round_batches(3, seed=1))
