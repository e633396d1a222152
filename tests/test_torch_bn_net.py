"""The stock BatchNorm/Sigmoid CIFAR net (zoo.cifar10_full_sigmoid_bn, the
layer list of Caffe's cifar10_full_sigmoid_train_test_bn.prototxt) in
the port's solvers against the JAX package's, on the CPU at batch 8: its
three BatchNorm layers' state blobs [mean * s, var * s, s] are carried
by the compiler, the Solver, the 2-slot LocalSGDSolver, the snapshots
in both directions and the serve verb.

The JAX package has no such zoo entry; it reads the same net as the
port's DSL writes it (text_format, one package to the other). Both
start from the same weights and state through a JAX snapshot, after one
JAX step so that the state is not zero.

Tolerances (float32 on both sides): losses and test outputs rtol 1e-5;
params read by their change, each blob's max |port - jax| within 1e-3
of the JAX change's largest element (as in test_torch_parallel.py); the
BN state blobs within 1e-4 of each blob's largest element (their
batch statistics sum the convolutions' outputs, which the two
frameworks sum in different orders).
"""

import json
import os
import re
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
import torch

from sparknet_tpu.parallel import DataParallelSolver as JDataParallel
from sparknet_tpu.parallel import LocalSGDSolver as JLocalSGD, make_mesh
from sparknet_tpu.proto import Message as JMessage
from sparknet_tpu.proto import text_format as jtf
from sparknet_tpu.solver import Solver as JSolver
from sparknet_tpu_torch.models import zoo as tzoo
from sparknet_tpu_torch.parallel import DataParallelSolver, LocalSGDSolver
from sparknet_tpu_torch.proto import Message as TMessage
from sparknet_tpu_torch.proto import text_format as ttf
from sparknet_tpu_torch.solver import Solver as TSolver

B = 8
LIMIT = 1e-3
STATE_LIMIT = 1e-4
BN = ("bn1", "bn2", "bn3")
MAF = 0.999                     # moving_average_fraction's default


def _nets(batch=B):
    tnet = tzoo.cifar10_full_sigmoid_bn(batch_size=batch)
    return jtf.loads(ttf.dumps(tnet), "NetParameter"), tnet


def _sp(message):
    return message("SolverParameter", base_lr=0.01, momentum=0.9,
                   weight_decay=0.004, lr_policy="fixed", random_seed=3,
                   display=0)


def _batch(seed, n=B, lead=()):
    rs = np.random.RandomState(seed)
    return {"data": rs.randn(*lead, n, 3, 32, 32).astype(np.float32),
            "label": rs.randint(0, 10, lead + (n,)).astype(np.int32)}


def _np(tree):
    return {n: [np.asarray(p.detach() if torch.is_tensor(p) else p,
                           np.float64) for p in ps]
            for n, ps in tree.items()}


def _worst(pairs):
    worst, where = 0.0, None
    for name, got, ref in pairs:
        e = float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()),
                                                 1e-30)
        if e > worst:
            worst, where = e, name
    return worst, where


def _assert_params(ts, js, w0):
    got, ref = _np(ts.params), _np(js.params)
    err, where = _worst((f"{n}[{i}]", got[n][i] - w0[n][i],
                         ref[n][i] - w0[n][i])
                        for n in ref for i in range(len(ref[n])))
    assert err <= LIMIT, f"params differ by {err:.3e} of the change at {where}"


def _assert_state(ts, js, updates):
    got, ref = _np(ts.state), _np(js.state)
    assert sorted(got) == sorted(ref) == list(BN)
    err, where = _worst((f"{n}[{i}]", got[n][i], ref[n][i])
                        for n in BN for i in range(3))
    assert err <= STATE_LIMIT, f"BN state differs by {err:.3e} at {where}"
    s = sum(MAF ** i for i in range(updates))
    for n in BN:
        np.testing.assert_allclose(got[n][2], [s], rtol=1e-6)
        assert np.abs(got[n][0]).max() > 0 and got[n][1].min() > 0


def _start_together(tmp_path, js, ts):
    """One JAX step (the state leaves zero), then the port restores the
    JAX snapshot: weights, BN state and history. -> the starting
    params."""
    js.train_step(_batch(0))
    _, state = js.snapshot(str(tmp_path / "start"))
    ts.restore(state)
    for n in BN:
        for t, j in zip(ts.state[n], js.state[n]):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    return _np(js.params)


def test_solver_steps_match_jax(tmp_path):
    jnet, tnet = _nets()
    js = JSolver(_sp(JMessage), net_param=jnet, log_fn=None)
    ts = TSolver(_sp(TMessage), net_param=tnet, device="cpu", log_fn=None)
    w0 = _start_together(tmp_path, js, ts)
    for seed in (1, 2, 3):
        b = _batch(seed)
        np.testing.assert_allclose(float(ts.train_step(b)),
                                   float(js.train_step(b)), rtol=1e-5)
    _assert_params(ts, js, w0)
    _assert_state(ts, js, updates=4)
    # the TEST net reads the TRAIN net's state: its outputs agree, and
    # they are not those of a net that ignores the state
    test = _batch(9)
    got, ref = ts.test(iter([test])), js.test(iter([test]))
    for k in ref:
        np.testing.assert_allclose(got[k], np.asarray(ref[k]), rtol=1e-5)
    stale = {n: [torch.zeros_like(t) for t in v] for n, v in ts.state.items()}
    with torch.inference_mode():
        blobs, _ = ts.test_net.apply(ts.params, stale, test, train=False)
    assert abs(float(blobs["loss"]) - float(got["loss"])) > 1e-3


def test_local_sgd_round_matches_jax(tmp_path):
    workers, tau = 2, 2
    jnet, tnet = _nets()
    js = JLocalSGD(_sp(JMessage), mesh=make_mesh({"data": workers}),
                   tau=tau, net_param=jnet, log_fn=None)
    ts = LocalSGDSolver(_sp(TMessage), workers=workers, tau=tau,
                        net_param=tnet, device="cpu", log_fn=None)
    # from the JAX solver's snapshot before any round: each slot's
    # history is its own after a round, and a snapshot holds slot 0's
    _, state = js.snapshot(str(tmp_path / "start"))
    ts.restore(state)
    w0 = _np(js.params)
    for seed in (5, 6):     # the second round starts from a nonzero state
        batches = _batch(seed, n=workers * B, lead=(tau,))
        np.testing.assert_allclose(float(ts.train_round(batches)),
                                   float(js.train_round(batches)),
                                   rtol=1e-5)
    _assert_params(ts, js, w0)
    # each slot's state moves tau updates a round, then the slots' mean
    _assert_state(ts, js, updates=2 * tau)


def test_data_parallel_steps_match_jax(tmp_path):
    """Each slot's state from its shard, averaged over the slots every
    step (the JAX package's pmean)."""
    workers = 2
    jnet, tnet = _nets(workers * B)
    js = JDataParallel(_sp(JMessage), mesh=make_mesh({"data": workers}),
                       net_param=jnet, log_fn=None)
    ts = DataParallelSolver(_sp(TMessage), workers=workers, net_param=tnet,
                            device="cpu", log_fn=None)
    _, state = js.snapshot(str(tmp_path / "start"))
    ts.restore(state)
    w0 = _np(js.params)
    for seed in (1, 2):
        b = _batch(seed, n=workers * B)
        np.testing.assert_allclose(float(ts.train_step(b)),
                                   float(js.train_step(b)), rtol=1e-5)
    _assert_params(ts, js, w0)
    _assert_state(ts, js, updates=2)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_snapshots_carry_the_bn_blobs(tmp_path, direction):
    jnet, tnet = _nets()
    js = JSolver(_sp(JMessage), net_param=jnet, log_fn=None)
    ts = TSolver(_sp(TMessage), net_param=tnet, device="cpu", log_fn=None)
    src, dst = (ts, js) if direction == "port_to_jax" else (js, ts)
    for seed in (1, 2):
        src.train_step(_batch(seed))
    _, state = src.snapshot(str(tmp_path / "snap"))
    dst.restore(state)
    assert dst.iter == 2
    got, ref = _np(dst.state), _np(src.state)
    for n in BN:
        for i in range(3):
            np.testing.assert_array_equal(got[n][i], ref[n][i])
        assert ref[n][2][0] == pytest.approx(1 + MAF)
    for n, ps in _np(src.params).items():
        for a, b in zip(ps, _np(dst.params)[n]):
            np.testing.assert_array_equal(a, b)
    b = _batch(4)
    np.testing.assert_allclose(float(ts.train_step(b)),
                               float(js.train_step(b)), rtol=1e-5)


def _post(url, rows):
    req = urllib.request.Request(
        url + "/predict", data=json.dumps({"data": rows.tolist()}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_serve_verb_answers_as_the_test_net(tmp_path):
    _, tnet = _nets()
    ts = TSolver(_sp(TMessage), net_param=tnet, device="cpu", log_fn=None)
    for seed in (1, 2):
        ts.train_step(_batch(seed))
    prefix = str(tmp_path / "bn")
    ts.snapshot(prefix)
    rows = _batch(7)["data"]
    with torch.inference_mode():
        blobs, _ = ts.test_net.apply(ts.params, ts.state,
                                     {"data": rows, "label": _batch(7)[
                                         "label"]}, train=False)
    ref = blobs["ip1"].numpy()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "sparknet_tpu_torch", "serve", "--prefix",
         prefix, "--device", "cpu", "--max_batch", "4", "--reload_poll",
         "0"], cwd=repo, env=dict(os.environ, PYTHONPATH=repo),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        url = None
        for line in proc.stdout:
            m = re.search(r"listening on (http://\S+)", line)
            if m:
                url = m.group(1)
                break
        assert url, "server never announced its address"
        for lo, hi in ((0, 3), (3, 7)):
            out = _post(url, rows[lo:hi])
            got = np.asarray(out["outputs"]["ip1"], np.float32)
            np.testing.assert_allclose(got, ref[lo:hi], rtol=1e-5,
                                       atol=1e-6 * np.abs(ref).max())
        proc.terminate()
        proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
