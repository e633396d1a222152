"""SolverParameter.debug_info in the port's Solver against the JAX
Solver: the same dump lines at the same display points, from the same
weights and batches, each value within 1e-4 relative."""

import re

import numpy as np
import jax
import torch

from sparknet_tpu.proto import Message as JMessage
from sparknet_tpu.solver import Solver as JSolver
from sparknet_tpu.models import dsl as jdsl
from sparknet_tpu_torch.graph import params_from_numpy
from sparknet_tpu_torch.models import dsl as tdsl
from sparknet_tpu_torch.proto import Message
from sparknet_tpu_torch.solver import Solver

LINE = re.compile(r"^    \[(Forward|Backward)\] Layer (\S+), "
                  r"(top|param) blob (\S+) (data|diff): (\S+)$")


def _net(dsl):
    """Shared params (ip2 reuses ip1's weight and bias by name) and a
    loss."""
    return dsl.NetParam(
        "dbg",
        dsl.RDDLayer("data", (4, 6)), dsl.RDDLayer("label", (4,)),
        dsl.InnerProductLayer("ip1", ["data"], 6, weight_filler=dict(
            type="gaussian", std=0.3),
            param=[dict(name="shared_w"), dict(name="shared_b")]),
        dsl.ReLULayer("relu", ["ip1"], tops=["ip1"]),
        dsl.InnerProductLayer("ip2", ["ip1"], 6, param=[
            dict(name="shared_w"), dict(name="shared_b")]),
        dsl.InnerProductLayer("out", ["ip2"], 3, weight_filler=dict(
            type="gaussian", std=0.3)),
        dsl.SoftmaxWithLoss("loss", ["out", "label"]))


def _batches(n):
    rs = np.random.RandomState(2)
    return [{"data": rs.randn(4, 6).astype(np.float32),
             "label": rs.randint(0, 3, 4).astype(np.int32)}
            for _ in range(n)]


def _dump(lines):
    return [m.groups() for m in map(LINE.match, lines) if m]


def test_debug_info_dumps_the_jax_solvers_lines():
    kw = dict(base_lr=0.1, lr_policy="fixed", momentum=0.9, display=2,
              debug_info=True)
    jlog, tlog = [], []
    js = JSolver(JMessage("SolverParameter", **kw), net_param=_net(jdsl),
                 log_fn=jlog.append)
    ts = Solver(Message("SolverParameter", **kw), net_param=_net(tdsl),
                device="cpu", log_fn=tlog.append)
    params, _ = params_from_numpy(
        ts.net, jax.tree_util.tree_map(np.asarray, js.params), {})
    with torch.no_grad():
        for k, v in params.items():
            for p, q in zip(ts.params[k], v):
                p.copy_(q)
    js.step(4, iter(_batches(4)))
    ts.step(4, iter(_batches(4)))
    got, want = _dump(tlog), _dump(jlog)
    assert len(want) == 2 * (7 + 6 + 6)        # two dumps: 7 tops, 6 slots
    assert [g[:5] for g in got] == [w[:5] for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g[5]), float(w[5]), rtol=1e-4,
                                   atol=1e-7, err_msg=str(g))
    # the shared weight is printed under both layers that use it
    assert ("Forward", "ip2", "param", "0", "data") in \
        [g[:5] for g in got]


def test_no_dump_without_debug_info():
    log = []
    ts = Solver(Message("SolverParameter", base_lr=0.1, lr_policy="fixed",
                        display=1), net_param=_net(tdsl), device="cpu",
                log_fn=log.append)
    ts.step(2, iter(_batches(2)))
    assert not _dump(log)
