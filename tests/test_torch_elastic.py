"""Elastic membership, bounded staleness and the two-tier round: the
port against the JAX package on the CPU.

The device half of resilience/elastic.py reduces over the slot dimension
of stacked blobs; the JAX functions run under shard_map over an 8-device
virtual CPU mesh (tests/conftest.py) on the same seeded numpy inputs,
and agree within 1e-6 (f32 sums in another order).

The solvers: a tiny net with one across-channel LRN, the same weights
carried across through a JAX snapshot (.caffemodel + .solverstate), the
same batches. The port's two-tier LocalSGDSolver against JAX's
LocalSGDSolver(host_axis="host") over a (2, 2) mesh, its elastic rounds
with a killed worker (and a killed host), its async bounded-staleness
round under a fixed lag schedule, and its elastic DataParallelSolver
step: each round's loss within rtol 1e-5, each weight blob within 1e-5
of its largest element. The two degeneracies hold bit for bit on the
CPU: one slot a host is the single-tier round, one host is tau
DataParallelSolver steps.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as P

from sparknet_tpu.models import dsl as jdsl, zoo as jzoo
from sparknet_tpu.parallel import (DataParallelSolver as JDataParallel,
                                   LocalSGDSolver as JLocalSGD, make_mesh,
                                   make_host_device_mesh)
from sparknet_tpu.parallel.compat import shard_map
from sparknet_tpu.proto import Message as JMessage
from sparknet_tpu.resilience import chaos as jchaos
from sparknet_tpu.resilience import elastic as jel
from sparknet_tpu_torch.models import dsl as tdsl, zoo as tzoo
from sparknet_tpu_torch.parallel import DataParallelSolver, LocalSGDSolver
from sparknet_tpu_torch.proto import Message as TMessage
from sparknet_tpu_torch.resilience import chaos as tchaos
from sparknet_tpu_torch.resilience import elastic as tel

TOL = 1e-6          # the consensus functions
SOLVER_TOL = 1e-5   # losses (rtol) and weights (of each blob's largest)
B, TAU = 2, 2


# -- the device half --------------------------------------------------------

def _tree(n, seed, nonfinite=()):
    rs = np.random.RandomState(seed)
    t = {"conv": [rs.randn(n, 4, 3, 2, 2).astype(np.float32),
                  rs.randn(n, 4).astype(np.float32)],
         "fc": [rs.randn(n, 5, 6).astype(np.float32)]}
    for w in nonfinite:
        t["conv"][0][w, 1, 2] = np.nan
        t["fc"][0][w, 0, 0] = np.inf
    return t


def _jax_run(fn, tree, *vecs):
    """fn(tree shard, one scalar of each vec) under shard_map over a
    "data" axis of len(vec) devices; every output replicated."""
    n = len(vecs[0])
    specs = jax.tree_util.tree_map(lambda _: P("data"), tree)

    def f(t, *v):
        w = jax.lax.axis_index("data")
        return fn(t, *[x[w] for x in v])

    g = jax.jit(shard_map(f, mesh=make_mesh({"data": n}),
                          in_specs=(specs,) + (P(),) * len(vecs),
                          out_specs=P(), check_vma=False))
    return jax.device_get(g(tree, *[jnp.asarray(v, jnp.float32)
                                    for v in vecs]))


def _torch_tree(tree):
    return {k: [torch.from_numpy(a.copy()) for a in v]
            for k, v in tree.items()}


def _close(got, ref, what):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    ref = np.asarray(ref, np.float64).reshape(got.shape)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL, err_msg=what)


def _close_trees(got, ref, what):
    for k in ref:
        for i, r in enumerate(ref[k]):
            _close(got[k][i], np.asarray(r)[0] if np.ndim(r) ==
                   got[k][i].dim() + 1 else r, f"{what} {k}[{i}]")


MASKS = {
    "all-valid": ([1, 1, 1, 1], ()),
    "one-dead": ([1, 0, 1, 1], ()),
    "nonfinite": ([1, 1, 1, 0], (3,)),
    "all-dead": ([0, 0, 0, 0], ()),
}


@pytest.mark.parametrize("case", sorted(MASKS))
def test_masked_consensus_matches_jax(case):
    valid, bad = MASKS[case]
    tree = _tree(4, seed=1, nonfinite=bad)
    ref, ref_n = _jax_run(lambda t, v: jel.masked_consensus(t, v, "data"),
                          tree, valid)
    got, n = tel.masked_consensus(_torch_tree(tree),
                                  torch.tensor(valid, dtype=torch.float32))
    _close_trees(got, ref, case)
    assert float(n) == float(ref_n) == sum(valid)
    for k in got:
        assert all(torch.isfinite(x).all() for x in got[k])


@pytest.mark.parametrize("case", sorted(MASKS))
def test_masked_consensus_stats_and_scalar_mean_match_jax(case):
    valid, bad = MASKS[case]
    tree = _tree(4, seed=2, nonfinite=bad)
    losses = np.asarray([0.5, 1.5, np.nan if bad else 2.5, 3.5],
                        np.float32)
    (ref, aux), ref_mean = _jax_run(
        lambda t, v, l: (jel.masked_consensus_stats(t, v, "data"),
                         jel.masked_scalar_mean(l, v, "data")),
        tree, valid, losses)
    tv = torch.tensor(valid, dtype=torch.float32)
    got, gaux = tel.masked_consensus_stats(_torch_tree(tree), tv)
    _close_trees(got, ref, case)
    for key in ("div_mean_sq", "div_max_sq", "div_worker_sq", "valid",
                "n_live"):
        _close(gaux[key], aux[key], f"{case} {key}")
    for k, v in aux["layer_div_sq"].items():
        _close(gaux["layer_div_sq"][k], v, f"{case} layer {k}")
    _close(tel.masked_scalar_mean(torch.from_numpy(losses), tv), ref_mean,
           f"{case} scalar mean")


def test_finite_checks_match_jax():
    tree = _tree(4, seed=3, nonfinite=(1, 2))
    want = jax.device_get(jax.jit(shard_map(
        lambda t: jax.lax.all_gather(jel.tree_finite(t), "data"),
        mesh=make_mesh({"data": 4}),
        in_specs=(jax.tree_util.tree_map(lambda _: P("data"), tree),),
        out_specs=P(), check_vma=False))(tree))
    got = tel.slots_finite(_torch_tree(tree))
    assert got.tolist() == np.asarray(want).ravel().astype(bool).tolist() \
        == [True, False, False, True]
    assert bool(tel.tree_finite({"a": [torch.ones(3)]}))
    assert not bool(tel.tree_finite({"a": [torch.tensor([1.0, np.nan])]}))


@pytest.mark.parametrize("s,decay", [(0, 0.5), (1, 0.5), (2, 0.25),
                                     (3, 1.0)])
def test_staleness_and_weighted_consensus_match_jax(s, decay):
    lag = np.asarray([0, 1, 2, 3], np.float32)
    valid = np.asarray([1, 1, 1, 0], np.float32)
    tree = _tree(4, seed=4, nonfinite=(3,))
    np.testing.assert_array_equal(
        tel.staleness_discount(torch.from_numpy(lag), s, decay).numpy(),
        np.asarray(jel.staleness_discount(lag, s, decay)))

    def jfn(t, v, l):
        w = v * jel.staleness_discount(l, s, decay)
        return (jel.weighted_consensus(t, w, "data"),
                jel.weighted_consensus_stats(t, v, w, "data"))

    (ref, ref_sum), (_, aux) = _jax_run(jfn, tree, valid, lag)
    tv = torch.from_numpy(valid)
    weight = tv * tel.staleness_discount(torch.from_numpy(lag), s, decay)
    got, wsum = tel.weighted_consensus(_torch_tree(tree), weight)
    _close_trees(got, ref, f"s={s}")
    _close(wsum, ref_sum, "weight sum")
    _, gaux = tel.weighted_consensus_stats(_torch_tree(tree), tv, weight)
    for key in ("div_mean_sq", "div_max_sq", "div_worker_sq", "valid",
                "weight", "n_live"):
        _close(gaux[key], aux[key], f"s={s} {key}")


def test_all_valid_consensus_is_the_plain_mean_bit_for_bit():
    tree = _torch_tree(_tree(5, seed=5))
    ones = torch.ones(5)
    for fn in (lambda: tel.masked_consensus(tree, ones)[0],
               lambda: tel.weighted_consensus(tree, ones)[0]):
        got = fn()
        for k, blobs in tree.items():
            for g, b in zip(got[k], blobs):
                assert torch.equal(g, b.mean(0))


def test_expand_to_slots_matches_jax():
    shards = [np.full((2, 3), i, np.float32) for i in range(3)]
    owners = [0, 1, 0, 2]
    np.testing.assert_array_equal(tel.expand_to_slots(shards, owners),
                                  jel.expand_to_slots(shards, owners))


# -- the solvers --------------------------------------------------------------

def _net(dsl, zoo, batch):
    return dsl.NetParam(
        "ElasticNet", dsl.RDDLayer("data", [batch, 3, 8, 8]),
        dsl.RDDLayer("label", [batch]),
        zoo._gconv("conv1", "data", 8, 3, pad=1),
        dsl.ReLULayer("relu1", ["conv1"], tops=["conv1"]),
        dsl.LRNLayer("norm1", ["conv1"], local_size=5, alpha=0.1,
                     beta=0.75),
        zoo._fc("ip", "norm1", 10),
        dsl.SoftmaxWithLoss("loss", ["ip", "label"]))


def _sp(message):
    return message("SolverParameter", base_lr=0.05, lr_policy="step",
                   gamma=0.5, stepsize=2, momentum=0.9, weight_decay=0.004,
                   random_seed=3, display=0)


def _batches(slots, seed, tau=TAU):
    rs = np.random.RandomState(seed)
    return {"data": rs.randn(tau, slots * B, 3, 8, 8).astype(np.float32),
            "label": rs.randint(0, 10, (tau, slots * B)).astype(np.int32)}


def _pair(tmp_path, hosts=None, slots=4, chaos=None, dp=False):
    """(JAX solver, port solver) from one JAX snapshot, with ``chaos``
    armed in both packages while they are built."""
    jchaos.install_chaos(jchaos.ChaosMonkey.parse(chaos) if chaos else None)
    tchaos.install_chaos(tchaos.ChaosMonkey.parse(chaos) if chaos else None)
    try:
        if dp:
            js = JDataParallel(_sp(JMessage), mesh=make_mesh({"data": slots}),
                               net_param=_net(jdsl, jzoo, slots * B),
                               log_fn=None)
            ts = DataParallelSolver(_sp(TMessage), workers=slots,
                                    net_param=_net(tdsl, tzoo, slots * B),
                                    device="cpu", log_fn=None)
        elif hosts:
            js = JLocalSGD(_sp(JMessage), tau=TAU, host_axis="host",
                           mesh=make_host_device_mesh(
                               hosts=hosts, per_host=slots // hosts),
                           net_param=_net(jdsl, jzoo, B), log_fn=None)
            ts = LocalSGDSolver(_sp(TMessage), workers=slots, tau=TAU,
                                host_axis="host", hosts=hosts,
                                net_param=_net(tdsl, tzoo, B), device="cpu",
                                log_fn=None)
        else:
            js = JLocalSGD(_sp(JMessage), tau=TAU,
                           mesh=make_mesh({"data": slots}),
                           net_param=_net(jdsl, jzoo, B), log_fn=None)
            ts = LocalSGDSolver(_sp(TMessage), workers=slots, tau=TAU,
                                net_param=_net(tdsl, tzoo, B), device="cpu",
                                log_fn=None)
    finally:
        jchaos.install_chaos(None)
        tchaos.install_chaos(None)
    _, state = js.snapshot(str(tmp_path / "start"))
    ts.restore(state)
    return js, ts


def _assert_weights_match(ts, js):
    for n, ps in js.params.items():
        for i, p in enumerate(ps):
            ref = np.asarray(p, np.float64)
            got = ts.params[n][i].detach().numpy().astype(np.float64)
            err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
            assert err <= SOLVER_TOL, f"{n}[{i}] differs by {err:.3e}"


def _rounds(js, ts, slots, seeds, step=None):
    for seed in seeds:
        b = _batches(slots, seed)
        if step is None:
            jl, tl = float(js.train_round(dict(b))), \
                float(ts.train_round(dict(b)))
        else:
            one = {k: v[0] for k, v in b.items()}
            jl, tl = float(js.train_step(one)), float(ts.train_step(one))
        np.testing.assert_allclose(tl, jl, rtol=SOLVER_TOL)
    _assert_weights_match(ts, js)


def test_two_tier_rounds_match_jax(tmp_path):
    js, ts = _pair(tmp_path, hosts=2)
    assert ts.mesh_shape == dict(js.mesh.shape) == {"host": 2, "data": 2}
    _rounds(js, ts, 4, (10, 11))
    # every host holds the consensus
    for ps in ts.slot_params.values():
        for P_ in ps:
            assert torch.equal(P_[0].expand_as(P_), P_)


@pytest.mark.parametrize("hosts,chaos", [
    (None, "kill_worker=3,kill_round=0"),
    (2, "kill_host=1,kill_host_round=0")], ids=["worker", "host"])
def test_elastic_rounds_with_a_kill_match_jax(tmp_path, hosts, chaos):
    js, ts = _pair(tmp_path, hosts=hosts, chaos=chaos)
    for s in (js, ts):
        s.arm_elastic(quorum=1, evict_after=1, readmit_after=2)
    _rounds(js, ts, 4, (20, 21, 22))
    assert ts.elastic.evictions == [
        {k: v for k, v in e.items()} for e in js.elastic.evictions]
    assert ts.elastic.readmissions == js.elastic.readmissions
    assert ts.elastic.alive.tolist() == js.elastic.alive.tolist()


def test_async_staleness_round_matches_jax_under_a_fixed_lag(tmp_path):
    js, ts = _pair(tmp_path)
    for s in (js, ts):
        s.arm_staleness(1, decay=0.5)
    lags = iter([[0, 1, 0, 2], [1, 0, 0, 0]])
    for seed in (30, 31):
        lag = next(lags)
        js._staleness_lag = lambda lag=lag: jnp.asarray(lag, jnp.float32)
        ts._staleness_lag = lambda lag=lag: torch.tensor(lag,
                                                         dtype=torch.float32)
        b = _batches(4, seed)
        np.testing.assert_allclose(float(ts.train_round(dict(b))),
                                   float(js.train_round(dict(b))),
                                   rtol=SOLVER_TOL)
    _assert_weights_match(ts, js)


def test_elastic_dp_steps_match_jax(tmp_path):
    js, ts = _pair(tmp_path, dp=True, chaos="kill_worker=1,kill_round=1")
    for s in (js, ts):
        s.arm_elastic(quorum=1, evict_after=1, readmit_after=5)
    _rounds(js, ts, 4, (40, 41, 42), step=True)
    assert [e["worker"] for e in ts.elastic.evictions] == \
        [e["worker"] for e in js.elastic.evictions] == [1]


def _port_round(solver, batches):
    return float(solver.train_round(dict(batches)))


def test_one_slot_a_host_is_the_single_tier_round_bit_for_bit():
    make = lambda **kw: LocalSGDSolver(  # noqa: E731
        _sp(TMessage), workers=4, tau=TAU, net_param=_net(tdsl, tzoo, B),
        device="cpu", log_fn=None, **kw)
    ref, hier = make(), make(host_axis="host", hosts=4)
    for seed in (50, 51):
        b = _batches(4, seed)
        assert _port_round(ref, b) == _port_round(hier, b)
    for n in ref.params:
        for a, c in zip(ref.params[n], hier.params[n]):
            assert torch.equal(a, c)


def test_one_host_is_data_parallel_steps_bit_for_bit():
    one = LocalSGDSolver(_sp(TMessage), workers=4, tau=TAU,
                         host_axis="host", hosts=1,
                         net_param=_net(tdsl, tzoo, B), device="cpu",
                         log_fn=None)
    dp = DataParallelSolver(_sp(TMessage), workers=4,
                            net_param=_net(tdsl, tzoo, 4 * B), device="cpu",
                            log_fn=None)
    for seed in (60, 61):
        b = _batches(4, seed)
        steps = [dp.train_step({k: v[i] for k, v in b.items()})
                 for i in range(TAU)]
        assert _port_round(one, b) == float(torch.stack(steps).mean())
    for n in dp.params:
        for a, c in zip(one.params[n], dp.params[n]):
            assert torch.equal(a, c)


def test_shrink_to_survivors_drops_the_dead_slots():
    """A persistent eviction with shrink_after: run() drops the dead
    slot's storage, the world stamp follows, and the next rounds train
    on the survivors (batch_fn sizes the batch off mesh_shape)."""
    tchaos.install_chaos(tchaos.ChaosMonkey.parse("kill_worker=2,"
                                                  "kill_round=0"))
    try:
        ts = LocalSGDSolver(_sp(TMessage), workers=4, tau=TAU,
                            net_param=_net(tdsl, tzoo, B), device="cpu",
                            log_fn=None)
    finally:
        tchaos.install_chaos(None)
    ts.arm_elastic(quorum=1, evict_after=1, readmit_after=0,
                   shrink_after=1)
    seeds = iter(range(70, 80))
    loss = ts.run(3, lambda tau: _batches(ts.mesh_shape["data"],
                                          next(seeds), tau))
    assert np.isfinite(loss)
    assert ts.mesh_shape == {"data": 3} and ts.workers == 3
    assert ts.elastic.n == 3 and ts.elastic.live() == [0, 1, 2]
    assert ts.slot_params["ip"][0].shape[0] == 3
    assert len(ts.slot_generators) == 3
