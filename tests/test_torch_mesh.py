"""The port's slot meshes, slot collectives, parallelism context, gradient
buckets and sharding rules against the JAX package on the CPU.

Each slot collective (parallel/mesh.py) takes one tensor a slot; the JAX
collective runs under shard_map over the 8-device virtual CPU mesh of
tests/conftest.py, one device a slot, on the same seeded numpy inputs.
Sums agree within 1e-6 (f32 in another order); the data movements
(all_gather, ppermute, all_to_all) bit for bit. The bucket plan, the
FSDP plan and the tensor-parallel rule are compared entry for entry on
the LM's params.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from sparknet_tpu.graph.compiler import CompiledNet as JNet
from sparknet_tpu.models import zoo as jzoo
from sparknet_tpu.parallel import make_mesh as jmesh
from sparknet_tpu.parallel import fsdp as jfsdp, gspmd as jgspmd, \
    overlap as joverlap
from sparknet_tpu.parallel.compat import shard_map
from sparknet_tpu.resilience import elastic as jel
from sparknet_tpu_torch.graph.compiler import CompiledNet as TNet
from sparknet_tpu_torch.models import zoo as tzoo
from sparknet_tpu_torch.parallel import context, fsdp, gspmd, mesh, overlap
from sparknet_tpu_torch.resilience import elastic as tel

TOL = 1e-6
AXES = {"a": 2, "b": 4}          # 8 slots: "b" groups of 4, "a" of 2


def _global(seed, shape=(8, 8, 6)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _jax(fn, x, axes=AXES, out_spec=None):
    """fn over the slots of a 2-D mesh: slot (a, b) holds x[a*4 + b]."""
    m = jmesh(axes)
    names = tuple(axes)
    xs = jnp.asarray(x).reshape(tuple(axes.values()) + x.shape[1:])
    f = shard_map(lambda v: fn(v[0, 0])[None, None], mesh=m,
                  in_specs=P(*names), out_specs=P(*names), check_vma=False)
    out = np.asarray(jax.jit(f)(xs))
    return out.reshape((-1,) + out.shape[2:])


def _port(fn, x, axes=AXES):
    sm = mesh.SlotMesh(axes)
    out = fn([torch.from_numpy(v) for v in x], sm)
    return np.stack([o.numpy() for o in out])


@pytest.mark.parametrize("axis", ["a", "b"])
def test_slot_collectives_equal_the_jax_collectives(axis):
    x = _global(0)
    cases = [
        (lambda v: jax.lax.psum(v, axis),
         lambda xs, m: mesh.psum(xs, m, axis), TOL),
        (lambda v: jax.lax.pmean(v, axis),
         lambda xs, m: mesh.pmean(xs, m, axis), TOL),
        (lambda v: jax.lax.all_gather(v, axis, axis=1, tiled=True),
         lambda xs, m: mesh.all_gather(xs, m, axis, dim=1), 0),
        (lambda v: jax.lax.psum_scatter(v, axis, scatter_dimension=0,
                                        tiled=True),
         lambda xs, m: mesh.psum_scatter(xs, m, axis, dim=0), TOL),
        (lambda v: jax.lax.ppermute(
            v, axis, [(i, (i + 1) % AXES[axis]) for i in range(AXES[axis])]),
         lambda xs, m: mesh.ppermute(xs, m, axis), 0),
        (lambda v: jax.lax.all_to_all(v, axis, split_axis=0, concat_axis=1,
                                      tiled=True),
         lambda xs, m: mesh.all_to_all(xs, m, axis, split_dim=0,
                                       concat_dim=1), 0),
    ]
    for jfn, tfn, tol in cases:
        want, got = _jax(jfn, x), _port(tfn, x)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=tol * np.abs(want).max())


def test_collective_gradients_are_the_transposes():
    """autograd through the slot collectives gives the JAX transposes:
    d/dx of sum(w_i * collective(x)_i) for ppermute and all_to_all."""
    x = _global(1, (8, 8, 4))
    m = jmesh(AXES)
    for jfn, tfn in (
            (lambda v: jax.lax.ppermute(v, "b", [(i, (i + 1) % 4)
                                                 for i in range(4)]),
             lambda xs, sm: mesh.ppermute(xs, sm, "b")),
            (lambda v: jax.lax.all_to_all(v, "b", split_axis=0,
                                          concat_axis=1, tiled=True),
             lambda xs, sm: mesh.all_to_all(xs, sm, "b", 0, 1))):
        xs = [torch.from_numpy(v).requires_grad_(True) for v in x]
        out = tfn(xs, mesh.SlotMesh(AXES))
        wts = _global(2, (8,) + tuple(out[0].shape))
        sum((o * torch.from_numpy(w)).sum()
            for o, w in zip(out, wts)).backward()
        got = np.stack([t.grad.numpy() for t in xs])
        f = shard_map(lambda v: jfn(v[0, 0])[None, None], mesh=m,
                      in_specs=P("a", "b"), out_specs=P("a", "b"),
                      check_vma=False)
        want = np.asarray(jax.grad(lambda v: jnp.sum(
            f(v) * jnp.asarray(wts).reshape((2, 4) + wts.shape[1:])))(
            jnp.asarray(x).reshape(2, 4, 8, 4))).reshape(8, 8, 4)
        np.testing.assert_array_equal(got, want)


def test_mesh_layout_and_context():
    sm = mesh.make_mesh({"data": 2, "seq": -1, "expert": 3})
    assert sm.shape == {"data": 2, "seq": 1, "expert": 3} and sm.size == 6
    assert [sm.coords(w) for w in (0, 4)] == [
        {"data": 0, "seq": 0, "expert": 0}, {"data": 1, "seq": 0,
                                             "expert": 1}]
    assert sm.groups("expert") == [[0, 1, 2], [3, 4, 5]]
    assert sm.groups("data") == [[0, 3], [1, 4], [2, 5]]
    assert sm.groups("pipe") == [[w] for w in range(6)]
    assert mesh.make_tp_mesh(4).shape == {"data": 1, "model": 4}
    assert mesh.mesh_axis_size(sm, "pipe") == 1
    with pytest.raises(ValueError, match="at most one"):
        mesh.make_mesh({"data": -1, "seq": -1})
    with context.axis_context(seq="seq"), context.slot_context(sm, 4):
        assert context.axis("seq") == "seq"
        assert context.axis_index("seq") == 0
        with context.axis_context(seq="expert"):
            assert context.axis_index("seq") == 1
    assert context.axis("seq") is None and context.axis_index("seq") == 0
    assert mesh.local_batch_slice(8) == (0, 8)


def _lm_params():
    jn = JNet(jzoo.transformer_lm(vocab_size=64, seq_len=32, batch_size=2,
                                  d_model=32, num_layers=2, num_heads=4,
                                  moe_experts=4), 0)
    tn = TNet(tzoo.transformer_lm(vocab_size=64, seq_len=32, batch_size=2,
                                  d_model=32, num_layers=2, num_heads=4,
                                  moe_experts=4), 0, device="cpu")
    return jn.init(jax.random.PRNGKey(0))[0], tn.init()[0]


def test_bucket_plan_and_bucketed_consensus_match_jax():
    jp, tp_ = _lm_params()
    for mb in (None, 1e-3):
        limit = None if mb is None else int(mb * (1 << 20))
        jplan = joverlap.plan_buckets(jp, max_bytes=limit)
        tplan = overlap.plan_buckets(tp_, max_bytes=limit)
        assert len(tplan["buckets"]) == len(jplan["buckets"]) > 0
        for tb, jb in zip(tplan["buckets"], jplan["buckets"]):
            assert [(i, s, n) for i, s, _, n in tb] == \
                [(i, tuple(s), n) for i, s, _, n in jb]
        assert overlap.bucket_sizes(tplan) == joverlap.bucket_sizes(jplan)
    # the bucketed consensus equals the whole-tree one, bit for bit, for
    # every valid mask and under the staleness weights
    rs = np.random.RandomState(3)
    stacked = {n: [torch.from_numpy(rs.randn(4, *p.shape).astype(
        np.float32)) for p in ps] for n, ps in tp_.items()}
    for valid in ([1, 1, 1, 1], [1, 0, 1, 1]):
        v = torch.tensor(valid, dtype=torch.float32)
        for fn in (tel.masked_consensus, tel.weighted_consensus):
            want, n_want = fn(stacked, v)
            got, n_got = overlap.bucketed_consensus(fn, stacked, v)
            assert float(n_got) == float(n_want)
            for name in want:
                for a, b in zip(got[name], want[name]):
                    assert torch.equal(a, b), name
    # ... and JAX's bucketed masked consensus, within f32 rounding
    leaf = stacked["block0/attn"][0].numpy()
    want = jax.jit(shard_map(
        lambda x, v: joverlap.bucketed_consensus(
            jel.masked_consensus, x[0], v[0], "data")[0][None],
        mesh=jmesh({"data": 4}), in_specs=(P("data"), P("data")),
        out_specs=P("data"), check_vma=False))(
        jnp.asarray(leaf), jnp.ones(4))
    got = overlap.bucketed_consensus(
        tel.masked_consensus, [torch.from_numpy(leaf)], torch.ones(4))[0][0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[0], atol=TOL)


def test_overlap_gates(monkeypatch):
    monkeypatch.setenv("SPARKNET_OVERLAP", "off")
    assert not overlap.overlap_enabled()
    monkeypatch.setenv("SPARKNET_OVERLAP", "maybe")
    with pytest.raises(ValueError, match="on|off"):
        overlap.overlap_enabled()
    monkeypatch.setenv("SPARKNET_BUCKET_MB", "0")
    with pytest.raises(ValueError, match="must be > 0"):
        overlap.bucket_bytes()


@pytest.mark.parametrize("n,min_size", [(2, None), (4, 64), (3, 64)])
def test_fsdp_plan_matches_jax(n, min_size):
    jp, tp_ = _lm_params()
    want = jfsdp.plan_param_specs(jp, n, "data", min_size=min_size)
    got = fsdp.plan_param_specs(tp_, n, "data", min_size=min_size)
    for name in want:
        assert [tuple(s) for s in want[name]] == got[name], name
    j_hist = {k: [[p, p] for p in v] for k, v in jp.items()}
    t_hist = {k: [[p, p] for p in v] for k, v in tp_.items()}
    jb = jfsdp.sharded_bytes(j_hist, jfsdp.plan_param_specs(
        j_hist, n, "data", min_size=min_size), n)
    tb = fsdp.sharded_bytes(t_hist, fsdp.plan_param_specs(
        t_hist, n, "data", min_size=min_size), n)
    assert tb == jb


@pytest.mark.parametrize("tp", [2, 4, 3])
def test_tp_rules_match_jax(tp):
    jp, tp_ = _lm_params()
    for jrule, trule in (
            (jgspmd.transformer_tp_rule(tp), gspmd.transformer_tp_rule(tp)),
            (jgspmd.default_param_rule(tp, min_size=256),
             gspmd.default_param_rule(tp, min_size=256))):
        for name, blobs in jp.items():
            for i, b in enumerate(blobs):
                shape = tuple(b.shape)
                assert trule(name, i, shape) == \
                    tuple(jrule(name, i, shape)), (name, i)


@pytest.mark.parametrize("solver", ["dp", "fsdp"])
def test_bucketed_comms_registration_matches_jax(solver, monkeypatch):
    """Under SPARKNET_OVERLAP (the default) the data-parallel and FSDP
    solvers register the slot average per reverse-order bucket, each but
    the last overlappable, as the JAX solvers do (ROADMAP A6b)."""
    from sparknet_tpu.obs.comms import CommsMeter as JComms
    from sparknet_tpu.parallel import (DataParallelSolver as JDP,
                                       FSDPSolver as JFSDP)
    from sparknet_tpu.proto import Message as JMessage
    from sparknet_tpu_torch.obs.comms import CommsMeter as TComms
    from sparknet_tpu_torch.parallel import DataParallelSolver, FSDPSolver
    from sparknet_tpu_torch.proto import Message as TMessage
    monkeypatch.setenv("SPARKNET_OVERLAP", "on")
    monkeypatch.setenv("SPARKNET_BUCKET_MB", "0.01")
    lm = dict(vocab_size=64, seq_len=32, batch_size=4, d_model=32,
              num_layers=2, num_heads=4, flash=False)
    jcls, tcls = (JDP, DataParallelSolver) if solver == "dp" else \
        (JFSDP, FSDPSolver)
    kw = {} if solver == "dp" else {"min_shard_size": 64}
    js = jcls(JMessage("SolverParameter", base_lr=0.1, random_seed=1,
                       lr_policy="fixed"),
              mesh=jmesh({"data": 2}), net_param=jzoo.transformer_lm(**lm),
              log_fn=None, **kw)
    ts = tcls(TMessage("SolverParameter", base_lr=0.1, random_seed=1,
                       lr_policy="fixed"),
              mesh=mesh.make_mesh({"data": 2}),
              net_param=tzoo.transformer_lm(**lm), device="cpu",
              log_fn=None, **kw)
    jc, tc = JComms(None), TComms(None)
    js._register_comms(jc)
    ts._register_comms(tc)
    assert len(tc.collectives) == len(jc.collectives) > 3
    assert tc.collectives == jc.collectives
