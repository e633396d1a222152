"""The port's ExpertParallelSolver against the JAX package's on the CPU.

Under expert parallelism the MoE capacity is each source device's (the
JAX layer's rule, sparknet_tpu/ops/moe.py): under overflow the drop
order is per-device arrival order, so the port is held to the JAX
ExpertParallelSolver on the virtual CPU mesh, not to the single-device
MoE. A 2-layer MoE LM (4 experts, d 32, 2 heads, S 32, vocab 64, batch
4) from one JAX snapshot, 3 Adam steps on the same batches: ep 2; ep 4
with capacity factor 0.5 (about half the tokens overflow); and data 1 x
seq 2 x expert 2 with ring attention. Losses within 1e-5 relative, every
param within 1e-4, the routing diagnostics (each expert's token
fraction and the overflow, averaged over the slots) within 1e-6.

Routing is an argmax over router logits: before each step both packages'
logits of every token are computed from their own params, and every
token whose top-2 margin clears twice the two packages' logit
difference must go to the same expert (the seed-free check of ROADMAP
C12, tests/test_torch_mesh_parity.py), at most 2% of them inside it.

A gradient clip is held to one device instead (ROADMAP C24): the JAX
solver runs its updater inside shard_map, so Caffe's global-norm clip
sees each slot's own expert rows there; the port clips the whole
gradient by its global norm, as Caffe and the port's FSDP do.
"""

import jax
import numpy as np
import pytest
import torch

from sparknet_tpu.graph.compiler import CompiledNet as JNet
from sparknet_tpu.models import zoo as jzoo
from sparknet_tpu.parallel import (ExpertParallelSolver as JEP,
                                   make_mesh as jmesh)
from sparknet_tpu.proto import Message as JMessage
from sparknet_tpu_torch.data import lm_batch_stream
from sparknet_tpu_torch.graph.compiler import CompiledNet as TNet
from sparknet_tpu_torch.models import zoo as tzoo
from sparknet_tpu_torch.parallel import ExpertParallelSolver, make_mesh
from sparknet_tpu_torch.proto import Message as TMessage
from sparknet_tpu_torch.solver import Solver
from test_torch_mesh_parity import (LOSS_RTOL, STEPS, assert_params_match,
                               routing_agreement, start_together)

LM = dict(vocab_size=64, seq_len=32, batch_size=4, d_model=32,
          num_layers=2, num_heads=2, flash=False, moe_experts=4,
          moe_stats=True)


def _sp(message):
    return message("SolverParameter", base_lr=3e-4, lr_policy="fixed",
                   type="Adam", random_seed=3, display=0)


def _logits(blobs, params, np_of):
    out = []
    for i in range(LM["num_layers"]):
        x = np_of(blobs[f"block{i}/ln2"]).reshape(-1, LM["d_model"])
        out.append(x @ np_of(params[f"block{i}/moe"][0]).T)
    return np.concatenate(out)


def _routing_check(lm):
    """fn(js, ts, batch): both packages' router logits of every token of
    ``batch`` from their own params, held to each other."""
    jn = JNet(jzoo.transformer_lm(**lm), 0)
    jfwd = jax.jit(lambda p, b: jn.apply(p, {}, b, train=False)[0])
    tn = TNet(tzoo.transformer_lm(**lm), 0, device="cpu")

    def check(js, ts, batch):
        jp = {n: [np.asarray(p) for p in ps] for n, ps in js.params.items()}
        with torch.no_grad():
            tb, _ = tn.apply(ts.params, {}, batch, train=False)
        routing_agreement(_logits(jfwd(jp, batch), jp, np.asarray),
                          _logits(tb, ts.params,
                                  lambda t: t.detach().numpy()))
    return check


@pytest.mark.parametrize("axes,cf", [
    ({"data": 1, "expert": 2}, None),
    ({"data": 1, "expert": 4}, 0.5),
    ({"data": 1, "seq": 2, "expert": 2}, None)],
    ids=["ep2", "ep4-overflow", "sp2-ep2"])
def test_expert_parallel_steps_match_jax(tmp_path, axes, cf):
    seq = "seq" if "seq" in axes else None
    lm = dict(LM, moe_capacity_factor=cf, ring=seq is not None)
    js = JEP(_sp(JMessage), mesh=jmesh(axes), seq_axis=seq,
             net_param=jzoo.transformer_lm(**lm), log_fn=None)
    ts = ExpertParallelSolver(_sp(TMessage), mesh=make_mesh(axes),
                              seq_axis=seq,
                              net_param=tzoo.transformer_lm(**lm),
                              device="cpu", log_fn=None)
    start_together(tmp_path, js, ts)
    # each expert slot holds its own experts' rows
    ep = axes["expert"]
    assert tuple(ts._slot_params()[1]["block0/moe"][1].shape) == \
        (4 // ep, 128, 32)
    stream, _ = lm_batch_stream(64, 4, 32, seed=1)
    check_routing = _routing_check(dict(lm, ring=False))
    jl, tl = [], []
    for _ in range(STEPS):
        b = next(stream)
        check_routing(js, ts, b)
        jl.append(float(js.train_step(b)))
        tl.append(float(ts.train_step(b)))
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert_params_match(js, ts)
    b = next(stream)
    want = js.test(iter([b]), num_iters=1)
    got = ts.test(iter([b]), num_iters=1)
    for k in ("block0/moe_stats", "block1/moe_stats"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=1e-6)
    if cf is not None:
        assert got["block0/moe_stats"][-1] > 0.2       # tokens overflowed


def test_indivisible_experts_are_refused():
    with pytest.raises(ValueError, match="not divisible by expert axis"):
        ExpertParallelSolver(_sp(TMessage),
                             mesh=make_mesh({"data": 1, "expert": 3}),
                             net_param=tzoo.transformer_lm(
                                 **dict(LM, batch_size=3)),
                             device="cpu", log_fn=None)


def test_clipped_step_matches_one_device():
    # an ep 2 SGD step with clip_gradients set against one device's from
    # the same weights: every token kept (capacity factor 4, the experts'
    # count) and no aux loss (its routing statistics are each slot's own
    # under ep), so the two compute the same gradient; the clip is active
    # (the update's norm is lr * clip) and each expert slot's own norm,
    # which the JAX solver would clip by, is not the global one
    lm = dict(LM, moe_capacity_factor=4.0, moe_aux_weight=0.0,
              moe_stats=False)
    lr, clip = 0.1, 0.05

    def sp():
        return TMessage("SolverParameter", base_lr=lr, lr_policy="fixed",
                        type="SGD", random_seed=3, display=0,
                        clip_gradients=clip)
    one = Solver(sp(), net_param=tzoo.transformer_lm(**lm), device="cpu",
                 log_fn=None)
    ts = ExpertParallelSolver(sp(), mesh=make_mesh({"data": 1, "expert": 2}),
                              net_param=tzoo.transformer_lm(**lm),
                              device="cpu", log_fn=None)
    with torch.no_grad():
        for name, blobs in one.params.items():
            for a, b in zip(ts.params[name], blobs):
                a.copy_(b)
    w0 = {n: [p.detach().clone() for p in ps] for n, ps in one.params.items()}
    b = next(lm_batch_stream(64, 4, 32, seed=1)[0])
    np.testing.assert_allclose(float(ts.train_step(b)),
                               float(one.train_step(b)), rtol=1e-6)
    for name, blobs in one.params.items():
        for a, p in zip(ts.params[name], blobs):
            np.testing.assert_allclose(a.detach().numpy(),
                                       p.detach().numpy(), rtol=0,
                                       atol=1e-6)
    step = torch.sqrt(sum(((p.detach() - w0[n][i]) ** 2).sum()
                          for n, ps in one.params.items()
                          for i, p in enumerate(ps)))
    assert abs(float(step) / (lr * clip) - 1) < 1e-4

    def sumsq(rows):
        return float(sum((g.double() ** 2).sum() for g in rows))
    grads = {n: [p.grad for p in ps] for n, ps in one.params.items()}
    experts = {n: ps[1:] for n, ps in grads.items() if n.endswith("/moe")}
    total = sumsq(g for gs in grads.values() for g in gs)
    for e in range(2):
        mine = total - sumsq(g[(1 - e) * 2:(2 - e) * 2]
                             for gs in experts.values() for g in gs)
        assert abs((total / mine) ** 0.5 - 1) > 1e-2

