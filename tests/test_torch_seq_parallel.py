"""The port's SeqParallelSolver (dp x sp, ring attention) against the JAX
package's on the CPU.

A 2-layer transformer LM with ring attention (d 32, 4 heads, S 32,
vocab 64, batch 4) on a (data 2, seq 2) mesh: the JAX solver on 4
devices of the virtual CPU mesh, the port on 4 slots, from one JAX
snapshot, 3 Adam steps on the same batches: losses within 1e-5 relative,
every param within 1e-4. Also the JAX solver's refusals (a sequence or
batch that does not divide, an ignore_label loss), rank-1 feeds, the
lock-step remat, and a test pass.
"""

import numpy as np
import pytest
import torch

from sparknet_tpu.models import zoo as jzoo
from sparknet_tpu.parallel import (SeqParallelSolver as JSeq,
                                   make_mesh as jmesh)
from sparknet_tpu.proto import Message as JMessage
from sparknet_tpu_torch.models import dsl, zoo as tzoo
from sparknet_tpu_torch.parallel import SeqParallelSolver, make_mesh
from sparknet_tpu_torch.proto import Message as TMessage
from test_torch_mesh_parity import (LOSS_RTOL, assert_params_match, run_steps,
                               start_together)

LM = dict(vocab_size=64, seq_len=32, batch_size=4, d_model=32,
          num_layers=2, num_heads=4, flash=False, ring=True)
AXES = {"data": 2, "seq": 2}


def _sp(message):
    return message("SolverParameter", base_lr=3e-4, lr_policy="fixed",
                   type="Adam", random_seed=3, display=0)


def _port(**lm):
    return SeqParallelSolver(_sp(TMessage), mesh=make_mesh(AXES),
                             net_param=tzoo.transformer_lm(**dict(LM, **lm)),
                             device="cpu", log_fn=None)


def test_dp_x_sp_steps_match_jax(tmp_path):
    js = JSeq(_sp(JMessage), mesh=jmesh(AXES),
              net_param=jzoo.transformer_lm(**LM), log_fn=None)
    ts = _port()
    start_together(tmp_path, js, ts)
    batches = run_steps(js, ts, 64, 4, 32)
    assert_params_match(js, ts)
    want = js.test(iter(batches[:1]), num_iters=1)
    got = ts.test(iter(batches[:1]), num_iters=1)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)


def test_remat_full_over_the_slots_is_the_same_step(tmp_path, monkeypatch):
    """--remat full checkpoints each block over all slots at once; the
    recompute replays the ring, and the step equals the unchecked one."""
    monkeypatch.setenv("SPARKNET_REMAT", "none")
    a = _port()
    b = _port()
    b.set_remat("full")
    b.params = {n: [p.detach().clone().requires_grad_(True) for p in ps]
                for n, ps in a.params.items()}
    from sparknet_tpu_torch.data import lm_batch_stream
    stream, _ = lm_batch_stream(64, 4, 32, seed=2)
    for _ in range(2):
        batch = next(stream)
        la, lb = a.train_step(batch), b.train_step(batch)
        assert torch.equal(la, lb)
    for n, ps in a.params.items():
        for p, q in zip(ps, b.params[n]):
            assert torch.equal(p, q), n


def test_refusals_and_rank1_feeds():
    with pytest.raises(ValueError, match="seq dim 31 not divisible"):
        _port(seq_len=31)
    with pytest.raises(ValueError, match="batch 3 not divisible"):
        _port(batch_size=3)
    net = tzoo.transformer_lm(**LM)
    for lp in net.layer:
        if lp.type == "SoftmaxWithLoss":
            lp.loss_param = TMessage("LossParameter", ignore_label=0)
    with pytest.raises(ValueError, match="ignore_label"):
        SeqParallelSolver(_sp(TMessage), mesh=make_mesh(AXES),
                          net_param=net, device="cpu", log_fn=None)
    # a rank-1 (per-example) feed is not cut along the sequence
    body = tzoo.transformer_lm(**dict(LM, with_data=False)).layer
    net = dsl.NetParam("r1", dsl.RDDLayer("data", [4, 32]),
                       dsl.RDDLayer("label", [4, 32]),
                       dsl.RDDLayer("weight", [4]), *body)
    s = SeqParallelSolver(_sp(TMessage), mesh=make_mesh(AXES),
                          net_param=net, device="cpu", log_fn=None)
    assert s.local_net.feed_shapes() == {"data": (2, 16), "label": (2, 16),
                                         "weight": (2,)}
    rs = np.random.RandomState(0)
    loss = s.train_step({"data": rs.randint(0, 64, (4, 32)),
                         "label": rs.randint(0, 64, (4, 32)),
                         "weight": rs.randn(4).astype(np.float32)})
    assert np.isfinite(float(loss))
