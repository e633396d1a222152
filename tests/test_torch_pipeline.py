"""The port's GPipe pipeline against the JAX package's on the CPU.

pipeline_apply over 2 and 4 "pipe" slots against the JAX function on the
virtual CPU mesh (forward and the stacked params' gradients, 1e-5 of the
largest element); PipelineLMSolver (2 stages, 4 microbatches, a
4-layer transformer LM, d 32, 2 heads, S 32, vocab 64, batch 8) from a
JAX .lm.npz, 3 Adam steps on the same batches: losses within 1e-5
relative, every param within 1e-4; the port's .lm.npz restores into the
JAX solver exactly, and the pipelined step equals the unpipelined LM's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparknet_tpu.parallel import (PipelineLMSolver as JPipe,
                                   make_mesh as jmesh)
from sparknet_tpu.parallel import pipeline as jpipe
from sparknet_tpu.proto import Message as JMessage
from sparknet_tpu_torch.parallel import (PipelineLMSolver, make_mesh,
                                         pipeline_apply, stack_params)
from sparknet_tpu_torch.proto import Message as TMessage
from test_torch_mesh_parity import assert_params_match, run_steps

LM = dict(vocab_size=64, seq_len=32, batch_size=8, d_model=32,
          num_heads=2, flash=False)
TOL = 1e-5


def _sp(message):
    return message("SolverParameter", base_lr=3e-4, lr_policy="fixed",
                   type="Adam", random_seed=3, display=0)


@pytest.mark.parametrize("stages,micro", [(2, 4), (4, 2)])
def test_pipeline_apply_matches_jax(stages, micro):
    rs = np.random.RandomState(0)
    L, B, E = 4, 4, 6
    w = rs.randn(L, E, E).astype(np.float32) * 0.4
    b = rs.randn(L, E).astype(np.float32) * 0.1
    x = rs.randn(B, 3, E).astype(np.float32)
    g = rs.randn(B, 3, E).astype(np.float32)

    def jblock(p, h):
        return jnp.tanh(h @ p["fc"][0] + p["fc"][1])

    def jloss(params):
        out = jpipe.pipeline_apply(jblock, params, jnp.asarray(x),
                                   jmesh({"pipe": stages}), micro)
        return jnp.sum(out * g), out

    (_, jo), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        {"fc": [jnp.asarray(w), jnp.asarray(b)]})
    tp = {"fc": [torch.from_numpy(w).requires_grad_(True),
                 torch.from_numpy(b).requires_grad_(True)]}
    to = pipeline_apply(lambda p, h: torch.tanh(h @ p["fc"][0] + p["fc"][1]),
                        tp, torch.from_numpy(x), make_mesh({"pipe": stages}),
                        micro)
    (to * torch.from_numpy(g)).sum().backward()
    for got, want in ((to.detach().numpy(), jo),
                      (tp["fc"][0].grad.numpy(), jg["fc"][0]),
                      (tp["fc"][1].grad.numpy(), jg["fc"][1])):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=TOL * np.abs(want).max())
    stacked = stack_params([{"a": [torch.ones(2) * i]} for i in range(3)])
    assert stacked["a"][0].shape == (3, 2)
    with pytest.raises(ValueError, match="not divisible by pipeline"):
        pipeline_apply(None, tp, torch.from_numpy(x),
                       make_mesh({"pipe": 3}), 2)
    with pytest.raises(ValueError, match="not divisible by microbatches"):
        pipeline_apply(None, tp, torch.from_numpy(x),
                       make_mesh({"pipe": 2}), 3)


def test_pipeline_lm_solver_matches_jax_and_npz_crosses(tmp_path):
    js = JPipe(_sp(JMessage), mesh=jmesh({"pipe": 2}), num_layers=4,
               num_microbatches=4, log_fn=None, **LM)
    ts = PipelineLMSolver(_sp(TMessage), mesh=make_mesh({"pipe": 2}),
                          num_layers=4, num_microbatches=4, device="cpu",
                          log_fn=None, **LM)
    assert set(ts.params) == set(js.params)
    ts.restore(js.snapshot(str(tmp_path / "jax")))
    run_steps(js, ts, 64, 8, 32)
    assert_params_match(js, ts)
    path = ts.snapshot(str(tmp_path / "port"))
    assert path.endswith("_iter_3.lm.npz")
    j2 = JPipe(_sp(JMessage), mesh=jmesh({"pipe": 2}), num_layers=4,
               num_microbatches=4, log_fn=None, **LM)
    j2.restore(path)
    assert j2.iter == 3
    assert_params_match(j2, ts, atol=0)
    keys = set(np.load(path).files)
    assert "__iter__" in keys and "p/blocks/attn@0" in keys and \
        "h/blocks/attn@0@1" in keys


def test_pipelined_step_equals_the_unpipelined_lm():
    """The same stacked params run as 1 stage x 1 microbatch and as 2
    stages x 4 microbatches: the same loss and gradients."""
    a = PipelineLMSolver(_sp(TMessage), mesh=make_mesh({"pipe": 1}),
                         num_layers=4, num_microbatches=1, device="cpu",
                         log_fn=None, **LM)
    b = PipelineLMSolver(_sp(TMessage), mesh=make_mesh({"pipe": 2}),
                         num_layers=4, num_microbatches=4, device="cpu",
                         log_fn=None, **LM)
    from sparknet_tpu_torch.data import lm_batch_stream
    batch = next(lm_batch_stream(64, 8, 32, seed=0)[0])
    la, lb = a.loss(batch), b.loss(batch)
    np.testing.assert_allclose(lb.item(), la.item(), rtol=TOL)
    la.backward()
    lb.backward()
    for n, ps in a.params.items():
        for p, q in zip(ps, b.params[n]):
            np.testing.assert_allclose(q.grad.numpy(), p.grad.numpy(),
                                       rtol=0, atol=TOL * float(
                                           p.grad.abs().max()) + 1e-12)
