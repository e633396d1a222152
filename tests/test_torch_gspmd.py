"""The port's tensor parallelism (GSPMDSolver over a (data, model) slot
grid) against the JAX package's GSPMDSolver on the CPU.

The JAX solver partitions a 2-layer transformer LM (d 32, 4 heads, S 32,
vocab 64, batch 4) by transformer_tp_rule over 2 (and 4) devices of the
virtual CPU mesh; the port runs the Megatron recipe over model slots
(heads, ffn1, lm_head and the embedding tables column-split, wo and ffn2
row-split and psum'd). Both start from one JAX snapshot and take 3 Adam
steps (the lm verb's lr) on the same batches: losses within 1e-5
relative, every param within 1e-4. The snapshots are the single-device
files: the port's restores into the JAX solver exactly.
"""

import pytest

from sparknet_tpu.models import zoo as jzoo
from sparknet_tpu.parallel import (GSPMDSolver as JGSPMD, make_mesh as jmesh,
                                   transformer_tp_rule as jrule)
from sparknet_tpu.proto import Message as JMessage
from sparknet_tpu_torch.models import zoo as tzoo
from sparknet_tpu_torch.parallel import (GSPMDSolver, make_mesh,
                                         transformer_tp_rule)
from sparknet_tpu_torch.proto import Message as TMessage
from test_torch_mesh_parity import assert_params_match, run_steps, start_together

LM = dict(vocab_size=64, seq_len=32, batch_size=4, d_model=32,
          num_layers=2, num_heads=4, flash=False)


def _sp(message):
    return message("SolverParameter", base_lr=3e-4, lr_policy="fixed",
                   type="Adam", random_seed=3, display=0)


def _pair(tmp_path, axes):
    tp = axes["model"]
    js = JGSPMD(_sp(JMessage), mesh=jmesh(axes), param_rule=jrule(tp),
                net_param=jzoo.transformer_lm(**LM), log_fn=None)
    ts = GSPMDSolver(_sp(TMessage), mesh=make_mesh(axes),
                     param_rule=transformer_tp_rule(tp),
                     net_param=tzoo.transformer_lm(**LM), device="cpu",
                     log_fn=None)
    start_together(tmp_path, js, ts)
    return js, ts


@pytest.mark.parametrize("axes", [{"data": 1, "model": 2},
                                  {"data": 2, "model": 2}],
                         ids=["tp2", "dp2-tp2"])
def test_tensor_parallel_steps_match_jax(tmp_path, axes):
    js, ts = _pair(tmp_path, axes)
    assert ts.specs["block0/attn"] == [("model",), ("model",),
                                       (None, "model"), ()]
    # each model slot holds H/N heads of q, k and v and its wo columns
    slot1 = ts._slot_params()[1]
    assert tuple(slot1["block0/attn"][0].shape) == (48, 32)
    assert tuple(slot1["block0/attn"][2].shape) == (32, 16)
    assert tuple(slot1["tok_embed"][0].shape) == (32, 32)
    run_steps(js, ts, 64, 4, 32)
    assert_params_match(js, ts)
    _, state = ts.snapshot(str(tmp_path / "port"))
    j2 = JGSPMD(_sp(JMessage), mesh=jmesh(axes),
                param_rule=jrule(axes["model"]),
                net_param=jzoo.transformer_lm(**LM), log_fn=None)
    j2.restore(state)
    assert_params_match(j2, ts, atol=0)


def test_heads_that_do_not_split_are_refused():
    with pytest.raises(ValueError, match="heads do not split"):
        GSPMDSolver(_sp(TMessage), mesh=make_mesh({"data": 1, "model": 3}),
                    param_rule=lambda n, i, s: ("model",)
                    if n.endswith("attn") and i == 0 else (),
                    net_param=tzoo.transformer_lm(**LM), device="cpu",
                    log_fn=None)
    with pytest.raises(ValueError, match="not ported"):
        GSPMDSolver(_sp(TMessage), seq_axis="seq",
                    net_param=tzoo.transformer_lm(**LM), device="cpu")
