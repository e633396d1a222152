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

With ``seq_axis`` (dp 2 x tp 2 x sp 2 on one mesh, the JAX package's
composed test) the JAX step sees whole sequences; the port's gathers
(each attention's core once per (data, model) group on the gathered
sequence, a layer that mixes dim 1 on the gathered blob) must give the
same numbers.
"""

import numpy as np
import pytest
import torch

from sparknet_tpu.models import dsl as jdsl
from sparknet_tpu.models import zoo as jzoo
from sparknet_tpu.parallel import (GSPMDSolver as JGSPMD,
                                   default_param_rule as jdefault,
                                   make_mesh as jmesh,
                                   transformer_tp_rule as jrule)
from sparknet_tpu.proto import Message as JMessage
from sparknet_tpu_torch.data import lm_batch_stream
from sparknet_tpu_torch.models import dsl as tdsl
from sparknet_tpu_torch.models import zoo as tzoo
from sparknet_tpu_torch.ops import attention as tattention
from sparknet_tpu_torch.parallel import (GSPMDSolver, default_param_rule,
                                         make_mesh, transformer_tp_rule)
from sparknet_tpu_torch.proto import Message as TMessage
from sparknet_tpu_torch.solver import Solver
from test_torch_mesh_parity import (LOSS_RTOL, STEPS, assert_params_match,
                                    run_steps, start_together)

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


DP_TP_SP = {"data": 2, "model": 2, "seq": 2}
# tests/test_parallel.py's composed dp x tp x sp test: 2 heads, and
# default_param_rule(2, min_size=1024), which splits the embedding tables,
# wqkv, wo, ffn1, ffn2 and lm_head over dim 0
JAX_TEST_LM = dict(LM, num_heads=2)
SEQ_CASES = {
    "default-rule": (DP_TP_SP, JAX_TEST_LM, "default"),
    "tp-rule": (DP_TP_SP, LM, "transformer"),
    # no model axis, and a net built for the ring, which the GSPMD step
    # does not run
    "dp-sp-ring": ({"data": 2, "seq": 2}, dict(LM, ring=True), None),
    # no JAX: S 128 gathered from 64 a slot takes the flash path
    "core-count": (DP_TP_SP, dict(LM, seq_len=128, flash=True), "transformer"),
}


def _rules(name):
    """(JAX rule, port rule) by name (None: every blob replicated)."""
    if name == "default":
        return jdefault(2, min_size=1024), default_param_rule(2, min_size=1024)
    if name == "transformer":
        return jrule(2), transformer_tp_rule(2)
    return None, None


def _count_cores(monkeypatch):
    """The port's Attention.core and flash wrapper calls, with the shapes
    each got."""
    cores, flash = [], []
    core, fa = tattention.Attention.core, tattention.flash_attention

    def counted_core(self, q, k, v):
        cores.append(tuple(q.shape))
        return core(self, q, k, v)

    def counted_flash(q, k, v, causal):
        flash.append(tuple(q.shape))
        return fa(q, k, v, causal)

    monkeypatch.setattr(tattention.Attention, "core", counted_core)
    monkeypatch.setattr(tattention, "flash_attention", counted_flash)
    return cores, flash


@pytest.mark.parametrize("case", list(SEQ_CASES))
def test_sequence_axis_steps_match_jax(tmp_path, monkeypatch, case):
    axes, lm, rule = SEQ_CASES[case]
    jr, tr = _rules(rule)
    ts = GSPMDSolver(_sp(TMessage), mesh=make_mesh(axes), param_rule=tr,
                     seq_axis="seq", net_param=tzoo.transformer_lm(**lm),
                     device="cpu", log_fn=None)
    groups = axes["data"] * axes.get("model", 1)
    cores, flash = _count_cores(monkeypatch)
    if case == "core-count":
        # against the port's own single device from one init
        ref = Solver(_sp(TMessage), net_param=tzoo.transformer_lm(**lm),
                     device="cpu", log_fn=None)
        with torch.no_grad():
            for n, ps in ref.params.items():
                for p, q in zip(ts.params[n], ps):
                    p.copy_(q)
        b = next(lm_batch_stream(64, lm["batch_size"], lm["seq_len"],
                                 seed=1)[0])
        del cores[:], flash[:]
        got = float(ts.train_step(b))
        # each block's core once per (data, model) group on the gathered
        # (B/dp, H/tp, S, D), each through the flash wrapper
        whole = (lm["batch_size"] // 2, lm["num_heads"] // 2,
                 lm["seq_len"], lm["d_model"] // lm["num_heads"])
        assert cores == [whole] * (lm["num_layers"] * groups)
        assert flash == cores
        np.testing.assert_allclose(got, float(ref.train_step(b)),
                                   rtol=LOSS_RTOL)
        return
    js = JGSPMD(_sp(JMessage), mesh=jmesh(axes), param_rule=jr,
                seq_axis="seq", net_param=jzoo.transformer_lm(**lm),
                log_fn=None)
    start_together(tmp_path, js, ts)
    run_steps(js, ts, lm["vocab_size"], lm["batch_size"], lm["seq_len"])
    assert_params_match(js, ts)
    assert len(cores) == lm["num_layers"] * groups * STEPS
    assert not flash
    if case == "tp-rule":
        # row-split tables: the position table read at each seq slot's
        # global rows
        assert ts.specs["pos_embed"] == [("model",)]
        _, state = ts.snapshot(str(tmp_path / "port"))
        j2 = JGSPMD(_sp(JMessage), mesh=jmesh(axes), param_rule=jr,
                    seq_axis="seq", net_param=jzoo.transformer_lm(**lm),
                    log_fn=None)
        j2.restore(state)
        assert_params_match(j2, ts, atol=0)


def _ignore_label_lm(zoo, message):
    """The LM whose loss skips label 0: each shard normalizes by its own
    valid count, so the loss must see the whole sequence."""
    net = zoo.transformer_lm(**dict(LM, num_layers=1))
    for lp in net.layer:
        if lp.type == "SoftmaxWithLoss":
            lp.loss_param = message("LossParameter", ignore_label=0)
    return net


def _small_cnn(dsl):
    """A conv net whose dim 1 is channels: a seq axis splits them."""
    return dsl.NetParam(
        "SeqCNN", dsl.RDDLayer("data", [4, 4, 8, 8]),
        dsl.RDDLayer("label", [4]),
        dsl.ConvolutionLayer("conv1", ["data"], (3, 3), 8, pad=(1, 1),
                             weight_filler=dict(type="xavier")),
        dsl.ReLULayer("relu1", ["conv1"], tops=["conv1"]),
        dsl.PoolingLayer("pool1", ["conv1"], "AVE", (2, 2), (2, 2)),
        dsl.InnerProductLayer("ip1", ["pool1"], 10,
                              weight_filler=dict(type="xavier")),
        dsl.SoftmaxWithLoss("loss", ["ip1", "label"]))


def _cnn_batches(steps=STEPS):
    rs = np.random.RandomState(5)
    return [{"data": rs.randn(4, 4, 8, 8).astype(np.float32),
             "label": rs.randint(0, 10, 4)} for _ in range(steps)]


@pytest.mark.parametrize("case", ["ignore-label", "channels"])
def test_gathered_layers_match_jax(tmp_path, case):
    """Layers that mix dim 1 take the gathered form: a loss with
    ignore_label (over the data slots too: each normalizes by the whole
    batch's valid count, as the JAX step does), and a convolution over
    channels split by the seq axis (its weights split over "model")."""
    if case == "ignore-label":
        axes = DP_TP_SP
        jnet = _ignore_label_lm(jzoo, JMessage)
        tnet = _ignore_label_lm(tzoo, TMessage)
        jr, tr = jrule(2), transformer_tp_rule(2)
    else:
        axes = DP_TP_SP
        jnet, tnet = _small_cnn(jdsl), _small_cnn(tdsl)
        jr, tr = jdefault(2, min_size=64), default_param_rule(2, min_size=64)
    js = JGSPMD(_sp(JMessage), mesh=jmesh(axes), param_rule=jr,
                seq_axis="seq", net_param=jnet, log_fn=None)
    ts = GSPMDSolver(_sp(TMessage), mesh=make_mesh(axes), param_rule=tr,
                     seq_axis="seq", net_param=tnet, device="cpu",
                     log_fn=None)
    start_together(tmp_path, js, ts)
    if case == "ignore-label":
        run_steps(js, ts, 64, 4, 32)
    else:
        assert ts.specs["conv1"][0] == ("model",)
        jl, tl = [], []
        for b in _cnn_batches():
            jl.append(float(js.train_step(b)))
            tl.append(float(ts.train_step(b)))
        np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert_params_match(js, ts)


def test_seq_axis_must_be_a_mesh_axis():
    with pytest.raises(ValueError, match="not an axis"):
        GSPMDSolver(_sp(TMessage), mesh=make_mesh({"data": 2, "model": 2}),
                    seq_axis="seq", net_param=tzoo.transformer_lm(**LM),
                    device="cpu", log_fn=None)
