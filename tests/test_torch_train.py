"""The port's TRAIN phase against the JAX package's on the CPU: every loss
layer and Accuracy (value and gradient), TRAIN-phase Dropout, and the
compiler's loss weights on GoogLeNet's three loss tops.

Inputs are made with numpy from a seed and handed to both packages.
Tolerance: losses rtol=1e-6, their gradients rtol=1e-5 / atol=1e-7
(both sides in float32; the reductions sum in different orders).
Dropout masks come from different generators (jax.random vs
torch.Generator), so Dropout is held to its distribution.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from sparknet_tpu.graph.compiler import CompiledNet as JNet
from sparknet_tpu.graph.registry import get as jget
from sparknet_tpu.models import zoo as jzoo
from sparknet_tpu.proto import Message as JMessage
from sparknet_tpu_torch.graph import TRAIN, CompiledNet as TNet
from sparknet_tpu_torch.graph.registry import get as tget
from sparknet_tpu_torch.models import zoo as tzoo
from sparknet_tpu_torch.proto import Message as TMessage


def _pair(type_name, shapes, **fields):
    jl = jget(type_name)(JMessage("LayerParameter", name="t",
                                  type=type_name, **fields), shapes, 0)
    tl = tget(type_name)(TMessage("LayerParameter", name="t",
                                  type=type_name, **fields), shapes, 0)
    return jl, tl


def _rs(seed):
    return np.random.RandomState(seed)


def _labels(n, c, seed, ignore=None):
    lab = _rs(seed).randint(0, c, n).astype(np.int32)
    if ignore is not None:
        lab[::3] = ignore
    return lab


def _softmax_case(normalize, ignore, spatial):
    shape = (2, 5, 3, 3) if spatial else (6, 5)
    x = (2 * _rs(1).randn(*shape)).astype(np.float32)
    n_lab = int(np.prod(shape)) // 5
    lab = _labels(n_lab, 5, 2, ignore).reshape(
        (2, 3, 3) if spatial else (6,))
    fields = {"loss_param": dict(normalize=normalize)}
    if ignore is not None:
        fields["loss_param"]["ignore_label"] = ignore
    return "SoftmaxWithLoss", [x, lab], fields, (0,)


def _prob(n, c, seed):
    p = _rs(seed).rand(n, c).astype(np.float32) + 0.05
    return (p / p.sum(1, keepdims=True)).astype(np.float32)


LOSS_CASES = [
    pytest.param(*_softmax_case(True, None, False), id="softmax-valid"),
    pytest.param(*_softmax_case(False, None, False), id="softmax-batch"),
    pytest.param(*_softmax_case(True, 2, False), id="softmax-ignore-valid"),
    pytest.param(*_softmax_case(False, 2, False), id="softmax-ignore-batch"),
    pytest.param(*_softmax_case(True, None, True), id="softmax-spatial"),
    pytest.param(*_softmax_case(False, 1, True),
                 id="softmax-spatial-ignore-batch"),
    pytest.param("EuclideanLoss",
                 [_rs(3).randn(4, 6).astype(np.float32),
                  _rs(4).randn(4, 6).astype(np.float32)], {}, (0, 1),
                 id="euclidean"),
    pytest.param("HingeLoss", [_rs(5).randn(6, 5).astype(np.float32),
                               _labels(6, 5, 6)],
                 {"hinge_loss_param": dict(norm="L1")}, (0,), id="hinge-l1"),
    pytest.param("HingeLoss", [_rs(5).randn(6, 5).astype(np.float32),
                               _labels(6, 5, 6)],
                 {"hinge_loss_param": dict(norm="L2")}, (0,), id="hinge-l2"),
    pytest.param("SigmoidCrossEntropyLoss",
                 [(3 * _rs(7).randn(4, 6)).astype(np.float32),
                  (_rs(8).rand(4, 6) > 0.5).astype(np.float32)], {}, (0,),
                 id="sigmoid-xent"),
    pytest.param("MultinomialLogisticLoss",
                 [_prob(6, 5, 9), _labels(6, 5, 10)], {}, (0,),
                 id="multinomial"),
    pytest.param("InfogainLoss",
                 [_prob(6, 5, 11), _labels(6, 5, 12),
                  _rs(13).rand(5, 5).astype(np.float32)], {}, (0,),
                 id="infogain"),
    pytest.param("ContrastiveLoss",
                 [_rs(14).randn(6, 3).astype(np.float32),
                  _rs(15).randn(6, 3).astype(np.float32),
                  (_rs(16).rand(6) > 0.5).astype(np.float32)],
                 {"contrastive_loss_param": dict(margin=2.0)}, (0, 1),
                 id="contrastive"),
    pytest.param("ContrastiveLoss",
                 [_rs(14).randn(6, 3).astype(np.float32),
                  _rs(15).randn(6, 3).astype(np.float32),
                  (_rs(16).rand(6) > 0.5).astype(np.float32)],
                 {"contrastive_loss_param": dict(margin=2.0,
                                                 legacy_version=True)},
                 (0, 1), id="contrastive-legacy"),
]


@pytest.mark.parametrize("type_name,inputs,fields,diff", LOSS_CASES)
def test_loss_value_and_gradient_match_jax(type_name, inputs, fields, diff):
    jl, tl = _pair(type_name, [a.shape for a in inputs], **fields)
    assert tl.loss_like and jl.loss_like
    assert tl.out_shapes() == [()]

    def jloss(*diffs):
        vals = [jnp.asarray(a) for a in inputs]
        for i, d in zip(diff, diffs):
            vals[i] = d
        return jl.apply([], vals, True, None)[0]

    ref, jgrads = jax.value_and_grad(jloss, argnums=tuple(
        range(len(diff))))(*[jnp.asarray(inputs[i]) for i in diff])
    tin = [torch.from_numpy(a) for a in inputs]
    for i in diff:
        tin[i].requires_grad_()
    got = tl.apply([], tin, True)[0]
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-6)
    got.backward()
    for i, jg in zip(diff, jgrads):
        np.testing.assert_allclose(tin[i].grad.numpy(), np.asarray(jg),
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("top_k,ignore,spatial", [
    (1, None, False), (2, None, False), (1, 3, False), (3, 1, True)])
def test_accuracy_matches_jax(top_k, ignore, spatial):
    lab = _labels(12, 6, 18, ignore)
    rows = _rs(17).randn(12, 6).astype(np.float32)
    rows[np.arange(0, 12, 2), lab[::2]] += 3.0      # half the rows hit
    x = rows.reshape(2, 2, 3, 6).transpose(0, 3, 1, 2).copy() if spatial \
        else rows
    lab = lab.reshape((2, 2, 3) if spatial else (12,))
    fields = {"accuracy_param": dict(top_k=top_k)}
    if ignore is not None:
        fields["accuracy_param"]["ignore_label"] = ignore
    jl, tl = _pair("Accuracy", [x.shape, lab.shape], **fields)
    ref = jl.apply([], [jnp.asarray(x), jnp.asarray(lab)], False, None)[0]
    got = tl.apply([], [torch.from_numpy(x), torch.from_numpy(lab)],
                   False)[0]
    assert float(got) == pytest.approx(float(ref), abs=1e-7)
    assert 0.0 < float(got) < 1.0


def _dropout(ratio):
    return _pair("Dropout", [(400, 500)],
                 dropout_param=dict(dropout_ratio=ratio))


@pytest.mark.parametrize("ratio", [0.4, 0.7])
def test_train_dropout_distribution_matches_jax(ratio):
    jl, tl = _dropout(ratio)
    x = np.ones((400, 500), np.float32)
    jout = np.asarray(jl.apply([], [jnp.asarray(x)], True,
                               jax.random.PRNGKey(0))[0])
    tout = tl.apply([], [torch.from_numpy(x)], True,
                    torch.Generator().manual_seed(0))[0].numpy()
    keep = 1.0 - ratio
    # kept units scale by exactly 1/keep, in both packages
    for out in (jout, tout):
        assert set(np.unique(out)) <= {0.0, np.float32(1.0 / keep)}
    # 200k Bernoulli draws: one zero share has a standard deviation of
    # at most 1.1e-3, so 5e-3 is over 4 of them (3 for the difference)
    assert abs((tout == 0).mean() - ratio) < 5e-3
    assert abs((tout == 0).mean() - (jout == 0).mean()) < 5e-3
    assert abs(tout.mean() - 1.0) < 1e-2


def test_dropout_ratio_zero_and_test_phase_are_identity():
    x = torch.from_numpy(_rs(19).randn(20, 30).astype(np.float32))
    _, zero = _dropout(0.0)
    assert torch.equal(zero.apply([], [x], True, torch.Generator())[0], x)
    _, half = _dropout(0.5)
    assert torch.equal(half.apply([], [x], False)[0], x)
    with pytest.raises(ValueError, match="generator"):
        half.apply([], [x], True)


def _aux_net(zoo, dsl_mod):
    """GoogLeNet's loss structure at toy size: a stem, the two auxiliary
    heads whose loss tops Caffe's prototxt names "loss1/loss1" and
    "loss2/loss1", and the main head; dropout at ratio 0 for parity."""
    d = dsl_mod
    layers = [d.RDDLayer("data", [2, 3, 16, 16]), d.RDDLayer("label", [2]),
              zoo._gconv("conv1", "data", 8, 3, pad=1),
              d.ReLULayer("relu1", ["conv1"], tops=["conv1"]),
              d.PoolingLayer("pool1", ["conv1"], "MAX", (2, 2), (2, 2))]
    layers += zoo._aux_head(1, "pool1", 10)
    layers += zoo._aux_head(2, "pool1", 10)
    layers += [zoo._fc("fc", "pool1", 10, w_type="xavier"),
               d.SoftmaxWithLoss("loss3/loss3", ["fc", "label"])]
    net = d.NetParam("AuxNet", *layers)
    for lp in net.layer:
        if lp.type == "Dropout":
            lp.dropout_param.dropout_ratio = 0.0
    return net


@pytest.fixture(scope="module")
def aux_nets():
    from sparknet_tpu.models import dsl as jdsl
    from sparknet_tpu_torch.graph import params_from_numpy
    from sparknet_tpu_torch.models import dsl as tdsl
    jnet = JNet(_aux_net(jzoo, jdsl), 0)
    tnet = TNet(_aux_net(tzoo, tdsl), TRAIN, device="cpu")
    jparams, _ = jnet.init(jax.random.PRNGKey(4))
    tparams, _ = params_from_numpy(
        tnet, {k: [np.asarray(a) for a in v] for k, v in jparams.items()})
    rs = _rs(20)
    batch = {"data": rs.randn(2, 3, 16, 16).astype(np.float32),
             "label": rs.randint(0, 10, 2).astype(np.int32)}
    return jnet, tnet, jparams, tparams, batch


def test_loss_weights_and_tops_match_jax(aux_nets):
    jnet, tnet = aux_nets[:2]
    assert tnet.loss_weights == jnet.loss_weights
    assert tnet.output_blobs == jnet.output_blobs
    weighted = {t: w for lp, _, _, tops in tnet.layers
                for t, w in zip(tops, tnet.loss_weights[lp.name]) if w}
    assert weighted == pytest.approx({"loss1/loss1": 0.3,
                                      "loss2/loss1": 0.3,
                                      "loss3/loss3": 1.0})


def test_total_loss_and_grads_match_jax(aux_nets):
    jnet, tnet, jparams, tparams, batch = aux_nets
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (ref, (jblobs, _)), jgrads = jax.value_and_grad(
        lambda p: jnet.loss_fn(p, {}, jb, jax.random.PRNGKey(0)),
        has_aux=True)(jparams)
    leaves = [t.requires_grad_() for v in tparams.values() for t in v]
    loss, (blobs, _) = tnet.loss_fn(tparams, {}, batch,
                                    torch.Generator().manual_seed(0))
    expect = sum(w * float(np.asarray(jblobs[t])) for t, w in
                 (("loss1/loss1", 0.3), ("loss2/loss1", 0.3),
                  ("loss3/loss3", 1.0)))
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-5)
    np.testing.assert_allclose(float(loss.detach()), expect, rtol=1e-5)
    loss.backward()
    assert all(t.grad is not None for t in leaves)
    for name, blobs_ in tparams.items():
        for t, jg in zip(blobs_, jgrads[name]):
            jg = np.asarray(jg)
            np.testing.assert_allclose(
                t.grad.numpy(), jg, rtol=1e-4,
                atol=1e-5 * max(float(np.abs(jg).max()), 1e-30),
                err_msg=name)
