"""The port's TEST-phase CompiledNet against the JAX package's on a narrow
mini-GoogLeNet: the real stem (conv 7x7 s2 -> relu -> pool -> LRN -> 1x1
conv -> relu -> 3x3 conv -> relu -> LRN -> pool), one inception module
at narrow widths, then AVE pool -> dropout -> fc.

Weights are initialised by the JAX package and carried across with
params_from_numpy, or through a .caffemodel either package wrote. With
SPARKNET_EPILOGUE=on the JAX side runs its Pallas epilogue kernels in
interpret mode and the port runs the kernels' plain versions.

Tolerance: rtol=1e-4 and atol=1e-5 times the largest absolute value of
each blob — both sides compute in float32, but XLA:CPU and PyTorch's
CPU convolutions sum in different orders.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from sparknet_tpu.graph.compiler import CompiledNet as JNet
from sparknet_tpu.models import dsl as jdsl, zoo as jzoo
from sparknet_tpu.proto import wire as jwire
from sparknet_tpu_torch.graph import TEST, TRAIN, CompiledNet as TNet
from sparknet_tpu_torch.graph import params_from_numpy
from sparknet_tpu_torch.models import dsl as tdsl, zoo as tzoo
from sparknet_tpu_torch.proto import wire as twire

BATCH = 2
WIDTHS = (4, 4, 6, 2, 3, 3)       # inception 1x1, 3x3r, 3x3, 5x5r, 5x5, proj


def mini_googlenet(dsl, zoo, batch=BATCH, with_loss=False):
    layers = [dsl.RDDLayer("data", [batch, 3, 32, 32])]
    if with_loss:
        layers.append(dsl.RDDLayer("label", [batch]))
    layers += [
        zoo._gconv("conv1/7x7_s2", "data", 8, 7, stride=2, pad=3),
        dsl.ReLULayer("conv1/relu_7x7", ["conv1/7x7_s2"],
                      tops=["conv1/7x7_s2"]),
        dsl.PoolingLayer("pool1/3x3_s2", ["conv1/7x7_s2"], "MAX", (3, 3),
                         (2, 2)),
        dsl.LRNLayer("pool1/norm1", ["pool1/3x3_s2"], local_size=5,
                     alpha=1e-4, beta=0.75),
        zoo._gconv("conv2/3x3_reduce", "pool1/norm1", 8, 1),
        dsl.ReLULayer("conv2/relu_3x3_reduce", ["conv2/3x3_reduce"],
                      tops=["conv2/3x3_reduce"]),
        zoo._gconv("conv2/3x3", "conv2/3x3_reduce", 12, 3, pad=1),
        dsl.ReLULayer("conv2/relu_3x3", ["conv2/3x3"], tops=["conv2/3x3"]),
        dsl.LRNLayer("conv2/norm2", ["conv2/3x3"], local_size=5, alpha=1e-4,
                     beta=0.75),
        dsl.PoolingLayer("pool2/3x3_s2", ["conv2/norm2"], "MAX", (3, 3),
                         (2, 2)),
    ]
    inc, top = zoo._inception("3a", "pool2/3x3_s2", WIDTHS)
    layers += inc
    layers += [
        dsl.PoolingLayer("pool5/4x4_s1", [top], "AVE", (4, 4), (1, 1)),
        dsl.DropoutLayer("pool5/drop", ["pool5/4x4_s1"],
                         tops=["pool5/4x4_s1"], ratio=0.4),
        zoo._fc("loss3/classifier", "pool5/4x4_s1", 10, w_type="xavier",
                bias_value=0.1),
    ]
    if with_loss:
        layers.append(dsl.SoftmaxWithLoss("loss3/loss3",
                                          ["loss3/classifier", "label"]))
    return dsl.NetParam("MiniGoogLeNet", *layers)


@pytest.fixture(scope="module")
def nets():
    jnet = JNet(mini_googlenet(jdsl, jzoo), TEST)
    tnet = TNet(mini_googlenet(tdsl, tzoo), TEST, device="cpu")
    jparams, jstate = jnet.init(jax.random.PRNGKey(3))
    params_np = {k: [np.asarray(a) for a in v] for k, v in jparams.items()}
    tparams, tstate = params_from_numpy(tnet, params_np)
    x = np.random.RandomState(0).randn(BATCH, 3, 32, 32).astype(np.float32)
    return jnet, tnet, jparams, tparams, {"data": x}


def _jax_blobs(jnet, params, batch):
    blobs, _ = jnet.apply(params, {}, {"data": jnp.asarray(batch["data"])},
                          train=False)
    return {k: np.asarray(v) for k, v in blobs.items()}


def _port_blobs(tnet, params, batch):
    with torch.inference_mode():
        blobs, _ = tnet.apply(params, {}, batch)
    return {k: v.numpy() for k, v in blobs.items()}


def _assert_blobs_close(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        scale = max(float(np.abs(ref[k]).max()), 1e-30)
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=k)


@pytest.mark.parametrize("mode", ["off", "on"])
def test_forward_matches_jax(nets, monkeypatch, mode):
    jnet, tnet, jparams, tparams, batch = nets
    monkeypatch.setenv("SPARKNET_EPILOGUE", mode)
    ref = _jax_blobs(jnet, jparams, batch)
    got = _port_blobs(tnet, tparams, batch)
    _assert_blobs_close(got, ref)
    logits = got["loss3/classifier"]
    assert logits.shape == (BATCH, 10) and np.abs(logits).max() > 0
    if mode == "on":
        # the fused conv2 site leaves its pre-LRN blob absent, never stale
        assert "conv2/3x3" not in got and "conv2/norm2" in got


def test_epilogue_on_and_off_agree(nets, monkeypatch):
    jnet, tnet, jparams, tparams, batch = nets
    monkeypatch.setenv("SPARKNET_EPILOGUE", "off")
    off = _port_blobs(tnet, tparams, batch)["loss3/classifier"]
    monkeypatch.setenv("SPARKNET_EPILOGUE", "on")
    on = _port_blobs(tnet, tparams, batch)["loss3/classifier"]
    np.testing.assert_allclose(on, off, rtol=1e-5,
                               atol=1e-6 * np.abs(off).max())


def test_epilogue_plan_matches_jax(nets, monkeypatch):
    jnet, tnet = nets[:2]
    plan = tnet._epilogue_plan()
    assert plan == jnet._epilogue_plan()
    # conv1 and every inception conv are bias+ReLU sites; conv2/3x3 is
    # the 3-op bias+ReLU+LRN site
    three_op = {ci: v for ci, v in plan.items() if v[1] is not None}
    assert [tnet.layers[ci][0].name for ci in three_op] == ["conv2/3x3"]
    monkeypatch.setenv("SPARKNET_EPILOGUE", "on")
    assert tnet._active_epilogue() == plan
    monkeypatch.setenv("SPARKNET_EPILOGUE", "auto")
    assert tnet._active_epilogue() == {}        # auto fuses on the card only
    monkeypatch.setenv("SPARKNET_EPILOGUE", "off")
    assert tnet._active_epilogue() == {}


def test_caffemodel_round_trip_both_directions(nets):
    jnet, tnet, jparams, tparams, batch = nets
    ref = _port_blobs(tnet, tparams, batch)["loss3/classifier"]
    # JAX-written .caffemodel bytes -> port
    raw = jwire.encode(jnet.params_to_netproto(jparams))
    fresh, state = tnet.init(torch.Generator().manual_seed(9))
    loaded, _ = tnet.load_netproto(twire.decode(raw, "NetParameter"), fresh,
                                   state, strict=True)
    got = _port_blobs(tnet, loaded, batch)["loss3/classifier"]
    np.testing.assert_array_equal(got, ref)
    # port-written bytes -> JAX: the same weights, bit for bit
    raw_t = twire.encode(tnet.params_to_netproto(loaded))
    jfresh, _ = jnet.init(jax.random.PRNGKey(7))
    jloaded, _ = jnet.load_netproto(jwire.decode(raw_t, "NetParameter"),
                                    jfresh, strict=True)
    for name, blobs in jparams.items():
        for a, b in zip(blobs, jloaded[name]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_params_from_numpy_checks_names_and_shapes(nets):
    tnet, jparams = nets[1], nets[2]
    good = {k: [np.asarray(a) for a in v] for k, v in jparams.items()}
    params, state = params_from_numpy(tnet, good)
    assert state == {} and params["conv1/7x7_s2"][0].dtype == torch.float32
    missing = dict(good)
    missing.pop("conv2/3x3")
    with pytest.raises(ValueError, match="conv2/3x3"):
        params_from_numpy(tnet, missing)
    extra = dict(good, ghost=[np.zeros(3, np.float32)])
    with pytest.raises(ValueError, match="ghost"):
        params_from_numpy(tnet, extra)
    bad = dict(good)
    bad["loss3/classifier"] = [good["loss3/classifier"][0].T,
                               good["loss3/classifier"][1]]
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(tnet, bad)
    short = dict(good, **{"conv1/7x7_s2": good["conv1/7x7_s2"][:1]})
    with pytest.raises(ValueError, match="blobs"):
        params_from_numpy(tnet, short)


@pytest.mark.parametrize("mode", ["off", "on"])
def test_train_phase_forward_is_refused(monkeypatch, mode):
    """A TRAIN-phase forward of the mini-GoogLeNet
    with its loss (dropout at ratio 0) matches the JAX compiler's, blobs,
    loss and every param's gradient, with the epilogue fused (on) or
    not (off)."""
    monkeypatch.setenv("SPARKNET_EPILOGUE", mode)
    jp, tp = (mini_googlenet(d, z, with_loss=True)
              for d, z in ((jdsl, jzoo), (tdsl, tzoo)))
    for net in (jp, tp):
        next(lp for lp in net.layer
             if lp.type == "Dropout").dropout_param.dropout_ratio = 0.0
    jnet = JNet(jp, TRAIN)
    tnet = TNet(tp, TRAIN, device="cpu")
    jparams, _ = jnet.init(jax.random.PRNGKey(5))
    tparams, _ = params_from_numpy(
        tnet, {k: [np.asarray(a) for a in v] for k, v in jparams.items()})
    rs = np.random.RandomState(1)
    batch = {"data": rs.randn(BATCH, 3, 32, 32).astype(np.float32),
             "label": rs.randint(0, 10, BATCH).astype(np.int32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, (jblobs, _)), jgrads = jax.value_and_grad(
        lambda p: jnet.loss_fn(p, {}, jb, jax.random.PRNGKey(0)),
        has_aux=True)(jparams)
    leaves = [t.requires_grad_() for v in tparams.values() for t in v]
    loss, (blobs, _) = tnet.loss_fn(tparams, {}, batch,
                                    torch.Generator().manual_seed(0))
    _assert_blobs_close({k: v.detach().numpy() for k, v in blobs.items()},
                        {k: np.asarray(v) for k, v in jblobs.items()})
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5)
    loss.backward()
    assert all(t.grad is not None for t in leaves)
    for name, ts in tparams.items():
        for t, jg in zip(ts, jgrads[name]):
            jg = np.asarray(jg)
            assert np.abs(jg).max() > 0, name
            np.testing.assert_allclose(
                t.grad.numpy(), jg, rtol=1e-4,
                atol=1e-5 * float(np.abs(jg).max()), err_msg=name)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TNet(mini_googlenet(tdsl, tzoo), TEST)
