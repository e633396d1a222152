"""Remat and precision in the port (graph/compiler.py) against the JAX
package: the segments, the three policies bit for bit on the CPU, the
absent internal blobs, net state kept once, the dropout masks the
recompute draws again, the hand kernels' recompute, and --precision
leaving every CNN layer in f32 (C8)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from sparknet_tpu.graph.compiler import CompiledNet as JNet
from sparknet_tpu.models import dsl as jdsl
from sparknet_tpu.models import zoo as jzoo
from sparknet_tpu_torch.graph import TRAIN, CompiledNet as TNet
from sparknet_tpu_torch.graph.weights import params_from_numpy
from sparknet_tpu_torch.models import dsl as tdsl
from sparknet_tpu_torch.models import zoo as tzoo
from sparknet_tpu_torch.ops import cuda_epilogue, cuda_lrn

XAVIER = dict(type="xavier")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    """Each test starts from the defaults, and whatever the verbs write
    into os.environ (as the JAX verbs do) is undone at its end."""
    for var, default in (("SPARKNET_REMAT", "none"),
                         ("SPARKNET_PRECISION", "fp32"),
                         ("SPARKNET_EPILOGUE", "auto")):
        monkeypatch.setenv(var, default)


@pytest.mark.parametrize("name,kw", [
    ("googlenet", dict(batch_size=1)),
    ("transformer_lm", dict(vocab_size=32, seq_len=8, batch_size=1,
                            d_model=16, num_layers=3, num_heads=2)),
    ("caffenet", dict(batch_size=1)),
    ("cifar10_full", dict(batch_size=1))])
def test_remat_groups_equal_the_jax_packages(name, kw):
    jn = JNet(getattr(jzoo, name)(**kw), 0)
    tn = TNet(getattr(tzoo, name)(**kw), TRAIN, device="cpu")
    assert tn._remat_groups() == jn._remat_groups()
    groups = {tn.layers[lo][0].name.split("/")[0]
              for lo in tn._remat_groups()}
    if name == "googlenet":
        # the slice's kernel sites all sit inside segments
        assert {"pool1", "conv2", "pool5"} <= groups
    elif name == "transformer_lm":
        assert groups == {"block0", "block1", "block2"}
    else:
        assert not groups            # CaffeNet's names carry no prefix


def _bn_drop_net(dsl, ratio):
    """BatchNorm and a Dropout inside the "b1/" segment, a second
    segment "fc/" of two InnerProducts."""
    return dsl.NetParam(
        "remat",
        dsl.RDDLayer("data", (4, 3, 8, 8)), dsl.RDDLayer("label", (4,)),
        dsl.ConvolutionLayer("b1/conv", ["data"], (3, 3), 8, pad=(1, 1),
                             weight_filler=XAVIER),
        dsl.BatchNormLayer("b1/bn", ["b1/conv"]),
        dsl.ReLULayer("b1/relu", ["b1/bn"], tops=["b1/bn"]),
        dsl.DropoutLayer("b1/drop", ["b1/bn"], tops=["b1/bn"], ratio=ratio),
        dsl.PoolingLayer("pool", ["b1/bn"], "MAX", (2, 2), (2, 2)),
        dsl.InnerProductLayer("fc/ip", ["pool"], 16, weight_filler=XAVIER),
        dsl.ReLULayer("fc/relu", ["fc/ip"], tops=["fc/ip"]),
        dsl.InnerProductLayer("out", ["fc/ip"], 10, weight_filler=XAVIER),
        dsl.SoftmaxWithLoss("loss", ["out", "label"]))


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    return {"data": rs.randn(4, 3, 8, 8).astype(np.float32),
            "label": rs.randint(0, 10, 4).astype(np.int32)}


def _port_step(net, params, state, batch, pol, seed=5):
    net.remat = pol
    ps = {k: [p.detach().clone().requires_grad_(True) for p in v]
          for k, v in params.items()}
    loss, (blobs, new_state) = net.loss_fn(
        ps, state, batch, torch.Generator().manual_seed(seed))
    loss.backward()
    return (loss.detach(), {k: [p.grad for p in v] for k, v in ps.items()},
            new_state, blobs)


def test_policies_are_bit_for_bit_on_the_cpu_with_dropout_and_bn():
    net = TNet(_bn_drop_net(tdsl, 0.5), TRAIN, device="cpu")
    assert net._remat_groups() == {2: 6, 7: 9}
    params, state = net.init(torch.Generator().manual_seed(0))
    ref = _port_step(net, params, state, _batch(), "none")
    for pol in ("dots", "full"):
        got = _port_step(net, params, state, _batch(), pol)
        assert torch.equal(got[0], ref[0]), pol
        for k in ref[1]:
            for a, b in zip(got[1][k], ref[1][k]):
                assert torch.equal(a, b), (pol, k)
        for k in ref[2]:             # the BN state advanced once
            for a, b in zip(got[2][k], ref[2][k]):
                assert torch.equal(a, b), (pol, k)
    # the dropout mask is live: another seed gives another loss
    other = _port_step(net, params, state, _batch(), "full", seed=6)
    assert not torch.equal(other[0], ref[0])


@pytest.mark.parametrize("pol", ["dots", "full"])
def test_policies_match_the_jax_package(pol, monkeypatch):
    """Loss, gradients and the BN state against the JAX package under
    the same policy; dropout ratio 0, since the two packages' masks come
    from different generators."""
    jn = JNet(_bn_drop_net(jdsl, 0.0), 0)
    tn = TNet(_bn_drop_net(tdsl, 0.0), TRAIN, device="cpu")
    jparams, jstate = jn.init(jax.random.PRNGKey(3))
    tparams, tstate = params_from_numpy(
        tn, {k: [np.asarray(a) for a in v] for k, v in jparams.items()},
        {k: [np.asarray(a) for a in v] for k, v in jstate.items()})
    batch = _batch(1)
    monkeypatch.setenv("SPARKNET_REMAT", {"dots": "dots", "full": "1"}[pol])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, (jblobs, jnew)), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jn.loss_fn(p, jstate, jb, jax.random.PRNGKey(0)),
        has_aux=True))(jparams)
    loss, grads, new_state, blobs = _port_step(tn, tparams, tstate, batch,
                                               None)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    # b1/conv's bias gradient is zero but for rounding (BatchNorm takes
    # the mean out), so the floor is 1e-5 of the net's largest gradient
    top = max(float(np.abs(np.asarray(g)).max())
              for gs in jgrads.values() for g in gs)
    for k, gs in grads.items():
        for g, jg in zip(gs, jgrads[k]):
            np.testing.assert_allclose(g.numpy(), np.asarray(jg),
                                       rtol=1e-5, atol=1e-5 * top,
                                       err_msg=k)
    for k, st in new_state.items():
        for a, b in zip(st, jnew[k]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-6)
    # segment-internal blobs are absent in both packages alike
    assert sorted(blobs) == sorted(jblobs)
    assert "b1/conv" not in blobs


def test_eval_runs_no_remat(monkeypatch):
    monkeypatch.setenv("SPARKNET_REMAT", "full")
    net = TNet(_bn_drop_net(tdsl, 0.5), TRAIN, device="cpu")
    params, state = net.init(torch.Generator().manual_seed(0))
    with torch.inference_mode():
        blobs, _ = net.apply(params, state, _batch(), train=False)
    assert "b1/conv" in blobs and "fc/ip" in blobs
    with pytest.raises(ValueError, match="none|dots|full"):
        monkeypatch.setenv("SPARKNET_REMAT", "some")
        net.apply(params, state, _batch(), train=True)


def _renamed_top(lp, top):
    lp.clear("top")
    lp.top.append(top)
    return lp


def _stale_net(dsl):
    """"x" is produced before the "blk/" segment, re-topped by blk/ip and
    overwritten in place by blk/relu inside it (the JAX package's
    test_remat_no_stale_pre_segment_blob)."""
    return dsl.NetParam(
        "stale",
        dsl.RDDLayer("data", [2, 8]), dsl.RDDLayer("label", [2, 8]),
        dsl.EmbedLayer("emb", ["data"], 16, 8, weight_filler=XAVIER),
        _renamed_top(dsl.InnerProductLayer(
            "pre", ["emb"], 8, weight_filler=XAVIER, axis=2), "x"),
        _renamed_top(dsl.InnerProductLayer(
            "blk/ip", ["x"], 8, weight_filler=XAVIER, axis=2), "x"),
        dsl.ReLULayer("blk/relu", ["x"], tops=["x"]),
        dsl.InnerProductLayer("blk/head", ["x"], 16, weight_filler=XAVIER,
                              axis=2),
        dsl.SoftmaxWithLoss("loss", ["blk/head", "label"], axis=2))


def test_no_stale_pre_segment_blob_as_in_jax(monkeypatch):
    batch = {"data": np.arange(16).reshape(2, 8).astype(np.int32) % 16,
             "label": np.zeros((2, 8), np.int32)}
    jn = JNet(_stale_net(jdsl), 0)
    tn = TNet(_stale_net(tdsl), TRAIN, device="cpu")
    assert tn._remat_groups() == jn._remat_groups() != {}
    jparams, _ = jn.init(jax.random.PRNGKey(0))
    tparams, _ = params_from_numpy(
        tn, {k: [np.asarray(a) for a in v] for k, v in jparams.items()})
    monkeypatch.setenv("SPARKNET_REMAT", "1")
    jblobs, _ = jn.apply(jparams, {}, batch, train=True)
    blobs, _ = tn.apply(tparams, {}, batch, train=True,
                        generator=torch.Generator().manual_seed(0))
    assert "x" not in blobs and "x" not in jblobs
    assert sorted(blobs) == sorted(jblobs)
    np.testing.assert_allclose(blobs["loss"].detach().numpy(),
                               np.asarray(jblobs["loss"]), rtol=1e-5)


def _kernel_net(dsl):
    """GoogLeNet's two kernel sites in miniature: a standalone LRN in
    segment "pool1" and conv -> ReLU -> LRN (the fused epilogue under
    SPARKNET_EPILOGUE=on) in segment "conv2"."""
    return dsl.NetParam(
        "sites",
        dsl.RDDLayer("data", (2, 3, 12, 12)), dsl.RDDLayer("label", (2,)),
        dsl.ConvolutionLayer("conv1", ["data"], (3, 3), 8, pad=(1, 1),
                             weight_filler=XAVIER),
        dsl.PoolingLayer("pool1/pool", ["conv1"], "MAX", (2, 2), (2, 2)),
        dsl.LRNLayer("pool1/norm1", ["pool1/pool"], local_size=5,
                     alpha=1e-4, beta=0.75),
        dsl.ConvolutionLayer("conv2/conv", ["pool1/norm1"], (3, 3), 8,
                             pad=(1, 1), weight_filler=XAVIER,
                             bias_filler=dict(type="constant", value=0.1)),
        dsl.ReLULayer("conv2/relu", ["conv2/conv"], tops=["conv2/conv"]),
        dsl.LRNLayer("conv2/norm2", ["conv2/conv"], local_size=5,
                     alpha=1e-4, beta=0.75),
        dsl.InnerProductLayer("out", ["conv2/norm2"], 10,
                              weight_filler=XAVIER),
        dsl.SoftmaxWithLoss("loss", ["out", "label"]))


def test_hand_kernels_are_recomputed_whole(monkeypatch):
    """Under dots and full each forward of the LRN and the fused
    epilogue runs twice an iteration (the forward and the recompute; the
    ctypes launch is not an aten op, so no policy saves it), each
    backward once, and the gradients stay bit for bit."""
    monkeypatch.setenv("SPARKNET_EPILOGUE", "on")
    calls = {}

    def counting(mod, name):
        fn = getattr(mod, name)

        def wrapped(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)

    counting(cuda_lrn, "_lrn_forward")
    counting(cuda_lrn, "lrn_across_bwd")
    counting(cuda_epilogue, "_bias_relu_lrn_forward")
    counting(cuda_epilogue, "bias_relu_lrn_bwd")
    net = TNet(_kernel_net(tdsl), TRAIN, device="cpu")
    params, state = net.init(torch.Generator().manual_seed(0))
    rs = np.random.RandomState(2)
    batch = {"data": rs.randn(2, 3, 12, 12).astype(np.float32),
             "label": rs.randint(0, 10, 2)}
    out = {}
    for pol in ("none", "dots", "full"):
        calls.clear()
        out[pol] = _port_step(net, params, state, batch, pol)
        out[pol] += (dict(calls),)
    assert out["none"][4] == {"_lrn_forward": 1, "lrn_across_bwd": 1,
                              "_bias_relu_lrn_forward": 1,
                              "bias_relu_lrn_bwd": 1}
    for pol in ("dots", "full"):
        assert out[pol][4] == {"_lrn_forward": 2, "lrn_across_bwd": 1,
                               "_bias_relu_lrn_forward": 2,
                               "bias_relu_lrn_bwd": 1}, pol
        for k in out["none"][1]:
            for a, b in zip(out[pol][1][k], out["none"][1][k]):
                assert torch.equal(a, b), (pol, k)


def test_precision_reaches_no_cnn_layer_as_in_jax(monkeypatch):
    """C8: SPARKNET_PRECISION=bf16 resolves net.compute_dtype, in both
    packages, but the layers keep the constructor's None: a CNN's loss
    and gradients are the fp32 ones bit for bit."""
    net32 = TNet(_bn_drop_net(tdsl, 0.0), TRAIN, device="cpu")
    params, state = net32.init(torch.Generator().manual_seed(0))
    ref = _port_step(net32, params, state, _batch(), "none")
    monkeypatch.setenv("SPARKNET_PRECISION", "bf16")
    net16 = TNet(_bn_drop_net(tdsl, 0.0), TRAIN, device="cpu")
    jnet16 = JNet(_bn_drop_net(jdsl, 0.0), 0)
    assert net16.compute_dtype == torch.bfloat16
    assert jnet16.compute_dtype == jnp.bfloat16
    assert all(getattr(impl, "compute_dtype", None) is None
               for _, impl, _, _ in net16.layers)
    got = _port_step(net16, params, state, _batch(), "none")
    assert torch.equal(got[0], ref[0])
    for k in ref[1]:
        for a, b in zip(got[1][k], ref[1][k]):
            assert torch.equal(a, b), k
    monkeypatch.setenv("SPARKNET_PRECISION", "fp16")
    with pytest.raises(ValueError, match="bf16|fp32"):
        TNet(_bn_drop_net(tdsl, 0.0), TRAIN, device="cpu")


def test_solver_set_remat_reaches_every_net():
    from sparknet_tpu_torch.parallel import DataParallelSolver
    from sparknet_tpu_torch.proto import Message
    sp = Message("SolverParameter", base_lr=0.01, lr_policy="fixed",
                 display=0)
    sp.net_param = _bn_drop_net(tdsl, 0.5)
    s = DataParallelSolver(sp, workers=2, device="cpu")
    s.set_remat("dots")
    assert s.net.remat == s.local_net.remat == "dots"
    with pytest.raises(ValueError, match="remat policy"):
        s.set_remat("most")


# -- the verbs' flags ------------------------------------------------------

def _losses(main, argv):
    import contextlib
    import io
    import re
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return [float(v) for v in
            re.findall(r"Iteration \d+, loss = (\S+),", buf.getvalue())]


def test_train_verb_takes_remat_and_precision_as_the_jax_verb(tmp_path,
                                                              monkeypatch):
    """The train verb under --remat none/dots/full and --precision bf16
    prints the same losses bit for bit; the JAX verb under --remat full
    from the same weights (a JAX snapshot) prints them within 1e-5."""
    from sparknet_tpu import cli as jcli
    from sparknet_tpu.proto import Message as JMessage
    from sparknet_tpu.solver.solver import Solver as JSolver
    from sparknet_tpu_torch import cli
    from sparknet_tpu_torch.proto import Message, text_format
    sp = Message("SolverParameter", base_lr=0.05, momentum=0.9,
                 lr_policy="fixed", display=1, max_iter=3, random_seed=2)
    sp.net_param = _bn_drop_net(tdsl, 0.0)
    text_format.dump(sp, str(tmp_path / "solver.prototxt"))
    jsp = JMessage("SolverParameter", base_lr=0.05, lr_policy="fixed")
    jsp.net_param = _bn_drop_net(jdsl, 0.0)
    weights, _ = JSolver(jsp, log_fn=None).snapshot(str(tmp_path / "w"))
    base = ["train", "--solver", str(tmp_path / "solver.prototxt"),
            "--weights", weights]
    runs = []
    for flags in ([], ["--remat", "dots"],
                  ["--remat", "full", "--precision", "bf16"]):
        runs.append(_losses(cli.main, base + ["--device", "cpu"] + flags))
        monkeypatch.setenv("SPARKNET_REMAT", "none")
        monkeypatch.setenv("SPARKNET_PRECISION", "fp32")
    assert len(runs[0]) == 3 and runs[0] == runs[1] == runs[2]
    jlosses = _losses(jcli.main, base + ["--remat", "full"])
    np.testing.assert_allclose(runs[0], jlosses, rtol=1e-5)


def test_lm_and_serve_verbs_take_remat_precision_and_scan(tmp_path,
                                                         monkeypatch,
                                                         capsys):
    from sparknet_tpu_torch import cli
    tiny = ["lm", "--device", "cpu", "--vocab", "32", "--seq-len", "16",
            "--batch", "2", "--d-model", "16", "--layers", "2", "--heads",
            "2", "--display", "1", "--steps", "3"]
    runs = []
    for flags in ([], ["--remat", "dots", "--scan", "off"],
                  ["--remat", "full", "--scan", "auto", "--precision",
                   "bf16"]):
        runs.append(_losses(cli.main, tiny + flags))
        monkeypatch.setenv("SPARKNET_REMAT", "none")
        monkeypatch.setenv("SPARKNET_PRECISION", "fp32")
    assert len(runs[0]) == 3 and runs[0] == runs[1] == runs[2]
    for verb in (tiny, ["serve", "--prefix", str(tmp_path / "none"),
                        "--device", "cpu"]):
        with pytest.raises(SystemExit) as e:
            cli.main(verb + ["--scan", "on"])
        assert e.value.code == 2
        assert "ROADMAP A5" in capsys.readouterr().err
    # serve takes the flags; a prefix with no snapshot is exit 3
    assert cli.main(["serve", "--prefix", str(tmp_path / "none"),
                     "--device", "cpu", "--remat", "full", "--precision",
                     "bf16", "--scan", "off"]) == 3
