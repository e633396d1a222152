"""The layer zoo of the port against the JAX package's layers on the CPU:
every layer type besides those of the GoogLeNet, CaffeNet and LM paths
(tests/test_torch_layers.py, test_torch_lm.py), each built through its
own package's registry from the same layer fields and fed the same
seeded numpy inputs, forward and gradient (``jax.vjp`` against
``torch.autograd.grad`` of one seeded cotangent).

Tolerances: both sides compute in float32. Elementwise and structural
layers, pooling, BatchNorm and the Python layer: rtol 1e-5, atol 1e-6.
Deconvolution: rtol 1e-4 and atol 1e-5 times the largest absolute
value, as for Convolution in test_torch_layers.py (XLA:CPU and
PyTorch's CPU kernels sum the products in different orders).
STOCHASTIC pooling's TRAIN draws cannot match the JAX package's bits:
each drawn value is checked against its window, and the frequencies
against p / sum(p) by a chi-square bound.
"""

import sys
import textwrap

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import sparknet_tpu.graph.compiler  # noqa: F401  (registers the layers)
import sparknet_tpu_torch.graph  # noqa: F401
from sparknet_tpu.graph.registry import _REGISTRY as J_REGISTRY
from sparknet_tpu.graph.registry import get as jget
from sparknet_tpu.proto import Message as JMessage
from sparknet_tpu_torch import Layer, register_layer
from sparknet_tpu_torch.graph.compiler import CompiledNet as TNet
from sparknet_tpu_torch.graph.registry import _REGISTRY as T_REGISTRY
from sparknet_tpu_torch.graph.registry import get as tget
from sparknet_tpu_torch.models import dsl as tdsl
from sparknet_tpu_torch.proto import Message as TMessage

TRAIN, TEST = 0, 1
ELEMENTWISE = dict(rtol=1e-5, atol=1e-6)


def _pair(type_name, bottom_shapes, phase=TEST, **fields):
    jl = jget(type_name)(JMessage("LayerParameter", name="t", type=type_name,
                                  **fields), bottom_shapes, phase)
    tl = tget(type_name)(TMessage("LayerParameter", name="t", type=type_name,
                                  **fields), bottom_shapes, phase)
    assert [tuple(s) for s in tl.out_shapes()] == \
        [tuple(s) for s in jl.out_shapes()]
    return jl, tl


def _floating(a):
    return np.issubdtype(np.asarray(a).dtype, np.floating)


def _run(type_name, bottom_shapes, seed=0, inputs=None, param_scale=0.5,
         phase=TEST, **fields):
    """-> [(jax value, port value)] for every top, then every param's and
    every bottom's gradient under one seeded cotangent of the float
    tops."""
    rs = np.random.RandomState(seed)
    jl, tl = _pair(type_name, bottom_shapes, phase, **fields)
    params = [(param_scale * rs.randn(*shape)).astype(np.float32)
              for shape, *_ in jl.param_shapes()]
    assert [p.shape for p in params] == \
        [tuple(s) for s, *_ in tl.param_shapes()]
    xs = inputs if inputs is not None else \
        [rs.randn(*s).astype(np.float32) for s in bottom_shapes]
    train = phase == TRAIN

    jout = [np.asarray(o) for o in jl.apply(
        [jnp.asarray(p) for p in params], [jnp.asarray(x) for x in xs],
        train, None)]
    cots = [np.asarray(rs.randn(*o.shape), np.float32) if _floating(o)
            else None for o in jout]

    def jfloat(ps, bs):
        outs = jl.apply(ps, bs, train, None)
        return [o for o, c in zip(outs, cots) if c is not None]

    _, vjp = jax.vjp(jfloat, [jnp.asarray(p) for p in params],
                     [jnp.asarray(x) for x in xs])
    jgp, jgx = vjp([jnp.asarray(c) for c in cots if c is not None])

    tp = [torch.from_numpy(p).requires_grad_(True) for p in params]
    tx = [torch.from_numpy(x).requires_grad_(_floating(x)) for x in xs]
    tout = tl.apply(tp, tx, train)
    assert len(tout) == len(jout)
    loss = sum((o * torch.from_numpy(c)).sum()
               for o, c in zip(tout, cots) if c is not None)
    wrt = [t for t in tp + tx if t.requires_grad]
    if torch.is_tensor(loss) and loss.requires_grad and wrt:
        got = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
    else:
        got = iter([None] * len(wrt))
    tgrads = []
    for t in tp + tx:
        g = next(got) if t.requires_grad else None
        tgrads.append(torch.zeros_like(t) if g is None else g)

    pairs = [(j, t.detach().numpy()) for j, t in zip(jout, tout)]
    pairs += [(np.asarray(j), g.numpy()) for j, g, x in
              zip(list(jgp) + list(jgx), tgrads, params + xs)
              if _floating(x)]
    return pairs


def _close(pairs, rtol=1e-5, atol=1e-6):
    for j, t in pairs:
        assert t.shape == j.shape and t.dtype == j.dtype, \
            (t.shape, j.shape, t.dtype, j.dtype)
        np.testing.assert_allclose(t, j, rtol=rtol, atol=atol)


def _close_scaled(pairs):
    for j, t in pairs:
        assert t.shape == j.shape and np.abs(j).max() > 0
        np.testing.assert_allclose(t, j, rtol=1e-4,
                                   atol=1e-5 * np.abs(j).max())


# -- the registry ----------------------------------------------------------
def test_registry_holds_exactly_the_jax_packages_types():
    assert sorted(T_REGISTRY) == sorted(J_REGISTRY)
    assert len(T_REGISTRY) == 55


def test_unknown_type_names_the_registered_ones():
    with pytest.raises(KeyError, match="'NoSuchLayer'.*Deconvolution"):
        tget("NoSuchLayer")


def test_register_layer_adds_a_type_of_its_own():
    @register_layer
    class TimesThree(Layer):
        type_name = "ZooTimesThree"

        def out_shapes(self):
            return [self.bottom_shapes[0]]

        def apply(self, params, bottoms, train):
            return [3 * bottoms[0]]

    try:
        net = tdsl.NetParam("t", tdsl.RDDLayer("x", [2, 3]),
                            tdsl._base("ZooTimesThree", "y", ["x"]))
        tn = TNet(net, TEST, device="cpu")
        blobs, _ = tn.apply(*tn.init(), {"x": np.ones((2, 3), np.float32)})
        np.testing.assert_array_equal(blobs["y"].numpy(), 3.0)
        with pytest.raises(ValueError, match="duplicate"):
            register_layer(TimesThree)
    finally:
        T_REGISTRY.pop("ZooTimesThree")


# -- neuron layers -----------------------------------------------------------
SHAPE = (2, 3, 4, 5)


@pytest.mark.parametrize("type_name,fields", [
    pytest.param("Sigmoid", {}, id="sigmoid"),
    pytest.param("TanH", {}, id="tanh"),
    pytest.param("AbsVal", {}, id="absval"),
    pytest.param("Power", dict(power_param=dict(power=2.0, scale=0.5,
                                                shift=1.5)), id="power2"),
    pytest.param("Power", dict(power_param=dict(power=1.0, scale=2.0,
                                                shift=-1.0)), id="power1"),
    pytest.param("Power", dict(power_param=dict(power=0.5, scale=0.5,
                                                shift=4.0)), id="sqrt"),
    pytest.param("Exp", dict(exp_param=dict(scale=0.5, shift=0.1)),
                 id="exp-e"),
    pytest.param("Exp", dict(exp_param=dict(base=2.0, scale=0.3,
                                            shift=-0.2)), id="exp-base2"),
    pytest.param("Log", dict(log_param=dict(shift=5.0)), id="log-e"),
    pytest.param("Log", dict(log_param=dict(base=10.0, scale=0.5,
                                            shift=4.0)), id="log-base10"),
    pytest.param("Threshold", dict(threshold_param=dict(threshold=0.3)),
                 id="threshold"),
    pytest.param("PReLU", {}, id="prelu"),
    pytest.param("PReLU", dict(prelu_param=dict(channel_shared=True)),
                 id="prelu-shared"),
])
def test_neuron_layer(type_name, fields):
    _close(_run(type_name, [SHAPE], **fields), **ELEMENTWISE)


def test_bnll_overflow_safe_form():
    x = np.concatenate([np.random.RandomState(1).randn(40) * 3,
                        [-100.0, -30.0, 30.0, 100.0]]).astype(np.float32)
    pairs = _run("BNLL", [x.shape], inputs=[x])
    _close(pairs, **ELEMENTWISE)
    assert np.isfinite(pairs[0][1]).all()
    np.testing.assert_allclose(pairs[0][1][-4:], [0.0, 9.357623e-14, 30.0,
                                                  100.0], rtol=1e-6,
                               atol=1e-30)


def test_threshold_passes_no_gradient():
    pairs = _run("Threshold", [SHAPE], threshold_param=dict(threshold=0.0))
    (jy, ty), (jg, tg) = pairs
    assert set(np.unique(ty)) == {0.0, 1.0}
    assert not tg.any() and not jg.any()


def test_prelu_slope_fills_with_a_quarter_unless_named():
    _, tl = _pair("PReLU", [SHAPE])
    (shape, filler, lr, decay), = tl.param_shapes()
    assert shape == (3,) and filler.type == "constant" and \
        filler.value == 0.25
    _, tl = _pair("PReLU", [SHAPE], prelu_param=dict(
        channel_shared=True, filler=dict(type="constant", value=0.1)))
    (shape, filler, _, _), = tl.param_shapes()
    assert shape == (1,) and filler.value == pytest.approx(0.1)


# -- structural layers -------------------------------------------------------
@pytest.mark.parametrize("shape,fields", [
    pytest.param((2, 5, 3), dict(top=["a", "b", "c"], slice_param=dict(
        axis=1, slice_point=[1, 3])), id="points"),
    pytest.param((6, 2, 3), dict(top=["a", "b", "c"], slice_param=dict(
        axis=0)), id="equal"),
    pytest.param((2, 4, 3, 3), dict(top=["a", "b"], slice_param=dict(
        slice_dim=1)), id="slice_dim"),
    pytest.param((2, 3, 8), dict(top=["a", "b"], slice_param=dict(
        axis=-1, slice_point=[5])), id="negative-axis"),
])
def test_slice(shape, fields):
    _close(_run("Slice", [shape], **fields), **ELEMENTWISE)


def test_split_sums_the_fan_out_gradients():
    pairs = _run("Split", [SHAPE], top=["a", "b", "c"])
    _close(pairs, **ELEMENTWISE)
    assert len(pairs) == 4


@pytest.mark.parametrize("fields", [
    pytest.param(dict(shape=dict(dim=[0, -1])), id="keep-infer"),
    pytest.param(dict(axis=1, num_axes=2, shape=dict(dim=[-1])),
                 id="axis-num_axes"),
    pytest.param(dict(shape=dict(dim=[0, 0, 2, -1, 5])), id="split-dim"),
    pytest.param(dict(axis=-1, num_axes=0, shape=dict(dim=[1, 1])),
                 id="append"),
])
def test_reshape(fields):
    _close(_run("Reshape", [SHAPE], reshape_param=fields), **ELEMENTWISE)


@pytest.mark.parametrize("axis,tiles", [(1, 3), (0, 2), (-1, 2)])
def test_tile(axis, tiles):
    _close(_run("Tile", [SHAPE], tile_param=dict(axis=axis, tiles=tiles)),
           **ELEMENTWISE)


@pytest.mark.parametrize("fields", [
    pytest.param(dict(top_k=3), id="flat"),
    pytest.param(dict(top_k=2, out_max_val=True), id="flat-max_val"),
    pytest.param(dict(axis=1, top_k=2), id="axis"),
    pytest.param(dict(axis=3, top_k=1, out_max_val=True),
                 id="axis-max_val"),
])
def test_argmax(fields):
    _close(_run("ArgMax", [SHAPE], argmax_param=fields), **ELEMENTWISE)


@pytest.mark.parametrize("fields", [
    pytest.param({}, id="sum-all"),
    pytest.param(dict(operation="ASUM", axis=1), id="asum"),
    pytest.param(dict(operation="SUMSQ", axis=2, coeff=0.5), id="sumsq"),
    pytest.param(dict(operation="MEAN", axis=1, coeff=-2.0), id="mean"),
])
def test_reduction(fields):
    _close(_run("Reduction", [SHAPE], reduction_param=fields),
           **ELEMENTWISE)


def test_silence_produces_nothing():
    jl, tl = _pair("Silence", [SHAPE, (2,)])
    assert tl.out_shapes() == [] and tl.apply([], [torch.ones(SHAPE),
                                                   torch.ones(2)], True) == []


def test_batch_reindex():
    rs = np.random.RandomState(3)
    x = rs.randn(4, 3, 2).astype(np.float32)
    idx = np.array([3.0, 0.0, 0.7, 3.2, 2.0, 0.0], np.float32)
    _close(_run("BatchReindex", [x.shape, idx.shape], inputs=[x, idx]),
           **ELEMENTWISE)


@pytest.mark.parametrize("count", [False, True])
def test_filter_compacts_the_selected_rows(count):
    rs = np.random.RandomState(4)
    x = rs.randn(6, 3, 2).astype(np.float32)
    y = rs.randn(6).astype(np.float32)
    sel = np.array([[0], [1], [1], [0], [2], [0]], np.float32)
    tops = ["fx", "fy"] + (["n"] if count else [])
    pairs = _run("Filter", [x.shape, y.shape, sel.shape],
                 inputs=[x, y, sel], top=tops)
    _close(pairs, **ELEMENTWISE)
    fx = pairs[0][1]
    np.testing.assert_array_equal(fx[:3], x[[1, 2, 4]])
    assert not fx[3:].any()
    if count:
        assert pairs[2][1].dtype == np.int32 and int(pairs[2][1]) == 3
    gx = pairs[-3][1]          # x's gradient: zero on the rows dropped
    assert not gx[[0, 3, 5]].any() and gx[[1, 2, 4]].any()


def test_filter_refuses_a_selector_of_the_wrong_shape():
    with pytest.raises(ValueError, match="singletons"):
        _pair("Filter", [(6, 3), (6, 2)], top=["a"])
    with pytest.raises(ValueError, match="batch"):
        _pair("Filter", [(5, 3), (6,)], top=["a"])


# -- convolutions ------------------------------------------------------------
@pytest.mark.parametrize("shape,conv", [
    pytest.param((2, 4, 5, 6), dict(num_output=6, kernel_h=3, kernel_w=2,
                                    stride_h=2, stride_w=3, pad_h=1,
                                    pad_w=0, group=2), id="group-rect"),
    pytest.param((2, 3, 7, 7), dict(num_output=5, kernel_size=[4],
                                    stride=[2], pad=[1]), id="4s2p1"),
    pytest.param((1, 4, 6, 5), dict(num_output=4, kernel_size=[3],
                                    bias_term=False), id="nobias"),
])
def test_deconvolution(shape, conv):
    _close_scaled(_run("Deconvolution", [shape], convolution_param=conv))


@pytest.mark.parametrize("shape,conv", [
    pytest.param((2, 3, 7, 6), dict(kernel_size=[3], stride=[2], pad=[1]),
                 id="3s2p1"),
    pytest.param((1, 2, 5, 8), dict(kernel_h=2, kernel_w=3, stride_h=1,
                                    stride_w=2), id="rect"),
])
def test_im2col_channel_order(shape, conv):
    pairs = _run("Im2col", [shape], convolution_param=conv)
    _close(pairs[:1], rtol=0, atol=0)     # the columns: copies, bit equal
    _close(pairs[1:], **ELEMENTWISE)      # overlapping windows' sums
    # channel-major: column c*kh*kw + i*kw + j is x[c, i + .., j + ..]
    n, c, h, w = shape
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    kh = conv.get("kernel_h", (conv.get("kernel_size") or [0])[0])
    kw = conv.get("kernel_w", kh)
    if conv.get("pad", [0])[0] == 0:
        cols = pairs[0][1]
        assert cols[0, (c - 1) * kh * kw + kw + 1, 0, 0] == x[0, c - 1, 1, 1]


# -- pooling -----------------------------------------------------------------
def _relu_windows(shape, seed=5):
    """Non-negative inputs (STOCHASTIC pools after a ReLU) with some
    all-zero windows."""
    x = np.maximum(np.random.RandomState(seed).randn(*shape), 0)
    x[:, :, :3, :3] = 0.0
    return x.astype(np.float32)


def _close_stochastic_test(pairs):
    """The TEST-phase forward matches; so do the gradients wherever the
    JAX layer's are finite. In a window whose elements are all 0 its
    gradient is NaN: jnp.maximum(sum, 1e-30) passes the gradient of
    num / 1e-30**2 (0/0 in float32, the square underflows) times 0. The
    port's is 0 there, which is the derivative of the 0 it returns."""
    _close(pairs[:1], **ELEMENTWISE)
    for j, t in pairs[1:]:
        assert np.isfinite(t).all()
        live = np.isfinite(j)
        np.testing.assert_allclose(t[live], j[live], **ELEMENTWISE)


@pytest.mark.parametrize("shape,kernel,stride,pad", [
    ((2, 3, 9, 9), 3, 2, 0),
    ((2, 2, 8, 7), 3, 2, 1),
    ((1, 3, 6, 6), 2, 2, 0),
])
def test_stochastic_pooling_test_phase(shape, kernel, stride, pad):
    pp = dict(pool="STOCHASTIC", kernel_size=kernel, stride=stride)
    if pad:
        pp["pad"] = pad
    pairs = _run("Pooling", [shape], inputs=[_relu_windows(shape)],
                 pooling_param=pp)
    _close_stochastic_test(pairs)
    assert (pairs[0][1] == 0).any()        # the all-zero windows give 0


def _stochastic_train(x, kernel, stride, seed=0):
    lp = TMessage("LayerParameter", name="p", type="Pooling",
                  pooling_param=dict(pool="STOCHASTIC", kernel_size=kernel,
                                     stride=stride))
    layer = tget("Pooling")(lp, [x.shape], TRAIN)
    assert layer.needs_rng
    xt = torch.from_numpy(x).requires_grad_(True)
    y, = layer.apply([], [xt], True, torch.Generator().manual_seed(seed))
    return layer, xt, y


def test_stochastic_pooling_train_draws_an_element_of_each_window():
    x = np.random.RandomState(6).randn(2, 3, 9, 9).astype(np.float32)
    layer, xt, y = _stochastic_train(x, 3, 2)
    (oh, ow) = layer.out
    for i in range(oh):
        for j in range(ow):
            win = x[:, :, 2 * i:2 * i + 3, 2 * j:2 * j + 3].reshape(2, 3, -1)
            drawn = y[:, :, i, j].detach().numpy()[..., None]
            assert (win == drawn).any(axis=-1).all()
            # a window with a positive element never draws a non-positive
            pos = (win > 0).any(axis=-1)
            assert (drawn[..., 0][pos] > 0).all()
    # the gradient lands on the drawn element alone
    g, = torch.autograd.grad(y.sum(), xt)
    assert g.sum() == y.numel() and set(g.unique().tolist()) <= {0.0, 1.0,
                                                                 2.0}


# Pearson's chi-square over 3 degrees of freedom: P(X > 16.27) = 0.001
CHI2_3DOF_LIMIT = 16.27


@pytest.mark.parametrize("window,probs", [
    pytest.param([1.0, 2.0, 3.0, 4.0], [0.1, 0.2, 0.3, 0.4], id="positive"),
    pytest.param([-1.0, 0.5, 2.0, 1.5], [0.0, 0.125, 0.5, 0.375],
                 id="mixed"),
    pytest.param([-1.0, -2.0, -3.0, -4.0], [0.25] * 4, id="dead-uniform"),
])
def test_stochastic_pooling_train_frequencies(window, probs):
    n = 4000
    x = np.tile(np.asarray(window, np.float32).reshape(1, 1, 2, 2),
                (n, 1, 1, 1))
    _, _, y = _stochastic_train(x, 2, 2, seed=7)
    drawn = y.detach().numpy().ravel()
    counts = np.array([(drawn == v).sum() for v in window], np.float64)
    assert counts.sum() == n
    expect = n * np.asarray(probs)
    assert (counts[expect == 0] == 0).all()
    live = expect > 0
    chi2 = float((((counts - expect) ** 2)[live] / expect[live]).sum())
    assert chi2 < CHI2_3DOF_LIMIT, (counts, expect, chi2)


@pytest.mark.parametrize("method", ["MAX", "AVE", "STOCHASTIC"])
@pytest.mark.parametrize("shape,height", [((2, 3, 13, 13), 3),
                                          ((1, 2, 10, 7), 2)])
def test_spp(method, shape, height):
    x = _relu_windows(shape) if method == "STOCHASTIC" else None
    pairs = _run("SPP", [shape], inputs=None if x is None else [x],
                 spp_param=dict(pool=method, pyramid_height=height))
    if method == "STOCHASTIC":
        _close_stochastic_test(pairs)
    else:
        _close(pairs, **ELEMENTWISE)


# -- BatchNorm ---------------------------------------------------------------
def _bn(phase, shape, state, train, seed=8, **bn):
    rs = np.random.RandomState(seed)
    x = (rs.randn(*shape) * 2 + 0.5).astype(np.float32)
    cot = rs.randn(*shape).astype(np.float32)
    jl, tl = _pair("BatchNorm", [shape], phase,
                   **({"batch_norm_param": bn} if bn else {}))

    def jf(xj):
        (y,), st = jl.apply_stateful([], [jnp.asarray(s) for s in state],
                                     [xj], train, None)
        return y, st
    jy, vjp, jst = jax.vjp(jf, jnp.asarray(x), has_aux=True)
    jgx, = vjp(jnp.asarray(cot))
    xt = torch.from_numpy(x).requires_grad_(True)
    (ty,), tst = tl.apply_stateful([], [torch.from_numpy(s) for s in state],
                                   [xt], train)
    tgx, = torch.autograd.grad((ty * torch.from_numpy(cot)).sum(), xt)
    assert not any(s.requires_grad for s in tst)
    return [(np.asarray(jy), ty.detach().numpy()),
            (np.asarray(jgx), tgx.numpy())] + \
        [(np.asarray(a), b.numpy()) for a, b in zip(jst, tst)]


BN_STATE = [np.linspace(-1, 1, 4).astype(np.float32) * 3.0,
            np.linspace(0.5, 2, 4).astype(np.float32) * 3.0,
            np.array([3.0], np.float32)]


@pytest.mark.parametrize("shape", [(8, 4, 3, 5), (16, 4)])
def test_batchnorm_train_normalizes_by_the_batch_and_updates_state(shape):
    pairs = _bn(TRAIN, shape, BN_STATE, True,
                moving_average_fraction=0.9, eps=1e-4)
    _close(pairs, **ELEMENTWISE)
    y, mean, var, s = (p[1] for p in (pairs[0], *pairs[2:]))
    dims = (0,) + tuple(range(2, len(shape)))
    np.testing.assert_allclose(y.mean(axis=dims), 0, atol=1e-5)
    assert s[0] == pytest.approx(0.9 * 3.0 + 1.0)


@pytest.mark.parametrize("phase,train,bn", [
    pytest.param(TEST, False, {}, id="test-phase"),
    pytest.param(TRAIN, True, dict(use_global_stats=True),
                 id="train-use_global"),
])
def test_batchnorm_global_stats(phase, train, bn):
    pairs = _bn(phase, (6, 4, 2, 3), BN_STATE, train, **bn)
    _close(pairs, **ELEMENTWISE)
    for (j, t), s in zip(pairs[2:], BN_STATE):   # the state is unchanged
        np.testing.assert_array_equal(t, s)


def test_batchnorm_before_any_update_divides_by_nothing():
    zero = [np.zeros(4, np.float32), np.zeros(4, np.float32),
            np.zeros(1, np.float32)]
    _close(_bn(TEST, (3, 4, 2, 2), zero, False), **ELEMENTWISE)


def test_batchnorm_state_threads_through_the_net():
    net = tdsl.NetParam(
        "bn", tdsl.RDDLayer("x", [8, 3, 4, 4]),
        tdsl.BatchNormLayer("bn", ["x"], moving_average_fraction=0.5))
    tn = TNet(net, TRAIN, device="cpu")
    params, state = tn.init()
    x = np.random.RandomState(9).randn(8, 3, 4, 4).astype(np.float32)
    _, s1 = tn.apply(params, state, {"x": x})
    _, s2 = tn.apply(params, s1, {"x": x})
    assert float(s1["bn"][2]) == 1.0 and float(s2["bn"][2]) == 1.5
    np.testing.assert_allclose(s2["bn"][0].numpy(),
                               1.5 * x.mean(axis=(0, 2, 3)), rtol=1e-5)
    assert float(state["bn"][2]) == 0.0      # never mutated in place


# -- the Python layer --------------------------------------------------------
USER_MODULE = '''
import numpy as np
import torch
import jax.numpy as jnp


class _Scaled:
    """y = w * x + b with w, b learnable; a second top x**2 in TRAIN
    only through the ``train`` argument."""

    def setup(self, bottom_shapes):
        self.k = float(self.param_str or 1.0)

    def reshape(self, bottom_shapes):
        return [bottom_shapes[0], bottom_shapes[0]]

    def param_shapes(self):
        c = 3
        return [((c,), {"type": "constant", "value": 0.5}, 1.0, 1.0),
                ((c,), None, 2.0, 0.0)]


class TorchScaled(_Scaled):
    def forward(self, params, bottoms, train):
        w, b = params
        x = bottoms[0]
        sq = x * x if train else torch.zeros_like(x)
        return [self.k * w[None, :, None] * x + b[None, :, None], sq]


class JaxScaled(_Scaled):
    def forward(self, params, bottoms, train):
        w, b = params
        x = bottoms[0]
        sq = x * x if train else jnp.zeros_like(x)
        return [self.k * w[None, :, None] * x + b[None, :, None], sq]


class OneTop:
    def reshape(self, bottom_shapes):
        return tuple(bottom_shapes[0])

    def forward(self, params, bottoms):
        return bottoms[0] * 2


class NoForward:
    def reshape(self, bottom_shapes):
        return [bottom_shapes[0]]
'''


@pytest.fixture
def user_module(tmp_path, monkeypatch):
    name = "zoo_user_layers"
    (tmp_path / f"{name}.py").write_text(textwrap.dedent(USER_MODULE))
    monkeypatch.setenv("SPARKNET_PYTHON_LAYER_PATH", str(tmp_path))
    yield name
    sys.modules.pop(name, None)


@pytest.mark.parametrize("phase", [TRAIN, TEST])
def test_python_layer_matches_jax(user_module, phase):
    rs = np.random.RandomState(10)
    shape = (2, 3, 4)
    x = rs.randn(*shape).astype(np.float32)
    params = [rs.randn(3).astype(np.float32) for _ in range(2)]
    cots = [rs.randn(*shape).astype(np.float32) for _ in range(2)]
    layers = []
    for M, get, cls in ((JMessage, jget, "JaxScaled"),
                        (TMessage, tget, "TorchScaled")):
        lp = M("LayerParameter", name="py", type="Python", top=["y", "sq"],
               python_param=dict(module=user_module, layer=cls,
                                 param_str="1.5"))
        layers.append(get("Python")(lp, [shape], phase))
    jl, tl = layers
    assert [s[0] for s in tl.param_shapes()] == [(3,), (3,)]
    assert tl.param_shapes()[0][1].value == 0.5
    assert [s[2:] for s in tl.param_shapes()] == [(1.0, 1.0), (2.0, 0.0)]
    train = phase == TRAIN

    def jf(ps, xj):
        return jl.apply(ps, [xj], train, None)
    jout, vjp = jax.vjp(jf, [jnp.asarray(p) for p in params], jnp.asarray(x))
    (jgw, jgb), jgx = vjp([jnp.asarray(c) for c in cots])
    tp = [torch.from_numpy(p).requires_grad_(True) for p in params]
    xt = torch.from_numpy(x).requires_grad_(True)
    tout = tl.apply(tp, [xt], train)
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(tout, cots))
    tg = torch.autograd.grad(loss, tp + [xt])
    _close([(np.asarray(a), b.detach().numpy()) for a, b in
            zip(list(jout) + [jgw, jgb, jgx], list(tout) + list(tg))],
           **ELEMENTWISE)


def test_python_layer_in_a_net_with_one_bare_top(user_module):
    net = tdsl.NetParam("t", tdsl.RDDLayer("x", [2, 3]), tdsl._base(
        "Python", "y", ["x"], python_param=dict(module=user_module,
                                                layer="OneTop")))
    tn = TNet(net, TEST, device="cpu")
    blobs, _ = tn.apply(*tn.init(), {"x": np.ones((2, 3), np.float32)})
    np.testing.assert_array_equal(blobs["y"].numpy(), 2.0)
    assert user_module in sys.modules
    assert not any("tmp" in p and user_module in p for p in sys.path)


@pytest.mark.parametrize("pp,err,match", [
    pytest.param(dict(module="zoo_no_such_module", layer="X"), ImportError,
                 "SPARKNET_PYTHON_LAYER_PATH", id="no-module"),
    pytest.param(dict(layer="X"), ValueError, "module and layer",
                 id="no-module-field"),
    pytest.param(dict(module="{mod}", layer="Missing"), AttributeError,
                 "has no class 'Missing'", id="no-class"),
    pytest.param(dict(module="{mod}", layer="NoForward"), TypeError,
                 "must define", id="no-forward"),
    pytest.param(dict(module="{mod}", layer="TorchScaled"), ValueError,
                 "returned 2 top", id="top-count"),
])
def test_python_layer_errors_match_jax(user_module, pp, err, match):
    pp = {k: v.format(mod=user_module) for k, v in pp.items()}
    for M, get in ((JMessage, jget), (TMessage, tget)):
        lp = M("LayerParameter", name="py", type="Python", top=["y"],
               python_param=pp)
        with pytest.raises(err, match=match):
            get("Python")(lp, [(2, 3, 4)], TEST)


@pytest.mark.parametrize("neuron", ["PReLU", "Threshold", "ReLU"])
def test_epilogue_fusion_takes_relu_alone(monkeypatch, neuron):
    """conv -> (in place) neuron -> LRN: only a ReLU makes a fusable
    bias+ReLU+LRN site; PReLU and Threshold run as layers of their own
    and give the net's unfused output."""
    net = tdsl.NetParam(
        "t", tdsl.RDDLayer("x", [2, 3, 6, 6]),
        tdsl.ConvolutionLayer("conv", ["x"], (3, 3), 8, pad=(1, 1),
                              weight_filler=dict(type="gaussian", std=0.3),
                              bias_filler=dict(type="constant", value=0.1)),
        tdsl._base(neuron, "act", ["conv"], tops=["conv"]),
        tdsl.LRNLayer("norm", ["conv"], local_size=3, alpha=0.1))
    x = np.random.RandomState(11).randn(2, 3, 6, 6).astype(np.float32)
    outs = {}
    for mode in ("on", "off"):
        monkeypatch.setenv("SPARKNET_EPILOGUE", mode)
        tn = TNet(net, TEST, device="cpu")
        plan = tn._active_epilogue()
        if mode == "on":
            assert plan == ({1: (2, 3)} if neuron == "ReLU" else {})
        params, state = tn.init(torch.Generator().manual_seed(0))
        with torch.inference_mode():
            outs[mode] = tn.apply(params, state, {"x": x})[0]["norm"]
    np.testing.assert_allclose(outs["on"].numpy(), outs["off"].numpy(),
                               **ELEMENTWISE)
