"""Inception fission in the port (graph/fission.py, graph/compiler.py,
Convolution.apply_fissioned) against the JAX package's pass, which is on
by default on every backend: loss and gradients on tests/test_fission.py's
two-module net, fission on against off in the port, the STOCHASTIC pool
and remat composing, epilogue sites reading a concat, and which concats
a TRAIN step really computes; on full-width GoogLeNet, that the float32
gap between fission and the literal graph is rounding (float64 closes it)
and that a dropped branch gradient opens a gap far past it."""

import numpy as np
import pytest
import jax
import torch

from sparknet_tpu.graph.compiler import CompiledNet as JNet
from sparknet_tpu.models import dsl as jdsl
from sparknet_tpu_torch.graph import TRAIN, CompiledNet as TNet
from sparknet_tpu_torch.graph import fission
from sparknet_tpu_torch.graph.weights import params_from_numpy
from sparknet_tpu_torch.models import dsl as tdsl


def inception_net(dsl, batch=4, stochastic_pool=False, relu_c1=False,
                  modules=False):
    """tests/test_fission.py's inception_net, built with either package's
    DSL: a concat consumed by convs and a pool chain, the second concat
    reaching the classifier through a global AVE pool. ``relu_c1`` puts
    an in-place ReLU after c1, which makes c1 an epilogue site whose
    bottom is the first concat. ``modules`` names each module's layers
    and blobs "m1/..." and "m2/..." (remat segments, GoogLeNet's
    "inception_3a/..." idiom), so the first concat leaves one segment
    and feeds the next."""
    m1 = {"b1", "b2", "bp", "bp_proj", "inc1"}
    m2 = {"c1", "relu_c1", "c2", "cp", "cp_proj", "inc2"}

    def nm(n):
        if not modules:
            return n
        return f"m1/{n}" if n in m1 else f"m2/{n}" if n in m2 else n

    def conv(name, bottom, num_output, k, pad=None):
        return dsl.ConvolutionLayer(
            nm(name), [nm(bottom)], (k, k), num_output,
            pad=(pad, pad) if pad else None,
            weight_filler=dict(type="gaussian", std=0.05),
            bias_filler=dict(type="constant", value=0.1))

    pool2 = "STOCHASTIC" if stochastic_pool else "MAX"
    layers = [
        dsl.RDDLayer("data", [batch, 8, 16, 16]),
        dsl.RDDLayer("label", [batch]),
        conv("stem", "data", 16, 3, pad=1),
        dsl.ReLULayer("relu_stem", ["stem"], tops=["stem"]),
        conv("b1", "stem", 8, 1),
        conv("b2", "stem", 12, 3, pad=1),
        dsl.PoolingLayer(nm("bp"), ["stem"], "MAX", (3, 3), (1, 1), pad=1),
        conv("bp_proj", "bp", 6, 1),
        dsl.ConcatLayer(nm("inc1"), [nm("b1"), nm("b2"), nm("bp_proj")]),
        conv("c1", "inc1", 10, 1)]
    if relu_c1:
        layers.append(dsl.ReLULayer(nm("relu_c1"), [nm("c1")],
                                    tops=[nm("c1")]))
    layers += [
        conv("c2", "inc1", 14, 3, pad=1),
        dsl.PoolingLayer(nm("cp"), [nm("inc1")], pool2, (3, 3), (1, 1),
                         pad=1),
        conv("cp_proj", "cp", 6, 1),
        dsl.ConcatLayer(nm("inc2"), [nm("c1"), nm("c2"), nm("cp_proj")]),
        dsl.PoolingLayer("gap", [nm("inc2")], "AVE", (16, 16), (1, 1)),
        dsl.InnerProductLayer("fc", ["gap"], 5,
                              weight_filler=dict(type="gaussian", std=0.1)),
        dsl.SoftmaxWithLoss("loss", ["fc", "label"])]
    return dsl.NetParam("fisstest", *layers)


def _batch(seed=1):
    rs = np.random.RandomState(seed)
    return {"data": rs.randn(4, 8, 16, 16).astype(np.float32),
            "label": rs.randint(0, 5, 4).astype(np.int32)}


@pytest.fixture(autouse=True)
def _defaults(monkeypatch):
    for var, val in (("SPARKNET_REMAT", "none"),
                     ("SPARKNET_EPILOGUE", "auto"),
                     ("SPARKNET_FISSION", "1")):
        monkeypatch.setenv(var, val)


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's loss and gradients under its default (fission
    on), and its initial params as numpy."""
    import os
    old = os.environ.get("SPARKNET_FISSION")
    os.environ["SPARKNET_FISSION"] = "1"
    try:
        net = JNet(inception_net(jdsl), 0)
        params, state = net.init(jax.random.PRNGKey(0))
        batch = _batch()
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: net.loss_fn(p, state, batch)[0]))(params)
    finally:
        if old is None:
            os.environ.pop("SPARKNET_FISSION")
        else:
            os.environ["SPARKNET_FISSION"] = old
    as_np = lambda t: {k: [np.asarray(a) for a in v]   # noqa: E731
                       for k, v in t.items()}
    return float(loss), as_np(grads), as_np(params)


def _port_step(net_param, params_np, remat="none", seed=5):
    """Loss, gradients and blobs of one TRAIN forward/backward in the
    port, from the JAX package's initial params."""
    net = TNet(net_param, TRAIN, device="cpu")
    net.remat = remat
    params, state = params_from_numpy(net, params_np, {})
    ps = {k: [p.detach().clone().requires_grad_(True) for p in v]
          for k, v in params.items()}
    loss, (blobs, _) = net.loss_fn(ps, state, _batch(),
                                   torch.Generator().manual_seed(seed))
    loss.backward()
    return (loss.item(), {k: [p.grad.numpy() for p in v]
                          for k, v in ps.items()}, blobs)


def _assert_close(got, ref, rtol_loss=1e-5, atol_grad=1e-4):
    np.testing.assert_allclose(got[0], ref[0], rtol=rtol_loss)
    assert set(got[1]) == set(ref[1])
    for k in ref[1]:
        for a, b in zip(got[1][k], ref[1][k]):
            np.testing.assert_allclose(a, b, rtol=0, atol=atol_grad,
                                       err_msg=k)


class _CountConcat:
    def __init__(self, monkeypatch):
        self.n = 0
        real = fission.Branches.concat

        def counted(branches):
            self.n += 1
            return real(branches)
        monkeypatch.setattr(fission.Branches, "concat", counted)


def test_fission_is_on_by_default(monkeypatch):
    monkeypatch.delenv("SPARKNET_FISSION")
    assert fission.enabled()
    monkeypatch.setenv("SPARKNET_FISSION", "0")
    assert not fission.enabled()


@pytest.mark.parametrize("remat", ["none", "full"])
def test_port_matches_the_jax_package_under_fission(jax_ref, remat):
    loss, grads, params = jax_ref
    got = _port_step(inception_net(tdsl), params, remat=remat)
    _assert_close(got, (loss, grads))


def test_fission_on_agrees_with_off(jax_ref, monkeypatch):
    params = jax_ref[2]
    on = _port_step(inception_net(tdsl), params)
    monkeypatch.setenv("SPARKNET_FISSION", "0")
    off = _port_step(inception_net(tdsl), params)
    _assert_close(on, off)
    assert on[0] != 0.0 and any(np.abs(g).max() > 0
                                for v in on[1].values() for g in v)


def test_stochastic_pool_and_remat_full_compose(jax_ref, monkeypatch):
    """The STOCHASTIC pool is no fission consumer: it reads the
    materialized concat and draws the same windows either way."""
    params = jax_ref[2]
    net_param = inception_net(tdsl, stochastic_pool=True)
    count = _CountConcat(monkeypatch)
    on = _port_step(net_param, params, remat="full")
    assert count.n >= 1
    monkeypatch.setenv("SPARKNET_FISSION", "0")
    off = _port_step(net_param, params, remat="none")
    _assert_close(on, off)


def test_epilogue_site_reading_a_concat_materializes_it(jax_ref,
                                                        monkeypatch):
    """Under SPARKNET_EPILOGUE=on the c1 conv+ReLU is a fused site whose
    bottom is the first concat: it is concatenated before the site runs,
    and the result agrees with the literal, unfused graph."""
    params = jax_ref[2]
    net_param = inception_net(tdsl, relu_c1=True)
    tn = TNet(net_param, TRAIN, device="cpu")
    c1 = [i for i, l in enumerate(tn.layers) if l[0].name == "c1"][0]
    monkeypatch.setenv("SPARKNET_EPILOGUE", "on")
    assert c1 in tn._active_epilogue()
    count = _CountConcat(monkeypatch)
    fused = _port_step(net_param, params)
    # the c1 site's bottom, and fc's pooled branches
    assert count.n == 2
    monkeypatch.setenv("SPARKNET_EPILOGUE", "off")
    monkeypatch.setenv("SPARKNET_FISSION", "0")
    _assert_close(fused, _port_step(net_param, params))


def test_train_step_concatenates_only_what_try_apply_leaves(jax_ref,
                                                            monkeypatch):
    """c1, c2 (convs) and cp (a MAX pool) take inc1 as branches and gap
    (an AVE pool) takes inc2 as branches; the one concat of the step is
    gap's pooled branches into fc, the InnerProduct. inc1 and inc2 are
    never computed until a caller reads them, once each."""
    count = _CountConcat(monkeypatch)
    loss, grads, blobs = _port_step(inception_net(tdsl), jax_ref[2])
    assert count.n == 1
    assert isinstance(dict.__getitem__(blobs, "inc1"), fission.Branches)
    inc1 = blobs["inc1"]
    assert count.n == 2 and torch.is_tensor(inc1)
    assert inc1.shape == (4, 26, 16, 16)
    assert torch.equal(inc1, torch.cat([blobs["b1"], blobs["b2"],
                                        blobs["bp_proj"]], 1))
    assert blobs["inc1"] is inc1 and count.n == 2
    assert all(torch.is_tensor(v) for v in dict(blobs).values())
    # dict() reads the rest: inc2, and the two pools' outputs (cp, gap),
    # which stayed virtual as maps over branches
    assert count.n == 5
    assert isinstance(blobs["gap"], torch.Tensor)


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_policies_are_bit_for_bit_under_fission(jax_ref, remat,
                                                      monkeypatch):
    """The first concat is the "m1/" segment's output and the "m2/"
    segment's input: it crosses both boundaries as branches, so every
    policy runs the same partial convs as none, bit for bit, and
    concatenates only fc's pooled branches."""
    params = {("m1/" if k in ("b1", "b2", "bp_proj") else
               "m2/" if k in ("c1", "c2", "cp_proj") else "") + k: v
              for k, v in jax_ref[2].items()}
    net_param = inception_net(tdsl, modules=True)
    assert TNet(net_param, TRAIN, device="cpu")._remat_groups()
    ref = _port_step(net_param, params)
    count = _CountConcat(monkeypatch)
    got = _port_step(net_param, params, remat=remat)
    assert count.n == 1
    assert got[0] == ref[0]
    for k in ref[1]:
        for a, b in zip(got[1][k], ref[1][k]):
            assert np.array_equal(a, b), (remat, k)


def test_literal_graph_computes_every_concat(jax_ref, monkeypatch):
    monkeypatch.setenv("SPARKNET_FISSION", "0")
    count = _CountConcat(monkeypatch)
    blobs = _port_step(inception_net(tdsl), jax_ref[2])[2]
    assert count.n == 0
    assert all(torch.is_tensor(dict.__getitem__(blobs, k)) for k in blobs)


def _leaf_gap(a, b):
    """The worst leaf's max |a - b| over max |b|, and that leaf: the
    card's fission check (chip_smoke.py phase 16) reads a step's weight
    changes this way."""
    return max((float((x - y).abs().max())
                / max(float(y.abs().max()), 1e-300), f"{k}[{i}]")
               for k in b for i, (x, y) in enumerate(zip(a[k], b[k])))


def _googlenet_grads(net, params, state, batch, dtype):
    ps = {k: [p.detach().to(dtype).requires_grad_(True) for p in v]
          for k, v in params.items()}
    feed = {"data": torch.as_tensor(batch["data"]).to(dtype),
            "label": torch.as_tensor(batch["label"])}
    net.loss_fn(ps, state, feed)[0].backward()
    return {k: [torch.zeros_like(p) if p.grad is None else p.grad.double()
                for p in v] for k, v in ps.items()}


@pytest.fixture(scope="module")
def googlenet_b2():
    from sparknet_tpu_torch.models import zoo
    net_param = zoo.googlenet(batch_size=2)
    for lp in net_param.layer:
        if lp.type == "Dropout":
            lp.dropout_param.dropout_ratio = 0.0
    net = TNet(net_param, TRAIN, device="cpu")
    params, state = net.init(torch.Generator().manual_seed(0))
    rs = np.random.RandomState(0)
    batch = {"data": rs.randn(2, 3, 224, 224).astype(np.float32),
             "label": rs.randint(0, 1000, 2)}
    return net, params, state, batch


def test_googlenet_fission_gap_is_float32_rounding(googlenet_b2,
                                                   monkeypatch):
    """Full-width GoogLeNet's gradients, fission on against off, leaf by
    leaf: in float64 the two dispatches agree to 1e-12 of each leaf's
    largest entry (the same sums in another order), while float32
    leaves a gap at least a thousand times larger. So the gap fission
    opens in a float32 step on the card is summation-order rounding,
    not a term lost."""
    gaps = {}
    for dtype in (torch.float64, torch.float32):
        got = {}
        for arm in ("1", "0"):
            monkeypatch.setenv("SPARKNET_FISSION", arm)
            got[arm] = _googlenet_grads(*googlenet_b2, dtype)
        gaps[dtype] = _leaf_gap(got["1"], got["0"])
    assert gaps[torch.float64][0] <= 1e-12, gaps
    assert gaps[torch.float32][0] >= 1e3 * gaps[torch.float64][0], gaps


def test_dropped_branch_gradient_fails_the_leaf_gap(googlenet_b2,
                                                    monkeypatch):
    """A fissioned conv that drops its first branch's input gradient
    moves some leaf's float64 gradient by far more than phase 16's 5e-2
    limit on a step's weight change, so that check would fail it."""
    from sparknet_tpu_torch.ops.convolution import Convolution
    real = Convolution.apply_fissioned

    def dropped(self, params, branches, train):
        parts = [branches.parts[0].detach()] + branches.parts[1:]
        return real(self, params, fission.Branches(parts), train)

    monkeypatch.setenv("SPARKNET_FISSION", "1")
    ref = _googlenet_grads(*googlenet_b2, torch.float64)
    monkeypatch.setattr(Convolution, "apply_fissioned", dropped)
    gap = _leaf_gap(_googlenet_grads(*googlenet_b2, torch.float64), ref)
    assert gap[0] > 1e-1, gap


def _flip_case(case):
    """Synthetic aux-head ReLU inputs of the two lock-step arms and one
    step's params (start, on, off) for chip_smoke._attributed_gap: every
    on-arm update within rounding of the off arm's, but for ``case``'s
    change."""
    import chip_smoke
    rs = np.random.RandomState(7)
    pre_on, pre_off, start, on, off = {}, {}, {}, {}, {}
    for relu, leaf in chip_smoke.FISSION_RELUS.items():
        shape = (4, 6, 2, 2) if leaf.endswith("conv") else (4, 8)
        a = torch.from_numpy(rs.randn(*shape))
        pre_on[relu] = a
        pre_off[relu] = a + 1e-6 * torch.from_numpy(rs.randn(*shape))
        units = shape[1]
        start[leaf] = [torch.from_numpy(rs.randn(units, 5)),
                       torch.from_numpy(rs.randn(units))]
    start["inception_4a/3x3"] = [torch.from_numpy(rs.randn(6, 5))]
    for k, v in start.items():
        off[k] = [p + torch.from_numpy(rs.randn(*p.shape)) for p in v]
        on[k] = [p + 1e-6 * torch.from_numpy(rs.randn(*p.shape))
                 for p in off[k]]
    fc = "loss1/relu_fc"
    if case in ("near", "clear", "near_other_row"):
        # unit 3 of the first sample takes another sign, and row 3 of
        # loss1/fc's update moves by one sample's share
        x = 3e-7 if case != "clear" else 0.5
        pre_on[fc][0, 3], pre_off[fc][0, 3] = x, -x
        on["loss1/fc"][0][3] += 0.3
    if case == "near_other_row":
        on["loss1/fc"][0][5] += 0.3
    if case == "other_leaf":
        on["inception_4a/3x3"][0][2] += 0.3
    return chip_smoke._attributed_gap(
        torch, start, on, off, chip_smoke._relu_flips(torch, pre_on, pre_off))


@pytest.mark.parametrize("case, attributed", [
    ("none", True), ("near", True), ("clear", False),
    ("near_other_row", False), ("other_leaf", False)])
def test_lock_step_gap_is_attributed_only_to_relu_flips_at_near_ties(
        case, attributed):
    """chip_smoke.py phase 16's update check: a leaf's gap over the 5e-2
    limit passes only as rows of units whose ReLU took another sign in
    the two arms at a near-tie (within twice the arms' largest difference
    of that layer's other inputs); a flip at a clear input, a gap in a
    row that did not flip, or in a leaf with no ReLU flip, fails."""
    import chip_smoke
    worst, after, failed, _ = _flip_case(case)
    assert (failed is None) == attributed, failed
    if case in ("near", "near_other_row", "other_leaf"):
        assert worst[0] > chip_smoke.FISSION_DW_RTOL
    if attributed:
        assert after <= chip_smoke.FISSION_DW_RTOL
