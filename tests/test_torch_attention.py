"""The port's attention path against the JAX package's on the CPU: the
flash-attention plain versions against the Pallas kernel (interpret
mode, as tests/test_flash.py runs it: flash_attention(q, k, v, causal,
None, 128, 128)), forward with its LSE and backward through the port's
autograd.Function; dense_attention; and the layers of the LM's blocks
(Attention on both branches, Embed, PositionalEmbed, LayerNorm, MVN,
Eltwise), each in a one-layer net whose weights come from the JAX net
through params_from_numpy.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: the flash forward atol = rtol = 2e-5 and the backward 5e-4
(tests/test_flash.py's own limits); the layers, f32 on both sides,
1e-6 relative to each output's largest element (summation order alone).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from sparknet_tpu.graph.compiler import CompiledNet as JNet
from sparknet_tpu.models import dsl as jdsl
from sparknet_tpu.ops.pallas_attention import _flash_forward
from sparknet_tpu.ops.pallas_attention import flash_attention as j_flash
from sparknet_tpu.parallel.ring import dense_attention as j_dense
from sparknet_tpu_torch.graph import params_from_numpy
from sparknet_tpu_torch.graph.compiler import CompiledNet as TNet
from sparknet_tpu_torch.models import dsl as tdsl
from sparknet_tpu_torch.ops import cuda_attention as ca
from sparknet_tpu_torch.ops.attention import dense_attention

TRAIN = 0


def _qkv(b, h, s, d, seed):
    rs = np.random.RandomState(seed)
    return [(rs.randn(b, h, s, d) * 0.5).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
def test_flash_forward_and_lse_match_pallas(causal):
    q, k, v = _qkv(2, 3, 256, 64, seed=0)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = np.asarray(j_flash(jq, jk, jv, causal, None, 128, 128))
    _, j_lse = _flash_forward(jq, jk, jv, causal, 1 / 8.0, 128, 128, True)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    n0 = ca.flash_attention.launches
    got = ca.flash_attention(tq, tk, tv, causal)
    o, lse = ca.flash_attention_fwd(tq, tk, tv, causal)
    assert ca.flash_attention.launches == n0       # plain versions on CPU
    assert got.dtype == torch.float32 and lse.shape == (6, 256)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    np.testing.assert_array_equal(o.numpy(), got.numpy())
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse)[..., 0],
                               atol=2e-5, rtol=2e-5)


def _grads_both(shape, causal, seed):
    """dq, dk, dv of sum((O - tgt)^2) through the Pallas kernel (jax.grad)
    and through the port's autograd.Function on CPU tensors."""
    q, k, v = _qkv(*shape, seed=seed)
    tgt = np.random.RandomState(seed + 100).randn(*shape).astype(np.float32)

    def j_loss(q, k, v):
        o = j_flash(q, k, v, causal, None, 128, 128)
        return jnp.sum((o - jnp.asarray(tgt)) ** 2)

    want = jax.grad(j_loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = ca.flash_attention(*ts, causal)
    ((o - torch.from_numpy(tgt)) ** 2).sum().backward()
    return [t.grad.numpy() for t in ts], [np.asarray(w) for w in want]


@pytest.mark.parametrize("shape,causal", [
    pytest.param((1, 2, 256, 64), False, id="full"),
    pytest.param((1, 2, 256, 64), True, id="causal"),
    pytest.param((1, 1, 512, 32), True, id="multi-block-causal-d32"),
])
def test_flash_backward_matches_pallas_grad(shape, causal):
    n0 = (ca.flash_attention_dq.launches, ca.flash_attention_dkv.launches)
    got, want = _grads_both(shape, causal, seed=1)
    assert (ca.flash_attention_dq.launches,
            ca.flash_attention_dkv.launches) == n0
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g, w, atol=5e-4, rtol=5e-4,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("d", [192, 256, 320, 512])
def test_wide_head_dim_flash_matches_pallas(d, causal):
    """head_dim 192 and 256 (the tiled kernels are built up to 256, 192
    zero-padded to it) and 320 and 512 (the wide kernels of
    csrc/flash_wide.cuh on the card): the plain forward, LSE and gradients through
    the port's autograd.Function against the Pallas kernel in interpret
    mode at S = 128, within 1e-5 (f32 on both sides; rtol and atol)."""
    shape = (1, 2, 128, d)
    q, k, v = _qkv(*shape, seed=20 + d)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = np.asarray(j_flash(jq, jk, jv, causal, None, 128, 128))
    _, j_lse = _flash_forward(jq, jk, jv, causal, 1 / np.sqrt(d), 128, 128,
                              True)
    o, lse = ca.flash_attention_fwd(*(torch.from_numpy(a) for a in (q, k, v)),
                                    causal)
    np.testing.assert_allclose(o.numpy(), want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse)[..., 0],
                               atol=1e-5, rtol=1e-5)
    got, ref = _grads_both(shape, causal, seed=30 + d)
    for g, w, name in zip(got, ref, "qkv"):
        assert np.abs(w).max() > 1e-3
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5,
                                   err_msg=f"d{name}")


def test_flash_backward_plain_pieces_agree():
    """flash_attention_bwd_plain is the dQ step then the dK/dV step on its
    delta, and delta is rowsum(dO * O) from O as stored."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 128, 16, seed=3))
    do = torch.from_numpy(_qkv(1, 2, 128, 16, seed=4)[0])
    o, lse = ca.flash_attention_fwd_plain(q, k, v, True)
    dq, delta = ca.flash_attention_dq_plain(q, k, v, o, lse, do, True)
    torch.testing.assert_close(delta, (do * o).sum(-1).reshape(2, 128))
    dk, dv = ca.flash_attention_dkv_plain(q, k, v, do, lse, delta, True)
    for a, b in zip((dq, dk, dv),
                    ca.flash_attention_bwd_plain(q, k, v, o, lse, do, True)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_dense_attention_matches_jax(causal):
    q, k, v = _qkv(2, 2, 96, 16, seed=5)
    want = np.asarray(j_dense(*(jnp.asarray(a) for a in (q, k, v)),
                              causal=causal))
    got = dense_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          causal=causal).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


def test_flash_refuses_tensors_neither_on_cpu_nor_cuda():
    """A wrapper computes the plain version only for CPU tensors; any
    other device must pass the kernels' input checks, which refuse a
    non-CUDA tensor before any launch (meta tensors here; the card's
    refusals are in test_torch_cuda.py)."""
    x = torch.empty(1, 2, 128, 64, device="meta")
    with pytest.raises(ValueError, match="cuda"):
        ca.flash_attention_fwd(x, x, x)
    with pytest.raises(ValueError, match="cuda"):
        ca.flash_attention_dq(x, x, x, x, torch.empty(2, 128), x)


# -- the layers, one per net, weights from the JAX net --------------------
def _one_layer(dsl, feed_shape, make_layer):
    return dsl.NetParam("L", dsl.RDDLayer("x", list(feed_shape)),
                        make_layer(dsl))


def _layer_parity(feed_shape, make_layer, x, seed=0):
    jn = JNet(_one_layer(jdsl, feed_shape, make_layer), TRAIN)
    params, state = jn.init(jax.random.PRNGKey(seed))
    rs = np.random.RandomState(seed)
    # perturb every param so that no filler constant (LayerNorm's 1/0,
    # zero biases) hides a mixed-up blob
    params = {n: [np.asarray(p) + 0.1 * rs.randn(*p.shape).astype(np.float32)
                  for p in v] for n, v in params.items()}
    blobs, _ = jn.apply({n: [jnp.asarray(p) for p in v]
                         for n, v in params.items()}, state,
                        {"x": jnp.asarray(x)}, train=True,
                        rng=jax.random.PRNGKey(1))
    tn = TNet(_one_layer(tdsl, feed_shape, make_layer), TRAIN, device="cpu")
    tp, ts = params_from_numpy(tn, params)
    tblobs, _ = tn.apply(tp, ts, {"x": x})
    top = tn.layers[-1][3][0]
    want, got = np.asarray(blobs[top]), tblobs[top].detach().numpy()
    assert got.shape == want.shape and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


def _x(shape, seed=7):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("s,flash", [
    pytest.param(128, True, id="flash-S128"),
    pytest.param(96, True, id="dense-S96-not-multiple-of-128"),
    pytest.param(128, False, id="dense-flash-off"),
])
def test_attention_layer_matches_jax(s, flash):
    _layer_parity((2, s, 32), lambda d: d.AttentionLayer(
        "attn", ["x"], 2, causal=True, flash=flash), _x((2, s, 32)))


def test_embed_and_positional_embed_match_jax():
    toks = np.random.RandomState(3).randint(0, 50, (2, 12)).astype(np.int32)
    _layer_parity((2, 12), lambda d: d.EmbedLayer(
        "emb", ["x"], 50, 16, weight_filler=dict(type="xavier")), toks)
    _layer_parity((2, 12, 16), lambda d: d.PositionalEmbedLayer(
        "pos", ["x"], 20, 16, weight_filler=dict(type="xavier")),
        _x((2, 12, 16)))


def test_positional_embed_checks_its_table():
    for rows, width, msg in ((8, 16, "sequence length"),
                             (20, 8, "embedding dim")):
        with pytest.raises(ValueError, match=msg):
            TNet(_one_layer(tdsl, (2, 12, 16), lambda d: d.PositionalEmbedLayer(
                "pos", ["x"], rows, width)), TRAIN, device="cpu")


@pytest.mark.parametrize("fields", [{}, dict(eps=1e-3), dict(affine=False)],
                         ids=["default", "eps", "no-affine"])
def test_layer_norm_matches_jax(fields):
    _layer_parity((2, 5, 24), lambda d: d.LayerNormLayer(
        "ln", ["x"], **fields), _x((2, 5, 24)) * 3 + 1)


@pytest.mark.parametrize("mvn", [
    dict(), dict(across_channels=True), dict(normalize_variance=False)],
    ids=["per-channel", "across", "mean-only"])
def test_mvn_matches_jax(mvn):
    def layer(d):
        return d._base("MVN", "mvn", ["x"], **(
            dict(mvn_param=mvn) if mvn else {}))
    _layer_parity((2, 3, 4, 5), layer, _x((2, 3, 4, 5)) * 2 + 0.5)


@pytest.mark.parametrize("op,coeff", [("PROD", None), ("SUM", None),
                                      ("SUM", (0.5, -2.0)), ("MAX", None)])
def test_eltwise_matches_jax(op, coeff):
    def net(dsl):
        return dsl.NetParam(
            "E", dsl.RDDLayer("a", [2, 3, 4]), dsl.RDDLayer("b", [2, 3, 4]),
            dsl.EltwiseLayer("e", ["a", "b"], operation=op, coeff=coeff))
    rs = np.random.RandomState(8)
    feeds = {n: rs.randn(2, 3, 4).astype(np.float32) for n in "ab"}
    jn = JNet(net(jdsl), TRAIN)
    want = np.asarray(jn.apply({}, {}, {k: jnp.asarray(v)
                                        for k, v in feeds.items()},
                               train=True, rng=jax.random.PRNGKey(0))[0]["e"])
    got = TNet(net(tdsl), TRAIN, device="cpu").apply({}, {}, feeds)[0]["e"]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
