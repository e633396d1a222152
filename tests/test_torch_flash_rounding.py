"""The rounding budget of the bf16 tensor-core flash kernels, on the CPU.

The backward: csrc/flash_bwd.cu's bf16 kernels take bf16 q, k, v, dO;
accumulate S and dP in f32; round P and dS to bf16 before the three
second products (dV = P^T dO, dQ = scale dS K, dK = scale dS^T Q), which
sum in f32; and round dQ, dK, dV to bf16 once. That is emulated here in
plain PyTorch (f32 products of bf16 values are exact, so f32 matmuls
stand for the tensor cores up to summation order; BWD_CASES' "tiles64"
cases also take the wgmma kernels' sum order up to head_dim 128: dQ
over 64-key tiles, dK and dV over 64-query tiles, each into one f32
chain) and held against the
plain versions (ops/cuda_attention.py, f32 throughout, outputs rounded
once) at the measure chip_smoke.py holds the kernels to: each output's
worst 64-row tile, as a share of that tile's norm. Every reading must
lie under the card's limit of 5e-3 and above 1e-3 (the rounding of P and
dS is real: rounding only the outputs reads ~2e-4), and both planted
faults of chip_smoke.py must read above the limit.

The forward: csrc/flash_fwd.cu's bf16 kernel computes S = Q K^T in f32
from bf16 q, k; walks the keys in tiles of 128 with the online softmax
(p = exp(s - m) in f32, summed unrounded into l); rounds P to bf16
before O += P V, which sums in f32; and rounds O = acc / l to bf16 once.
Emulated the same way, O's worst 64-row tile must lie under the card's
limit of 5e-3 and above 1e-3 (rounding only O reads ~2e-4, since the
plain version rounds O too), and both planted faults must read above
the limit.

The f32 kernels (csrc/flash_tf32.cuh) run every product in split TF32:
each f32 operand x is split as hi = tf32(x) (round to nearest, ties
away from zero, as cvt.rna.tf32.f32; emulated here by bit masking) and
lo = x - hi, which the tensor core reads truncated to TF32, and a b ~
a_hi b_lo + a_lo b_hi + a_hi b_hi. Each mma.sync m16n8k8 is emulated as
the tensor core computes it: the 8 products of a k-step exact (TF32
products are exact in f32, and so is their sum in f64 here), added to
the accumulator and the result truncated to f32 toward zero, since the
tensor core does not round its sums as IEEE f32 does (the alignment
shifts inside the mma are not modelled). The sums are chunked as the
kernels chunk them (flash_tf32.cuh's kSumSteps): a tensor-core sum runs
over at most 8 k-steps (64 columns of D) for S and dP, and over one
streamed tile for the second products (the forward's key tiles, the dQ
kernel's key tiles, the dK/dV kernel's query tiles, each as wide as the
kernel streams them at that head_dim), each chunk starting from zero
and then added into the f32 sum by an IEEE add; everything else stays
f32 as in the kernels (the forward's key-tile walk with its online
softmax, exp in natural units; the backward's P, dS, delta). That
emulation, forward and backward, must keep the f32 limits (O, LSE and
delta 2e-5 and dQ, dK, dV 5e-4 of the largest element, every output's
worst 64-row tile 1e-4) against the plain versions and against the JAX
package's Pallas kernel in interpret mode, with the planted faults
above them; one TF32 pass (lo left out, the card's precision control)
must read over the O limit; and against f64, dK and dV summed in one
tensor-core accumulator over all of S must read measurably worse than
the kernels' chunked sums.

The f32 backward at head_dim 64 and 128 runs on wgmma
(flash_dq_tf32_wgmma_kernel, flash_dkv_tf32_wgmma_kernel; the
F32_BWD_CASES marked "wgmma"): both kernels build S^T = K Q^T and dP^T =
V dO^T with K and V split in registers and Q and dO read as TMA wrote
them, their hi the f32 value truncated to TF32 (the tensor core's read)
and their lo x - hi truncated in turn; each is one tensor-core sum over
all of D (16 k-steps at D = 128, past kSumSteps). The second products
run transposed (dQ^T = K^T dS^T over 64-key tiles, dV^T = dO^T P and
dK^T = Q^T dS over 32-query tiles), each tile one tensor-core sum added
in f32, with dS^T, P, dS split as the threads write them. That emulation
must keep the same f32 limits, and one TF32 pass of it must read over a
dQ, dK or dV limit.

The f32 forward at head_dim 32-128 runs on wgmma too
(flash_fwd_tf32_wgmma_kernel; the F32_FWD_CASES marked "wgmma"): S = Q
K^T with Q split in registers and K read as TMA wrote it (hi
truncated), one tensor-core sum over all of D; key tiles of 64; P V one
tensor-core sum of the tile's 8 k-steps, P split from the accumulators
and V^T split as the producer warpgroup writes it (hi rounded), added in
f32 to O scaled by alpha. At head_dim 256 (and 129-255, padded) the
forward runs that design on a cluster of two CTAs
(flash_fwd_tf32_wgmma256_kernel; the F32_FWD_CASES marked "cluster"):
each rank's partial S over its 128 columns is one tensor-core sum of 16
k-steps, the two partials are added in rank order, from zero, in f32,
and each rank adds P V over its own columns. Those emulations must keep
the forward's f32 limits against the plain version and the Pallas
kernel, with the planted faults above them, and one TF32 pass of them
must read over the O limit.

Past head_dim 256 (csrc/flash_wide.cuh) the forward, dQ and dK/dV run
on a thread-block cluster: D is zero-padded to a multiple of 128
(ca.built_head_dim), each rank's 128-column slice gives a partial score
tile (bf16: one f32 tensor-core chain; f32: two split-TF32 sums of 8
k-steps added in f32), and a row's owner adds the ranks' partials in
rank order, from zero, in f32 before the softmax (key tiles of 64 in the
forward, 32 in dQ; dK/dV builds S^T and dP^T for its key tile, query
tiles of 32, and rounds P^T and dS^T to bf16 before dV = P^T dO and
dK = scale dS^T Q). WIDE_SHAPES emulate that at D = 320 (three ranks)
and 512 (four), S = 128: the bf16 forward's, dQ's, dK's and dV's worst
tiles between 1e-3 and 5e-3, the f32 forward, dQ, dK and dV within the
f32 limits against the plain versions and the Pallas kernel, the
one-pass control over the O limit, the planted faults over the limits.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparknet_tpu.ops.pallas_attention import _flash_backward, _flash_forward
from sparknet_tpu_torch.ops import cuda_attention as ca

BWD_TILE_LIMIT = 5e-3     # chip_smoke.FLASH_BWD_TILE_LIMIT["bfloat16"]
FWD_TILE_LIMIT = 5e-3     # chip_smoke.FLASH_TILE_LIMIT["bfloat16"]
SHAPES = [pytest.param((1, 2, 512, 128), id="S512-D128"),
          pytest.param((2, 3, 256, 64), id="S256-D64"),
          # the widest tiled head_dim: the wgmma backward's rounding points
          # are the mma.sync kernels' (P and dS to bf16 once)
          pytest.param((1, 1, 128, 256), id="S128-D256")]
# the backward's cases: (shape, tile), the second products summed over
# tiles of ``tile`` rows of S into one f32 chain as the wgmma kernels up
# to head_dim 128 sum them (None: one product over all of S); S = 200 is
# not a multiple of the kernels' 128-row CTAs
BWD_CASES = [pytest.param(*p.values, None, id=p.id) for p in SHAPES] + [
    pytest.param((1, 2, 512, 128), 64, id="S512-D128-tiles64"),
    pytest.param((2, 3, 256, 64), 64, id="S256-D64-tiles64"),
    pytest.param((1, 2, 200, 128), 64, id="S200-D128-tiles64")]
# past head_dim 256: D = 320 (padded to 384, three ranks) and 512 (four)
WIDE_SHAPES = [pytest.param((1, 2, 128, 320), id="S128-D320"),
               pytest.param((1, 1, 128, 512), id="S128-D512")]


def _worst_tile(got, ref, rows=64):
    b, h, s, d = ref.shape
    pad = (-s) % rows

    def tiles(t):
        return torch.nn.functional.pad(t.float(), (0, 0, 0, pad)).reshape(
            b * h, -1, rows * d)
    r = tiles(ref)
    return float(((tiles(got) - r).norm(dim=-1)
                  / r.norm(dim=-1).clamp_min(1e-30)).max())


def _planted(t):
    """chip_smoke._planted: the last 64-row tile of the last (b, h) 1%
    off, and every row past S/8 10% off."""
    s = t.shape[2]
    last, late = t.float().clone(), t.float().clone()
    last[-1, -1, -64:] *= 1.01
    late[:, :, s // 8:] *= 1.1
    return last, late


def _tile_sum(a, b, tile, axis):
    """a @ b (a: (..., m, s), b: (..., s, n)) as a kernel sums it over
    ``tile``-row tiles of the shared axis s, each tile's product added
    into one f32 accumulator chain in order from zero; ``tile`` None:
    one product. ``axis`` -1 takes a's columns, -2 a's rows (a^T)."""
    at = a if axis == -1 else a.transpose(-1, -2)
    if tile is None:
        return at @ b
    acc = torch.zeros(*at.shape[:-1], b.shape[-1])
    for j in range(0, b.shape[-2], tile):
        acc = acc + at[..., j:j + tile] @ b[..., j:j + tile, :]
    return acc


def _emulated_backward(q, k, v, o, lse, do, causal, tile=None):
    """dq, dk, dv with the bf16 kernels' rounding points; ``tile``: the
    second products summed as the wgmma kernels up to head_dim 128 walk
    them (_tile_sum: dQ over key tiles, dK and dV over query tiles)."""
    b, h, s, d = q.shape
    scale = ca.default_scale(q)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    sc = scale * (qf @ kf.transpose(-1, -2))               # f32 S
    p = torch.exp(sc - lse.reshape(b, h, s, 1))
    if causal:
        p = p.masked_fill(torch.ones(s, s, dtype=torch.bool).triu(1), 0.0)
    delta = (dof * o.float()).sum(-1, keepdim=True)
    ds = p * (dof @ vf.transpose(-1, -2) - delta)          # f32 dP
    pb = p.to(torch.bfloat16).float()
    dsb = ds.to(torch.bfloat16).float()
    dq = scale * _tile_sum(dsb, kf, tile, -1)
    dk = scale * _tile_sum(dsb, qf, tile, -2)
    dv = _tile_sum(pb, dof, tile, -2)
    return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))


def _walk(qf, kf, vf, scale, causal, row0, tiles, tile, scores):
    """One walk of the forward's online softmax over the key tiles
    ``tiles`` (of ``tile`` keys) for the f32 query rows ``qf`` that start
    at row ``row0``: (m, l, acc), p = exp(s - m) in f32 summed unrounded
    into l, P rounded to bf16 before acc += P V. A walk with no tile
    leaves m at NEG_INF, l and acc at 0."""
    b, h, n, d = qf.shape
    s = kf.shape[2]
    m = torch.full((b, h, n, 1), ca.NEG_INF)
    l = torch.zeros(b, h, n, 1)
    acc = torch.zeros(b, h, n, vf.shape[-1])
    rows = torch.arange(row0, row0 + n)[:, None]
    for j in tiles:
        k0 = j * tile
        sc = scale * scores(qf, kf[:, :, k0:k0 + tile])
        if causal:
            cols = torch.arange(k0, min(k0 + tile, s))[None, :]
            sc = sc.masked_fill(cols > rows, ca.NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new)                          # f32 p
        l = l * alpha + p.sum(-1, keepdim=True)            # unrounded
        pb = p.to(torch.bfloat16).float()                  # P rounded
        acc = acc * alpha + pb @ vf[:, :, k0:k0 + tile]
        m = m_new
    return m, l, acc


def _emulated_forward(q, k, v, causal, tile=128, scores=None, scale=None):
    """O with the bf16 forward kernel's rounding points, key tile by key
    tile as the kernel walks them; ``scores`` (Q, K tile -> f32 S, the
    plain product by default) and ``scale`` (1/sqrt(D) of q by default)
    let the wide kernel's padded inputs and cluster sums through."""
    s = q.shape[2]
    scale = ca.default_scale(q, scale)
    scores = scores or (lambda a, bt: a @ bt.transpose(-1, -2))
    qf, kf, vf = (t.float() for t in (q, k, v))
    _, l, acc = _walk(qf, kf, vf, scale, causal, 0,
                      range(math.ceil(s / tile)), tile, scores)
    return (acc / l.clamp_min(1e-30)).to(torch.bfloat16)


def _emulated_split_forward(q, k, v, causal, rows=64, tile=64):
    """O as the head_dim-256 forward's split variant computes it: a CTA of
    ``rows`` query rows, whose two warpgroups walk the even and the odd
    key tiles it sees, each with its own (m, l, acc), combined in f32 in
    the kernel's order (the even walk's first): m = max(m0, m1), a_w =
    exp(m_w - m), l = l0 a0 + l1 a1, O = (acc0 a0 + acc1 a1) / l."""
    s = q.shape[2]
    scale = ca.default_scale(q)
    qf, kf, vf = (t.float() for t in (q, k, v))
    key_tiles = math.ceil(s / tile)
    out = []
    for r0 in range(0, s, rows):
        n_k = min((r0 + rows) // tile, key_tiles) if causal else key_tiles
        (m0, l0, c0), (m1, l1, c1) = (
            _walk(qf[:, :, r0:r0 + rows], kf, vf, scale, causal, r0,
                  range(w, n_k, 2), tile, lambda a, bt: a @ bt.transpose(
                      -1, -2)) for w in (0, 1))
        m = torch.maximum(m0, m1)
        a0, a1 = torch.exp(m0 - m), torch.exp(m1 - m)
        l = l0 * a0 + l1 * a1
        out.append((c0 * a0 + c1 * a1) / l.clamp_min(1e-30))
    return torch.cat(out, dim=2).to(torch.bfloat16)


# -- past head_dim 256: the cluster kernels (csrc/flash_wide.cuh) --------

def _rank_sum(parts):
    """The cluster's sum of its ranks' partial tiles: f32 adds in rank
    order 0 .. G-1, from zero, as every rank takes them."""
    tot = torch.zeros_like(parts[0])
    for part in parts:
        tot = tot + part
    return tot


def _cluster_scores(dot):
    """Q, K tile -> the score tile as a cluster builds it: D in slices of
    ca.WIDE_CHUNK columns, one a rank (one cluster up to D = 1024), each
    rank's partial ``dot(Q slice, K slice^T)``, summed by _rank_sum."""
    def scores(a, bt):
        w = ca.WIDE_CHUNK
        return _rank_sum([dot(a[..., c:c + w], bt[..., c:c + w]
                              .transpose(-1, -2))
                          for c in range(0, a.shape[-1], w)])
    return scores


def _padded(d, *tensors):
    return ca.pad_head_dim(tensors, ca.built_head_dim(d))


def _emulated_wide_forward(q, k, v, causal):
    """O as the bf16 cluster forward computes it: the padded slices'
    f32 partial scores summed in rank order, then scaled; key tiles of
    64 (WideFwdTiles); P rounded before P V."""
    d = q.shape[-1]
    o = _emulated_forward(*_padded(d, q, k, v), causal, tile=64,
                          scores=_cluster_scores(torch.matmul),
                          scale=ca.default_scale(q))
    return o[..., :d]


def _emulated_wide_dq(q, k, v, o, lse, do, causal):
    """dQ as the bf16 cluster dQ kernel computes it: S and dP from the
    padded slices' f32 partials summed in rank order, P and dS in f32,
    dS rounded to bf16 before dQ = scale dS K, dQ rounded once."""
    b, h, s, d = q.shape
    scale = ca.default_scale(q)
    qf, kf, vf, of, dof = (t.float() for t in _padded(d, q, k, v, o, do))
    build = _cluster_scores(torch.matmul)
    p = torch.exp(scale * build(qf, kf) - lse.reshape(b, h, s, 1))
    if causal:
        p = p.masked_fill(torch.ones(s, s, dtype=torch.bool).triu(1), 0.0)
    delta = (dof * of).sum(-1, keepdim=True)
    ds = (p * (build(dof, vf) - delta)).to(torch.bfloat16).float()
    return (scale * (ds @ kf))[..., :d].to(torch.bfloat16)


def _emulated_wide_dkv(q, k, v, o, lse, do, causal):
    """dK, dV as the bf16 cluster dK/dV kernel computes them: S^T = K Q^T
    and dP^T = V dO^T from the padded slices' f32 partials summed in rank
    order, P^T = exp(scale S^T - LSE) per query column and dS^T = P^T
    (dP^T - delta) in f32 (delta the dQ kernel's, rowsum(dO O) in f32),
    P^T and dS^T rounded to bf16 before dV = P^T dO and dK = scale dS^T Q,
    each output rounded once."""
    b, h, s, d = q.shape
    scale = ca.default_scale(q)
    qf, kf, vf, of, dof = (t.float() for t in _padded(d, q, k, v, o, do))
    build = _cluster_scores(torch.matmul)
    pt = torch.exp(scale * build(kf, qf) - lse.reshape(b, h, 1, s))
    if causal:
        pt = pt.masked_fill(torch.ones(s, s, dtype=torch.bool).tril(-1), 0.0)
    delta = (dof * of).sum(-1)[..., None, :]
    dst = (pt * (build(vf, dof) - delta)).to(torch.bfloat16).float()
    pt = pt.to(torch.bfloat16).float()
    return ((scale * (dst @ qf))[..., :d].to(torch.bfloat16),
            (pt @ dof)[..., :d].to(torch.bfloat16))


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("shape", SHAPES + WIDE_SHAPES)
def test_tensor_core_forward_rounding_fits_the_bf16_tile_limit(shape, causal):
    rs = np.random.RandomState(43)
    q, k, v = (torch.from_numpy(0.5 * rs.randn(*shape).astype(
        np.float32)).to(torch.bfloat16) for _ in range(3))
    ro, _ = ca.flash_attention_fwd_plain(q, k, v, causal)
    if shape[-1] > ca.HEAD_DIMS[-1]:
        got = _emulated_wide_forward(q, k, v, causal)
    else:
        # the head_dim-256 kernel walks keys in tiles of 64, the others 128
        got = _emulated_forward(q, k, v, causal, tile=64 if ca.built_head_dim(
            shape[-1]) == 256 else 128)
    reading = _worst_tile(got, ro)
    assert 1e-3 < reading < FWD_TILE_LIMIT, reading
    for bad in _planted(got):
        assert _worst_tile(bad, ro) > FWD_TILE_LIMIT


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_split_forward_rounding_fits_the_bf16_tile_limit(causal):
    # the head_dim-256 forward on a grid smaller than the card: 64-row
    # CTAs whose warpgroups walk alternate key tiles and combine in f32
    rs = np.random.RandomState(44)
    q, k, v = (torch.from_numpy(0.5 * rs.randn(1, 2, 256, 256).astype(
        np.float32)).to(torch.bfloat16) for _ in range(3))
    ro, _ = ca.flash_attention_fwd_plain(q, k, v, causal)
    got = _emulated_split_forward(q, k, v, causal)
    reading = _worst_tile(got, ro)
    assert 1e-3 < reading < FWD_TILE_LIMIT, reading
    for bad in _planted(got):
        assert _worst_tile(bad, ro) > FWD_TILE_LIMIT


@pytest.mark.parametrize("output", ["dq", "dk", "dv"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("shape, tile", BWD_CASES)
def test_tensor_core_rounding_fits_the_bf16_tile_limit(shape, tile, causal,
                                                       output):
    rs = np.random.RandomState(41)
    q, k, v, do = (torch.from_numpy(0.5 * rs.randn(*shape).astype(
        np.float32)).to(torch.bfloat16) for _ in range(4))
    o, lse = ca.flash_attention_fwd_plain(q, k, v, causal)
    got = dict(zip(("dq", "dk", "dv"),
                   _emulated_backward(q, k, v, o, lse, do, causal, tile)))
    rdq, rdelta = ca.flash_attention_dq_plain(q, k, v, o, lse, do, causal)
    rdk, rdv = ca.flash_attention_dkv_plain(q, k, v, do, lse, rdelta, causal)
    ref = {"dq": rdq, "dk": rdk, "dv": rdv}[output]
    reading = _worst_tile(got[output], ref)
    assert 1e-3 < reading < BWD_TILE_LIMIT, reading
    for bad in _planted(got[output]):
        assert _worst_tile(bad, ref) > BWD_TILE_LIMIT


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("shape", WIDE_SHAPES)
def test_wide_dq_rounding_fits_the_bf16_tile_limit(shape, causal):
    # the cluster dQ kernel rounds dS to bf16 (its dK/dV partner P^T and
    # dS^T: the next test)
    rs = np.random.RandomState(41)
    q, k, v, do = (torch.from_numpy(0.5 * rs.randn(*shape).astype(
        np.float32)).to(torch.bfloat16) for _ in range(4))
    o, lse = ca.flash_attention_fwd_plain(q, k, v, causal)
    got = _emulated_wide_dq(q, k, v, o, lse, do, causal)
    ref, _ = ca.flash_attention_dq_plain(q, k, v, o, lse, do, causal)
    reading = _worst_tile(got, ref)
    assert 1e-3 < reading < BWD_TILE_LIMIT, reading
    for bad in _planted(got):
        assert _worst_tile(bad, ref) > BWD_TILE_LIMIT


@pytest.mark.parametrize("output", ["dk", "dv"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("shape", WIDE_SHAPES)
def test_wide_dkv_rounding_fits_the_bf16_tile_limit(shape, causal, output):
    rs = np.random.RandomState(41)
    q, k, v, do = (torch.from_numpy(0.5 * rs.randn(*shape).astype(
        np.float32)).to(torch.bfloat16) for _ in range(4))
    o, lse = ca.flash_attention_fwd_plain(q, k, v, causal)
    got = dict(zip(("dk", "dv"),
                   _emulated_wide_dkv(q, k, v, o, lse, do, causal)))[output]
    _, rdelta = ca.flash_attention_dq_plain(q, k, v, o, lse, do, causal)
    ref = dict(zip(("dk", "dv"), ca.flash_attention_dkv_plain(
        q, k, v, do, lse, rdelta, causal)))[output]
    reading = _worst_tile(got, ref)
    assert 1e-3 < reading < BWD_TILE_LIMIT, reading
    for bad in _planted(got):
        assert _worst_tile(bad, ref) > BWD_TILE_LIMIT


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("d", [8, 48, 96, 192])
def test_zero_padded_head_dim_is_exact(d, causal):
    # a head_dim the kernels were not built for runs through the next
    # built one, its inputs zero-padded (ops/cuda_attention.py): the plain
    # versions on the padded inputs, sliced back, equal them on the
    # unpadded ones up to the summation order of the longer products
    rs = np.random.RandomState(40 + d)
    q, k, v, do = (torch.from_numpy(0.5 * rs.randn(2, 2, 96, d).astype(
        np.float32)) for _ in range(4))
    dp = ca.built_head_dim(d)
    assert dp in ca.HEAD_DIMS and dp > d
    scale = ca.default_scale(q)                 # 1/sqrt(d), the true D
    o, lse = ca.flash_attention_fwd_plain(q, k, v, causal, scale)
    dq, dk, dv = ca.flash_attention_bwd_plain(q, k, v, o, lse, do, causal,
                                              scale)
    qp, kp, vp, op, dop = ca.pad_head_dim((q, k, v, o, do), dp)
    po, plse = ca.flash_attention_fwd_plain(qp, kp, vp, causal, scale)
    pdq, pdk, pdv = ca.flash_attention_bwd_plain(qp, kp, vp, op, plse, dop,
                                                 causal, scale)
    for full, ref in ((po, o), (pdq, dq), (pdk, dk), (pdv, dv)):
        assert full.shape[-1] == dp
        assert torch.equal(full[..., d:], torch.zeros_like(full[..., d:]))
        torch.testing.assert_close(full[..., :d], ref, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(plse, lse, rtol=1e-6, atol=1e-7)


def test_built_head_dim(monkeypatch):
    assert [ca.built_head_dim(d)
            for d in (1, 16, 17, 33, 64, 65, 128, 129, 192, 256)] == \
        [16, 16, 32, 64, 64, 128, 128, 256, 256, 256]
    # past 256 (the wide kernels): the next multiple of 128 whose slices
    # split into equal clusters of at most 8
    assert [ca.built_head_dim(d) for d in (257, 300, 320, 321, 512, 1000)] \
        == [384, 384, 384, 384, 512, 1024]
    assert [ca.built_head_dim(d) for d in (1025, 1100, 1280, 2048, 2049)] \
        == [1280, 1280, 1280, 2048, 2304]
    # each wrapper, dK/dV's too, launches on inputs padded to that width:
    # on the meta device the checks and the launch are stood in for, and
    # the padding and slicing run as they do on a card
    seen = []
    monkeypatch.setattr(ca, "check_cuda_inputs", lambda *a, **kw: None)
    monkeypatch.setattr(ca, "_launch", lambda what, *a: seen.append(
        (what, a[3].shape[-1])))
    names = ("flash_attention", "flash_attention_dq", "flash_attention_dkv")
    for name in names:
        monkeypatch.setattr(getattr(ca, name), "launches", 0)
    for d in (96, 256, 300, 320, 1100):
        x = torch.empty(1, 1, 8, d, device="meta")
        rows = torch.empty(1, 8, device="meta")
        outs = (*ca.flash_attention_fwd(x, x, x),
                *ca.flash_attention_dq(x, x, x, x, rows, x),
                *ca.flash_attention_dkv(x, x, x, x, rows, rows))
        assert seen[-3:] == [(n, ca.built_head_dim(d)) for n in names]
        assert [t.shape[-1] for t in outs] == [d, 8, d, 8, d, d]


# -- the f32 kernels: split TF32 ------------------------------------------

F32_LIMIT = {"O": 2e-5, "LSE": 2e-5, "delta": 2e-5, "dq": 5e-4, "dk": 5e-4,
             "dv": 5e-4}               # of the largest reference element
F32_TILE_LIMIT = 1e-4                  # chip_smoke.FLASH_TILE_LIMIT["float32"]
F32_SHAPES = [pytest.param((1, 2, 256, 64), id="S256-D64"),
              pytest.param((1, 2, 256, 128), id="S256-D128")]
# head_dim 256, where the f32 backward runs on wgmma in clusters of two
# CTAs (flash_dq_tf32_wgmma256_kernel, flash_dkv_tf32_wgmma256_kernel):
# S 256, and a ragged S of 200
F32_CLUSTER_SHAPES = [pytest.param((1, 2, 256, 256), id="S256-D256"),
                      pytest.param((1, 1, 200, 256), id="S200-D256")]
# the backward's cases: (shape, design) of F32_SHAPES for the mma.sync
# kernels (csrc/flash_bwd.cu's flash_dq_tf32_kernel, flash_dkv_tf32_kernel,
# which run head_dim 16 and 32) and for the wgmma kernels of head_dim 64
# and 128 (flash_dq_tf32_wgmma_kernel, flash_dkv_tf32_wgmma_kernel) and
# of head_dim 256 in clusters of two (F32_CLUSTER_SHAPES)
F32_BWD_CASES = [
    pytest.param(((1, 2, 256, 64), "mma.sync"), id="S256-D64"),
    pytest.param(((1, 2, 256, 128), "mma.sync"), id="S256-D128"),
    pytest.param(((1, 2, 256, 64), "wgmma"), id="S256-D64-wgmma"),
    pytest.param(((1, 2, 256, 128), "wgmma"), id="S256-D128-wgmma"),
    *(pytest.param((p.values[0], "wgmma"), id=f"{p.id}-wgmma")
      for p in F32_CLUSTER_SHAPES)]
# the forward's cases: (shape, design) of F32_SHAPES and WIDE_SHAPES for
# the mma.sync kernel (csrc/flash_fwd.cu's flash_fwd_tf32_kernel, which
# runs head_dim 16) and the cluster kernel past 256, for the wgmma kernel
# at head_dim 32-128 (flash_fwd_tf32_wgmma_kernel; 32 is the lm verb's
# default), and of F32_CLUSTER_SHAPES for the head_dim-256 kernel on
# clusters of two (flash_fwd_tf32_wgmma256_kernel)
F32_FWD_CASES = [pytest.param((p.values[0], "mma.sync"), id=p.id)
                 for p in F32_SHAPES + WIDE_SHAPES] + [
    pytest.param(((1, 2, 256, d), "wgmma"), id=f"S256-D{d}-wgmma")
    for d in (32, 64, 128)] + [
    pytest.param((p.values[0], "cluster"), id=f"{p.id}-cluster")
    for p in F32_CLUSTER_SHAPES]


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as cvt.rna.tf32.f32 does: half of the dropped 13 bits'
    unit added to the bit pattern, then the 13 bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_truncated(x):
    """x as the tensor core reads an f32 bit pattern for a TF32 operand:
    its low 13 bits dropped (toward zero)."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _split(x):
    """hi, lo as the kernels hand them to the mma, and as it reads them:
    hi = tf32(x), lo = x - hi truncated to TF32."""
    hi = _tf32(x)
    return hi, _tf32_truncated(x - hi)


def _rz(x):
    """f64 values rounded to f32 toward zero (kept in f64): the 29
    mantissa bits that f32 lacks cleared (f32's normal range)."""
    return (x.view(torch.int64) & -(1 << 29)).view(torch.float64)


K_SUM_STEPS = 8            # csrc/flash_tf32.cuh's kSumSteps


def _raw_split(x):
    """hi, lo of an f32 tile that TMA wrote and wgmma reads as it is: hi
    its truncated TF32 (the tensor core's read), lo = x - hi (exact)
    truncated to TF32 in turn."""
    hi = _tf32_truncated(x)
    return hi, _tf32_truncated(x - hi)


def _tc_sum(a, b, passes=3, chain=K_SUM_STEPS, acc=None, b_raw=False):
    """a @ b (a (..., M, K), b (..., K, N), f32) as the kernels' split
    TF32 mma computes it: per k-step of 8, the tensor core's products
    a_hi b_lo, a_lo b_hi, then a_hi b_hi, each mma truncating its f32
    result (passes=1: a_hi b_hi alone, one TF32 pass), summed on the
    tensor core over ``chain`` k-steps from zero (None: all of K in one
    accumulator) and those sums added into ``acc`` in f32, in order.
    ``b_raw``: b split as a tile read as TMA wrote it (_raw_split)."""
    (ah, al), (bh, bl) = _split(a), (_raw_split(b) if b_raw else _split(b))
    pairs = [(ah, bl), (al, bh), (ah, bh)] if passes == 3 else [(ah, bh)]
    kk = a.shape[-1] // 8
    terms = [torch.einsum("...mks,...ksn->k...mn",
                          x.double().unflatten(-1, (kk, 8)),
                          y.double().unflatten(-2, (kk, 8)))
             for x, y in pairs]
    chain = chain or kk
    for c0 in range(0, kk, chain):
        part = torch.zeros_like(terms[0][0])
        for k in range(c0, min(c0 + chain, kk)):
            for t in terms:
                part = _rz(part + t[k])
        acc = part.float() if acc is None else acc + part.float()
    return acc


def _streamed(d, design="mma.sync"):
    """Rows of the streamed tiles at head_dim d: the forward's key tiles,
    the dQ kernel's key tiles, the dK/dV kernel's query tiles: of the
    mma.sync kernels (Tf32FwdTiles, DqTiles, DkvTiles), or of the wgmma
    kernels (Tf32WgFwdTiles and, on clusters, Tf32ClusterFwdTiles: 64
    keys; Tf32WgTiles: 64 keys, 32 queries)."""
    if design in ("wgmma", "cluster"):
        return {"fwd": 64, "dq": 64, "dkv": 32}
    return {"fwd": 32 if d >= 64 else 64,
            "dq": 32 if d == 128 else (16 if d > 64 else 64),
            "dkv": 16 if d > 64 else 64}


def _rel(got, ref):
    return float((got.float() - ref.float()).abs().max()
                 / ref.float().abs().max())


def _f32_inputs(shape, seed=51):
    rs = np.random.RandomState(seed)
    return [(0.5 * rs.randn(*shape)).astype(np.float32) for _ in range(4)]


def _split_tf32_forward(q, k, v, causal, passes=3, design="mma.sync"):
    """O and LSE as csrc/flash_fwd.cu's f32 kernels compute them.

    ``design`` "mma.sync" (flash_fwd_tf32_kernel): S in f32 from
    split-TF32 sums of at most kSumSteps k-steps added in f32, scaled
    after them, key tiles of 64 (32 from D = 64) with the online softmax,
    O scaled by alpha and then P V's k-steps added from the unrounded P.

    ``design`` "wgmma" (flash_fwd_tf32_wgmma_kernel): S = Q K^T with Q
    split in registers and K read as TMA wrote it (its hi truncated,
    _raw_split), one tensor-core sum over all of D, scaled after it; key
    tiles of 64 with the online softmax; P V one tensor-core sum a tile
    (8 k-steps) from P split in registers and V^T split as the producer
    writes it (hi rounded, as _split), added to O scaled by alpha.

    ``design`` "cluster" (flash_fwd_tf32_wgmma256_kernel, head_dim 256 on
    clusters of two): as "wgmma", but S from the two ranks' partials
    over their 128 columns, each one tensor-core sum of 16 k-steps with
    K's hi truncated (_raw_split), summed in rank order from zero in f32
    (_rank_sum) and then scaled.

    Past head_dim 256, as the cluster kernel of csrc/flash_wide.cuh: Q
    scaled (in f32) before the products, on the padded inputs, each
    rank's slice two sums of 8 k-steps added in f32 and the ranks'
    partials summed in rank order, key tiles of 64 (P V one tensor-core
    sum of 8 k-steps a tile)."""
    b, h, s, d = q.shape
    scale = ca.default_scale(q)
    wide = d > ca.HEAD_DIMS[-1]
    if wide:
        q, k, v = _padded(d, q, k, v)
        q = q * scale
        scores = _cluster_scores(lambda a, b_: _tc_sum(a, b_, passes))
    tile = 64 if wide else _streamed(d, design)["fwd"]
    m = torch.full((b, h, s, 1), ca.NEG_INF)
    l = torch.zeros(b, h, s, 1)
    acc = torch.zeros(q.shape)
    rows = torch.arange(s)[:, None]
    for k0 in range(0, s, tile):
        kt = k[:, :, k0:k0 + tile]
        x = scores(q, kt) if wide else \
            _tc_sum(q, kt.transpose(-1, -2), passes, chain=d // 8,
                    b_raw=True) * scale if design == "wgmma" else \
            _cluster_scores(lambda a, b_: _tc_sum(
                a, b_, passes, chain=ca.WIDE_CHUNK // 8, b_raw=True))(
                    q, kt) * scale if design == "cluster" else \
            _tc_sum(q, kt.transpose(-1, -2), passes) * scale
        if causal:
            cols = torch.arange(k0, min(k0 + tile, s))[None, :]
            x = x.masked_fill(cols > rows, ca.NEG_INF)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(x - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = _tc_sum(p, v[:, :, k0:k0 + tile], passes, acc=acc * alpha)
        m = m_new
    lc = l.clamp_min(1e-30)
    return (acc / lc)[..., :d], (m + torch.log(lc)).reshape(b * h, s)


@functools.lru_cache(maxsize=None)
def _split_tf32_wide_dq(shape, causal):
    """dQ and delta as the f32 cluster dQ kernel computes them on
    _f32_inputs(shape) (D past 256) with the plain forward's O and LSE:
    S and dP from the padded slices' split-TF32 partials (two sums of 8
    k-steps a slice) summed in rank order, P = exp(scale S - LSE) masked
    to 0, dS = P (dP - delta), dQ = scale dS K one tensor-core sum a key
    tile of 32 added in f32; with the plain versions' as "ref"."""
    q, k, v, do = (torch.from_numpy(a) for a in _f32_inputs(shape))
    o, lse = ca.flash_attention_fwd_plain(q, k, v, causal)
    b, h, s, d = shape
    scale = ca.default_scale(q)
    qp, kp, vp, op, dop = _padded(d, q, k, v, o, do)
    build = _cluster_scores(_tc_sum)
    x = (build(qp, kp).double() * scale
         - lse.reshape(b, h, s, 1).double()).float()
    p = torch.exp(x)
    if causal:
        p = p.masked_fill(torch.ones(s, s, dtype=torch.bool).triu(1), 0.0)
    delta = (dop * op).sum(-1, keepdim=True)
    ds = p * (build(dop, vp) - delta)
    acc = None
    for r0 in range(0, s, 32):
        acc = _tc_sum(ds[..., r0:r0 + 32], kp[..., r0:r0 + 32, :], acc=acc)
    rdq, rdelta = ca.flash_attention_dq_plain(q, k, v, o, lse, do, causal)
    return {"dq": (scale * acc)[..., :d], "delta": delta.reshape(b * h, s),
            "ref": {"dq": rdq, "delta": rdelta}}


@functools.lru_cache(maxsize=None)
def _split_tf32_wide_dkv(shape, causal):
    """dK and dV as the f32 cluster dK/dV kernel computes them on
    _f32_inputs(shape) (D past 256) with the plain forward's O and LSE:
    S^T = K Q^T and dP^T = V dO^T from the padded slices' split-TF32
    partials (two sums of 8 k-steps a slice) summed in rank order, P^T =
    exp(scale S^T - LSE) per query column masked to 0, dS^T = P^T (dP^T -
    delta), dV = P^T dO and dK = scale dS^T Q one tensor-core sum a query
    tile of 32 added in f32; with the plain versions' as "ref"."""
    q, k, v, do = (torch.from_numpy(a) for a in _f32_inputs(shape))
    o, lse = ca.flash_attention_fwd_plain(q, k, v, causal)
    b, h, s, d = shape
    scale = ca.default_scale(q)
    qp, kp, vp, op, dop = _padded(d, q, k, v, o, do)
    build = _cluster_scores(_tc_sum)
    x = (build(kp, qp).double() * scale
         - lse.reshape(b, h, 1, s).double()).float()
    pt = torch.exp(x)
    if causal:
        pt = pt.masked_fill(torch.ones(s, s, dtype=torch.bool).tril(-1), 0.0)
    delta = (dop * op).sum(-1)[..., None, :]
    dst = pt * (build(vp, dop) - delta)
    acc_k = acc_v = None
    for r0 in range(0, s, 32):
        acc_k = _tc_sum(dst[..., r0:r0 + 32], qp[..., r0:r0 + 32, :],
                        acc=acc_k)
        acc_v = _tc_sum(pt[..., r0:r0 + 32], dop[..., r0:r0 + 32, :],
                        acc=acc_v)
    _, rdelta = ca.flash_attention_dq_plain(q, k, v, o, lse, do, causal)
    rdk, rdv = ca.flash_attention_dkv_plain(q, k, v, do, lse, rdelta, causal)
    return {"dk": (scale * acc_k)[..., :d], "dv": acc_v[..., :d],
            "ref": {"dk": rdk, "dv": rdv}}


@functools.lru_cache(maxsize=None)
def _split_tf32_backward(shape, causal, one_accumulator=False,
                         design="mma.sync", passes=3):
    """dQ, delta, dK, dV as csrc/flash_bwd.cu's f32 kernels compute them
    on _f32_inputs(shape) with the plain forward's O and LSE, with the
    plain versions' outputs as "ref".

    ``design`` "mma.sync" (flash_dq_tf32_kernel, flash_dkv_tf32_kernel):
    S and dP from split-TF32 sums over D (the dK/dV kernel's S^T and
    dP^T with K and V as the first operand), sums of at most kSumSteps
    k-steps added in f32, P = exp(scale S - LSE) masked to 0, delta =
    rowsum(dO O) in f32, dS = P (dP - delta), and the second products
    from the unrounded P and dS, one tensor-core sum a streamed tile
    (``one_accumulator``: over all of S at once).

    ``design`` "wgmma" (flash_dq_tf32_wgmma_kernel,
    flash_dkv_tf32_wgmma_kernel): both kernels build S^T = K Q^T and
    dP^T = V dO^T, K and V split in registers and Q and dO read as TMA
    wrote them (their hi truncated, _raw_split), each one tensor-core
    sum over all of D (at head_dim 256, flash_dq_tf32_wgmma256_kernel
    and flash_dkv_tf32_wgmma256_kernel: one sum of 16 k-steps over each
    cluster rank's 128 columns, the two partials added in rank order in
    f32); and the second products transposed, dQ^T = K^T
    dS^T a 64-key tile, dV^T = dO^T P and dK^T = Q^T dS a 32-query tile
    at a time, each tile one tensor-core sum added in f32, K^T, dO^T and
    Q^T split in registers and dS^T, P, dS as the threads write them.

    ``passes`` 1: every product one TF32 pass (the one-pass control)."""
    q, k, v, do = (torch.from_numpy(a) for a in _f32_inputs(shape))
    o, lse = ca.flash_attention_fwd_plain(q, k, v, causal)
    b, h, s, d = shape
    scale = ca.default_scale(q)
    lse = lse.reshape(b, h, s, 1)
    future = torch.ones(s, s, dtype=torch.bool).triu(1)
    delta = (do * o).sum(-1, keepdim=True)

    def p_ds(s_, dp, lse_, delta_, mask):
        p = torch.exp((s_.double() * scale - lse_.double()).float())
        if causal:
            p = p.masked_fill(mask, 0.0)
        return p, p * (dp - delta_)

    def tiled(a, b_, rows):
        """a @ b_, the sum over S one streamed tile of ``rows`` at a
        time (all of S in one accumulator with one_accumulator)."""
        if one_accumulator:
            return _tc_sum(a, b_, passes, chain=None)
        acc = None
        for r0 in range(0, s, rows):
            acc = _tc_sum(a[..., r0:r0 + rows], b_[..., r0:r0 + rows, :],
                          passes, acc=acc)
        return acc

    def t(x):
        return x.transpose(-1, -2)
    rows = _streamed(d, design)
    if design == "wgmma":
        def first(x, y):
            w = min(d, ca.WIDE_CHUNK)      # the columns of a rank
            parts = [_tc_sum(x[..., c:c + w], t(y[..., c:c + w]), passes,
                             chain=w // 8, b_raw=True)
                     for c in range(0, d, w)]
            return parts[0] if len(parts) == 1 else _rank_sum(parts)
        st, dpt = (first(x, y) for x, y in ((k, q), (v, do)))
        pt, dst = p_ds(st, dpt, t(lse), t(delta), future.t())
        out = {"dq": scale * t(tiled(t(k), dst, rows["dq"])),
               "dk": scale * t(tiled(t(q), t(dst), rows["dkv"])),
               "dv": t(tiled(t(do), t(pt), rows["dkv"]))}
    else:
        _, ds = p_ds(_tc_sum(q, t(k), passes), _tc_sum(do, t(v), passes),
                     lse, delta, future)
        pt, dst = p_ds(_tc_sum(k, t(q), passes), _tc_sum(v, t(do), passes),
                       t(lse), t(delta), future.t())
        out = {"dq": scale * tiled(ds, k, rows["dq"]),
               "dk": scale * tiled(dst, q, rows["dkv"]),
               "dv": tiled(pt, do, rows["dkv"])}
    out["delta"] = delta.reshape(b * h, s)
    rdq, rdelta = ca.flash_attention_dq_plain(q, k, v, o, lse.reshape(
        b * h, s), do, causal)
    rdk, rdv = ca.flash_attention_dkv_plain(q, k, v, do, lse.reshape(
        b * h, s), rdelta, causal)
    out["ref"] = {"dq": rdq, "delta": rdelta, "dk": rdk, "dv": rdv}
    return out


@functools.lru_cache(maxsize=None)
def _f64_gradients(shape, causal):
    """dQ, dK, dV of softmax attention on _f32_inputs(shape) in f64."""
    q, k, v, do = (torch.from_numpy(a).double().requires_grad_()
                   for a in _f32_inputs(shape))
    s = shape[2]
    x = q @ k.transpose(-1, -2) / math.sqrt(shape[-1])
    if causal:
        x = x.masked_fill(torch.ones(s, s, dtype=torch.bool).triu(1),
                          -math.inf)
    o = torch.softmax(x, -1) @ v
    return dict(zip(("dq", "dk", "dv"),
                    torch.autograd.grad(o, (q, k, v), do)))


@functools.lru_cache(maxsize=None)
def _pallas_reference(shape, causal):
    """O, LSE, dQ, dK, dV of the JAX package's flash attention on
    _f32_inputs(shape), dO the cotangent: the Pallas forward and backward
    that flash_attention's custom VJP runs, in interpret mode as it runs
    them off a TPU (tests/test_torch_attention.py)."""
    scale = 1.0 / math.sqrt(shape[-1])

    @jax.jit
    def both(q, k, v, do):
        o, lse = _flash_forward(q, k, v, causal, scale, 128, 128, True)
        return (o, lse) + tuple(_flash_backward(q, k, v, o, lse, do, causal,
                                                scale, 128, 128, True))
    o, lse, dq, dk, dv = both(*(jnp.asarray(a) for a in _f32_inputs(shape)))
    b, h, s, _ = shape
    return {"O": np.array(o), "LSE": np.array(lse)[..., 0].reshape(b * h, s),
            "dq": np.array(dq), "dk": np.array(dk), "dv": np.array(dv)}


def _check(label, got, ref, planted=True):
    """got within the f32 limits of ref: of the largest element, and for
    (B, H, S, D) outputs the worst 64-row tile; the planted faults not."""
    assert _rel(got, ref) <= F32_LIMIT[label], (label, _rel(got, ref))
    if got.dim() == 4:
        assert _worst_tile(got, ref) <= F32_TILE_LIMIT, label
        if planted:
            for bad in _planted(got):
                assert _worst_tile(bad, ref) > F32_TILE_LIMIT, label


def test_tf32_split_rebuilds_every_f32_input():
    rs = np.random.RandomState(50)
    x = torch.from_numpy(np.concatenate([
        rs.randn(4096), 1e-6 * rs.randn(1024), 1e6 * rs.randn(1024),
        np.float32(2.0) ** rs.randint(-100, 100, 1024) * rs.rand(1024),
    ]).astype(np.float32))
    hi, lo = _split(x)
    for part in (hi, lo):            # TF32: the low 13 bits clear
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    err = ((hi.double() + lo.double()) - x.double()).abs()
    assert bool((err <= 2.0 ** -21 * x.double().abs()).all())
    # one TF32 pass alone is ~2^-11 off: the split is what restores f32
    assert float(((hi.double() - x.double()).abs()
                  / x.double().abs().clamp_min(1e-300)).max()) > 2.0 ** -13


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("case", F32_FWD_CASES)
def test_split_tf32_forward_keeps_the_f32_limits(case, causal):
    shape, design = case
    q, k, v, _ = (torch.from_numpy(a) for a in _f32_inputs(shape))
    o, lse = _split_tf32_forward(q, k, v, causal, design=design)
    ro, rlse = ca.flash_attention_fwd_plain(q, k, v, causal)
    jax_ref = _pallas_reference(shape, causal)
    for ref_o, ref_lse in ((ro, rlse), (torch.from_numpy(jax_ref["O"]),
                                        torch.from_numpy(jax_ref["LSE"]))):
        _check("O", o, ref_o)
        _check("LSE", lse, ref_lse)


@pytest.mark.parametrize("output", ["dq", "dk", "dv"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("case", F32_BWD_CASES)
def test_split_tf32_backward_keeps_the_f32_limits(case, causal, output):
    shape, design = case
    got = _split_tf32_backward(shape, causal, design=design)
    _check("delta", got["delta"], got["ref"]["delta"])
    _check(output, got[output], got["ref"][output])
    _check(output, got[output], torch.from_numpy(
        _pallas_reference(shape, causal)[output]))


@pytest.mark.parametrize("output", ["dq", "dk", "dv"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("shape", F32_CLUSTER_SHAPES)
def test_split_tf32_cluster_backward_keeps_the_f32_limits_against_f64(
        shape, causal, output):
    # the head_dim-256 cluster kernels' emulation against softmax
    # attention's gradients in f64, at the f32 limits
    got = _split_tf32_backward(shape, causal, design="wgmma")
    _check(output, got[output],
           _f64_gradients(shape, causal)[output].float())


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("shape", WIDE_SHAPES)
def test_split_tf32_wide_dq_keeps_the_f32_limits(shape, causal):
    got = _split_tf32_wide_dq(shape, causal)
    _check("delta", got["delta"], got["ref"]["delta"])
    _check("dq", got["dq"], got["ref"]["dq"])
    _check("dq", got["dq"], torch.from_numpy(
        _pallas_reference(shape, causal)["dq"]))


@pytest.mark.parametrize("output", ["dk", "dv"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("shape", WIDE_SHAPES)
def test_split_tf32_wide_dkv_keeps_the_f32_limits(shape, causal, output):
    got = _split_tf32_wide_dkv(shape, causal)
    _check(output, got[output], got["ref"][output])
    _check(output, got[output], torch.from_numpy(
        _pallas_reference(shape, causal)[output]))


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_one_tensor_core_accumulator_over_s_reads_worse(causal):
    # the tensor core truncates each mma's sum, so a chain of them drifts:
    # dK and dV summed in one accumulator over all of S (~3-5e-6 of the
    # largest element) sit 2-4x further from f64 than the kernels' sums
    # of one streamed tile added in f32 (~1e-6)
    shape = (1, 2, 256, 64)
    ref = _f64_gradients(shape, causal)

    def worst(got):
        return max(_rel(got[o], ref[o]) for o in ("dk", "dv"))
    one, tiles = (worst(_split_tf32_backward(shape, causal, one_acc))
                  for one_acc in (True, False))
    assert one > 1.5 * tiles, (one, tiles)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("case", F32_FWD_CASES)
def test_one_tf32_pass_reads_over_the_f32_o_limit(case, causal):
    # the card's precision control (cuda_build.TF32_ONE_PASS): 10-bit
    # operands, which the f32 limit on O must reject
    shape, design = case
    q, k, v, _ = (torch.from_numpy(a) for a in _f32_inputs(shape))
    o, _ = _split_tf32_forward(q, k, v, causal, passes=1, design=design)
    ro, _ = ca.flash_attention_fwd_plain(q, k, v, causal)
    assert _rel(o, ro) > F32_LIMIT["O"], _rel(o, ro)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("shape", F32_SHAPES + F32_CLUSTER_SHAPES)
def test_one_tf32_pass_reads_over_the_f32_backward_limits(shape, causal):
    # the one-pass control of the wgmma backward: every product one TF32
    # pass (the raw tiles' truncated hi, the others' rounded one), which
    # a dQ, dK or dV limit must reject, as chip_smoke.py's control must
    got = _split_tf32_backward(shape, causal, design="wgmma", passes=1)
    for output in ("dq", "dk", "dv"):
        ref = got["ref"][output]
        assert _rel(got[output], ref) > F32_LIMIT[output] \
            or _worst_tile(got[output], ref) > F32_TILE_LIMIT, output
