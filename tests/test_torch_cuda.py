"""The port's CUDA kernels against their plain PyTorch versions, and a
training step, on the card. These tests import no JAX (the card's
machine has none) and skip without a card; on the card, from the repo
root:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(tests/conftest.py imports JAX, hence --noconftest). The case lists are
shared with test_torch_kernels.py, which holds the plain versions
against the JAX package's Pallas kernels on the CPU.

Tolerance: rtol=1e-5, atol=1e-6 (f32 on both sides); the biases'
gradients, sums over N*H*W elements, atol=1e-5. Flash attention, of the
largest reference element: f32 2e-5 forward and 5e-4 backward
(tests/test_flash.py's limits), bf16 1e-2 (about 2.5 bf16 ulps at the
top: the bf16 forward rounds P to bf16 before P V, the backward P and
dS before its second products, and both round their outputs once);
and, because causal outputs shrink along the sequence where that
measure does not, each output's worst 64-row tile within FLASH_TILE_TOL
(O) or FLASH_BWD_TILE_TOL (dQ, dK, dV) of its own norm (chip_smoke.py's
limits; the bf16 5e-3 is sized in tests/test_torch_flash_rounding.py).
"""

import numpy as np
import pytest
import torch

from sparknet_tpu_torch.ops import cuda_attention as ca
from sparknet_tpu_torch.ops import cuda_build
from sparknet_tpu_torch.ops import cuda_epilogue as ce
from sparknet_tpu_torch.ops import cuda_lrn as cl

# The channel-walk kernels' edge geometry (csrc/channel_walk.cuh): one
# channel, 32 channels to a CTA's chunk give or take one, H*W not a
# multiple of 4 (the scalar path), CaffeNet's 27x27 and 13x13 planes.
_EDGE = [
    pytest.param((2, 1, 7, 9), 5, 1e-1, 0.75, 1.0, id="C1-ragged"),
    pytest.param((2, 31, 5, 5), 5, 1e-2, 0.75, 1.0, id="C31-chunk-less-1"),
    pytest.param((2, 33, 4, 8), 3, 1e-2, 0.6, 2.0, id="C33-chunk-plus-1"),
    pytest.param((1, 8, 27, 27), 6, 1e-2, 0.75, 1.0, id="27x27-size6"),
    pytest.param((2, 40, 13, 13), 5, 1e-4, 0.75, 1.0, id="13x13"),
]
LRN_CASES = [
    # (shape, local_size, alpha, beta, k): tests/test_pallas_lrn.py's
    # cases plus an even window
    pytest.param((2, 96, 9, 11), 5, 1e-4, 0.75, 1.0, id="caffenet-norm1ish"),
    pytest.param((1, 64, 8, 8), 5, 5e-5, 0.75, 2.0, id="k-not-1"),
    pytest.param((2, 32, 6, 130), 3, 1e-3, 0.5, 1.0, id="size3-wide-spatial"),
    pytest.param((2, 13, 5, 7), 4, 1e-2, 0.6, 1.5, id="size4-even"),
] + _EDGE + [
    pytest.param((1, 3, 4, 5), cuda_build.MAX_WINDOW, 1e-2, 0.75, 2.0,
                 id="largest-window"),
]
BWD_CASES = LRN_CASES[:4] + _EDGE + [
    # C < n, ragged H*W = 323, odd and even windows
    pytest.param((3, 3, 17, 19), 4, 1e-2, 0.6, 2.0, id="size4-C3-ragged"),
    pytest.param((2, 2, 3, 5), 5, 1e-1, 0.75, 1.0, id="size5-C2"),
    pytest.param((1, 3, 4, 5), cuda_build.MAX_WINDOW_BWD, 1e-2, 0.75, 2.0,
                 id="largest-window"),
]
EPI_SHAPES = [
    # tests/test_pallas_epilogue.py's shapes, then the edge geometry
    pytest.param((2, 96, 9, 11), id="caffenet-conv-ish"),
    pytest.param((1, 64, 8, 8), id="pow2"),
    pytest.param((2, 32, 6, 130), id="wide-spatial-multi-block"),
    pytest.param((2, 1, 7, 9), id="C1-ragged"),
    pytest.param((2, 33, 5, 5), id="C33-ragged"),
    pytest.param((1, 8, 27, 27), id="27x27"),
]
DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                                 ids=["f32", "bf16"])


def _x(shape, seed, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)
            ).astype(np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")


def _card(a, dtype, offset=False):
    """``a`` on the card in ``dtype``; with ``offset``, a contiguous view
    one element into a larger buffer (not 16-byte aligned)."""
    t = torch.from_numpy(a).to("cuda", dtype)
    if not offset:
        return t
    buf = torch.empty(t.numel() + 1, device="cuda", dtype=dtype)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def _assert_matches(got, ref, floor=None):
    """The channel-walk kernels' limits against their plain versions
    (chip_smoke.py's): f32 rtol 1e-5, atol 1e-6; bf16 one bf16 ulp per
    element of |ref|, or of ``floor`` where that is larger (the
    backward's |g| k^-beta: its two terms cancel)."""
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if ref.dtype == torch.float32:
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)
        return
    r = ref.float().abs()
    if floor is not None:
        r = torch.maximum(r, floor)
    ulp = torch.where(r == 0, torch.zeros_like(r),
                      torch.exp2(torch.floor(torch.log2(r)) - 7))
    assert bool(((got.float() - ref.float()).abs() <= ulp).all())


@pytest.mark.cuda
@DTYPES
@pytest.mark.parametrize("shape,size,alpha,beta,k", LRN_CASES)
def test_lrn_kernel_matches_plain_on_card(cuda, shape, size, alpha, beta, k,
                                          dtype):
    x = _card(_x(shape, 5, scale=3.0), dtype)
    n0 = cl.lrn_across.launches
    got = cl.lrn_across(x, size, alpha, beta, k)
    assert cl.lrn_across.launches == n0 + 1
    _assert_matches(got, cl.lrn_across_plain(x, size, alpha, beta, k))


@pytest.mark.cuda
@DTYPES
@pytest.mark.parametrize("shape", EPI_SHAPES)
def test_epilogue_kernels_match_plain_on_card(cuda, shape, dtype):
    x = _card(_x(shape, 13, scale=3.0), dtype)
    b = torch.from_numpy(_x(shape[1:2], 14)).cuda()
    _assert_matches(ce.bias_relu(x, b), ce.bias_relu_plain(x, b))
    _assert_matches(ce.bias_relu_lrn(x, b, 5, 1e-4, 0.75, 1.0),
                    ce.bias_relu_lrn_plain(x, b, 5, 1e-4, 0.75, 1.0))


@pytest.mark.cuda
def test_card_wrappers_refuse_grad_and_bad_layouts(cuda):
    # a tensor that requires grad is taken and tracked; layouts the
    # kernels do not take are refused
    x = torch.randn(2, 8, 4, 4, device="cuda")
    assert cl.lrn_across(x.clone().requires_grad_(), 5, 1e-4, 0.75,
                         1.0).requires_grad
    with pytest.raises(ValueError, match="contiguous"):
        cl.lrn_across(x.transpose(2, 3), 5, 1e-4, 0.75, 1.0)
    with pytest.raises(TypeError):
        cl.lrn_across(x.half(), 5, 1e-4, 0.75, 1.0)
    with pytest.raises(ValueError, match="bias"):
        ce.bias_relu(x, torch.zeros(3, device="cuda"))
    with pytest.raises(ValueError, match="contiguous"):
        cl.lrn_across_bwd(x.transpose(2, 3), x, 5, 1e-4, 0.75, 1.0)
    with pytest.raises(ValueError, match="gradient"):
        cl.lrn_across_bwd(x, x[:1], 5, 1e-4, 0.75, 1.0)
    with pytest.raises(ValueError, match="local_size"):
        cl.lrn_across_bwd(x, x, cuda_build.MAX_WINDOW_BWD + 1, 1e-4, 0.75,
                          1.0)


@pytest.mark.cuda
@DTYPES
@pytest.mark.parametrize("shape,size,alpha,beta,k", BWD_CASES)
def test_backward_kernels_match_plain_on_card(cuda, shape, size, alpha, beta,
                                              k, dtype):
    x = _card(_x(shape, 21, scale=3.0), dtype)
    g = _card(_x(shape, 22), dtype)
    b = torch.from_numpy(_x(shape[1:2], 26)).cuda()
    n0 = (cl.lrn_across_bwd.launches, ce.bias_relu_lrn_bwd.launches)
    got = cl.lrn_across_bwd(x, g, size, alpha, beta, k)
    dx, db = ce.bias_relu_lrn_bwd(x, b, g, size, alpha, beta, k)
    assert (cl.lrn_across_bwd.launches, ce.bias_relu_lrn_bwd.launches) == \
        (n0[0] + 1, n0[1] + 1)
    floor = g.abs().float() * k ** -beta
    _assert_matches(got, cl.lrn_across_bwd_plain(x, g, size, alpha, beta, k),
                    floor)
    rdx, rdb = ce.bias_relu_lrn_bwd_plain(x, b, g, size, alpha, beta, k)
    _assert_matches(dx, rdx, floor)
    if dtype == torch.float32:
        torch.testing.assert_close(db, rdb, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@DTYPES
def test_channel_walk_kernels_take_views_at_an_odd_offset(cuda, dtype):
    # contiguous views one element into a buffer: no row is 16-byte
    # aligned though H*W = 56*56 would allow it, so the kernels take the
    # scalar path (4-byte copies; a bf16 row starts mid-word)
    shape = (2, 40, 56, 56)
    x = _card(_x(shape, 41, scale=3.0), dtype, offset=True)
    g = _card(_x(shape, 42), dtype, offset=True)
    b = torch.from_numpy(_x(shape[1:2], 43)).cuda()
    assert x.is_contiguous() and x.data_ptr() % 16
    p = (5, 1e-2, 0.75, 1.0)
    floor = g.abs().float()
    _assert_matches(cl.lrn_across(x, *p), cl.lrn_across_plain(x, *p))
    _assert_matches(ce.bias_relu(x, b), ce.bias_relu_plain(x, b))
    _assert_matches(ce.bias_relu_lrn(x, b, *p),
                    ce.bias_relu_lrn_plain(x, b, *p))
    _assert_matches(cl.lrn_across_bwd(x, g, *p),
                    cl.lrn_across_bwd_plain(x, g, *p), floor)
    _assert_matches(ce.bias_relu_lrn_bwd(x, b, g, *p)[0],
                    ce.bias_relu_lrn_bwd_plain(x, b, g, *p)[0], floor)


@pytest.mark.cuda
@DTYPES
@pytest.mark.parametrize("shape", [(4, 64, 56, 56), (2, 96, 27, 27)],
                         ids=["vector-path", "scalar-path"])
def test_channel_walk_kernels_are_deterministic_on_card(cuda, shape, dtype):
    # no atomics: every output is summed by one thread in a fixed order
    x = _card(_x(shape, 44, scale=3.0), dtype)
    g = _card(_x(shape, 45), dtype)
    b = torch.from_numpy(_x(shape[1:2], 46)).cuda()
    p = (5, 1e-4, 0.75, 1.0)
    for run in (lambda: cl.lrn_across(x, *p),
                lambda: ce.bias_relu(x, b),
                lambda: ce.bias_relu_lrn(x, b, *p),
                lambda: cl.lrn_across_bwd(x, g, *p),
                lambda: ce.bias_relu_lrn_bwd(x, b, g, *p)[0]):
        assert torch.equal(run(), run())


# (source, variant) of each channel-walk launch: csrc/<source>.cu
WALKS = [("lrn", 0), ("epilogue", 0), ("epilogue", 1), ("lrn_bwd", 0),
         ("lrn_bwd", 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_channel_walk_geometry_covers_every_shape(cuda, dtype):
    # the launchers' chunks tile [0, C) and their spans [0, H*W), each CTA
    # fits the card, nothing spills, at GoogLeNet's, CaffeNet's and the
    # edge shapes and at the largest windows taken
    bwd_max = cuda_build.MAX_WINDOW_BWD
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    for c, hw in ((1, 1), (1, 63), (31, 25), (33, 32), (64, 3136),
                  (192, 3136), (96, 729), (256, 169), (480, 196),
                  (3, 12544)):
        for aligned in (True, False):
            for source, variant in WALKS:
                sizes = (1, 2, 5, bwd_max) if source == "lrn_bwd" else \
                    (1, 5, cuda_build.MAX_WINDOW)
                for size in sizes:
                    w = cuda_build.walk_info(source, dtype, variant, c, hw,
                                             size, aligned)
                    assert 1 <= w["chunk"] <= 32
                    assert w["chunk"] * (w["chunks"] - 1) < c <= \
                        w["chunk"] * w["chunks"]
                    assert w["span"] * (w["spans"] - 1) < hw <= \
                        w["span"] * w["spans"]
                    assert w["vec"] == (aligned and hw % vec == 0)
                    if w["vec"]:
                        assert w["span"] % vec == 0
                    assert 0 < w["smem_bytes"] <= 227 * 1024
                    assert w["ctas_per_sm"] >= 1 and w["local_bytes"] == 0
                    assert w["chunks"] * w["spans"] < 2 ** 31


@pytest.mark.cuda
def test_channel_walk_kernels_take_the_largest_batch(cuda):
    # the largest batch check_cuda_input takes, 65535 images of one
    # channel and 2x2 columns: the persistent grid walks all its tiles
    x = _card(_x((cuda_build.MAX_GRID_Y, 1, 2, 2), 47), torch.float32)
    g = _card(_x(x.shape, 48), torch.float32)
    b = torch.zeros(1, device="cuda")
    p = (3, 1e-1, 0.75, 1.0)
    _assert_matches(cl.lrn_across(x, *p), cl.lrn_across_plain(x, *p))
    _assert_matches(ce.bias_relu_lrn(x, b, *p),
                    ce.bias_relu_lrn_plain(x, b, *p))
    _assert_matches(cl.lrn_across_bwd(x, g, *p),
                    cl.lrn_across_bwd_plain(x, g, *p))
    with pytest.raises(ValueError, match="batch"):
        cl.lrn_across(torch.zeros(cuda_build.MAX_GRID_Y + 1, 1, 1, 1,
                                  device="cuda"), *p)


FLASH_CASES = [
    # (B, H, S, D): one tile, several, ragged last tiles, every head_dim
    pytest.param((1, 2, 128, 64), id="S128-one-q-tile-pair"),
    pytest.param((2, 3, 256, 16), id="D16"),
    pytest.param((1, 2, 200, 128), id="D128-ragged-S200"),
    pytest.param((1, 2, 512, 128), id="D128-S512-eight-tiles"),
    pytest.param((2, 1, 77, 32), id="D32-ragged-S77"),
    pytest.param((1, 1, 1, 64), id="S1"),
    # the bf16 backward's last 128-row CTA holds 64 rows: its second
    # warpgroup's rows all lie past S
    pytest.param((2, 2, 320, 128), id="D128-S320-half-last-tile"),
] + [
    # S = 1000 at every head_dim: the bf16 forward's last 128-row query
    # and key tiles are 104 rows, the rest of the TMA box zero-filled
    pytest.param((1, 2, 1000, d), id=f"D{d}-ragged-S1000")
    for d in ca.HEAD_DIMS
]


def _worst(got, ref):
    return float((got.float() - ref.float()).abs().max()
                 / ref.float().abs().max().clamp_min(1e-30))


FLASH_TILE_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-3}        # O
FLASH_BWD_TILE_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-3}    # dQ..
# The bound on |dQ| and |dK| at S = 1, where both are 0 but for rounding:
# f32 read 1.1e-08 and 9.0e-09 (kernels and plain version alike) and bf16
# 0 on an NVIDIA H100 80GB HBM3; 1e-4 is three orders under a real
# gradient of these inputs
S1_NOISE_TOL = {torch.float32: 1e-7, torch.bfloat16: 1e-4}


def _worst_tile(got, ref, rows=64):
    """The worst tile's ||got - ref|| / ||ref|| over tiles of ``rows``
    rows along S in each (b, h), the ragged last one included."""
    b, h, s, d = ref.shape
    pad = (-s) % rows

    def tiles(t):
        return torch.nn.functional.pad(t.float(), (0, 0, 0, pad)).reshape(
            b * h, -1, rows * d)
    r = tiles(ref)
    return float(((tiles(got) - r).norm(dim=-1)
                  / r.norm(dim=-1).clamp_min(1e-30)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("shape", FLASH_CASES)
def test_flash_kernels_match_plain_on_card(cuda, shape, causal, dtype):
    rs = np.random.RandomState(31)
    q, k, v, do = (torch.from_numpy(0.5 * rs.randn(*shape).astype(
        np.float32)).to("cuda", dtype) for _ in range(4))
    n0 = (ca.flash_attention.launches, ca.flash_attention_dq.launches,
          ca.flash_attention_dkv.launches)
    o, lse = ca.flash_attention_fwd(q, k, v, causal)
    dq, delta = ca.flash_attention_dq(q, k, v, o, lse, do, causal)
    dk, dv = ca.flash_attention_dkv(q, k, v, do, lse, delta, causal)
    assert (ca.flash_attention.launches, ca.flash_attention_dq.launches,
            ca.flash_attention_dkv.launches) == tuple(n + 1 for n in n0)
    ro, rlse = ca.flash_attention_fwd_plain(q, k, v, causal)
    rdq, rdelta = ca.flash_attention_dq_plain(q, k, v, o, lse, do, causal)
    rdk, rdv = ca.flash_attention_dkv_plain(q, k, v, do, lse, rdelta, causal)
    f32 = dtype == torch.float32
    fwd_tol, bwd_tol = (2e-5, 5e-4) if f32 else (1e-2, 1e-2)
    assert o.dtype == dtype and dq.dtype == dk.dtype == dv.dtype == dtype
    assert _worst(o, ro) <= fwd_tol
    assert _worst(lse, rlse) <= 2e-5
    assert _worst(delta, rdelta) <= 2e-5
    # At S = 1, P = 1 and the exact dQ and dK are 0 (dS = dO.V - dO.O with
    # O = V); the kernels (dP on the tensor cores, in bf16 or split TF32,
    # delta summed in another order) and the plain version may each leave
    # rounding noise of dP's size there, so the largest-element measure of
    # one against the other divides noise by noise. Both must stay below
    # S1_NOISE_TOL instead, near each dtype's noise.
    noise_only = shape[2] == 1
    for got, ref in ((dq, rdq), (dk, rdk), (dv, rdv)):
        assert bool(torch.isfinite(got).all())
        if noise_only and got is not dv:
            assert float(got.abs().max()) <= S1_NOISE_TOL[dtype]
            assert float(ref.abs().max()) <= S1_NOISE_TOL[dtype]
        else:
            assert _worst(got, ref) <= bwd_tol
    if shape[2] > 1:       # at S = 1, P = 1 and dQ, dK are rounding noise
        assert _worst_tile(o, ro) <= FLASH_TILE_TOL[dtype]
        for got, ref in ((dq, rdq), (dk, rdk), (dv, rdv)):
            assert _worst_tile(got, ref) <= FLASH_BWD_TILE_TOL[dtype]


def _flash_inputs(shape, dtype, seed):
    rs = np.random.RandomState(seed)
    return [torch.from_numpy(0.5 * rs.randn(*shape).astype(np.float32)).to(
        "cuda", dtype) for _ in range(4)]


@pytest.mark.cuda
@pytest.mark.parametrize("s, d", [(512, 128), (512, 256), (1000, 128),
                                  (1000, 64), (512, 64), (512, 32),
                                  (1000, 32)],
                         ids=["128", "256", "128-S1000", "64-S1000", "64",
                              "32", "32-S1000"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_flash_backward_is_deterministic_on_card(cuda, causal, dtype, s, d):
    # two kernels and no atomics: each output element is summed by one
    # thread in a fixed order, launch after launch (bf16: the wgmma
    # kernels, each warpgroup its own rows, all D columns up to 128 and
    # 128 of them at 256; f32 at D 64 and 128: the split-TF32 wgmma
    # kernels, each warpgroup its own rows of dQ^T, dK^T or dV^T, one
    # f32 add a streamed tile; S = 1000 ends in ragged tiles)
    q, k, v, do = _flash_inputs((2, 4, s, d), dtype, 33)
    o, lse = ca.flash_attention_fwd(q, k, v, causal)
    runs = []
    for _ in range(2):
        dq, delta = ca.flash_attention_dq(q, k, v, o, lse, do, causal)
        dk, dv = ca.flash_attention_dkv(q, k, v, do, lse, delta, causal)
        runs.append((dq, delta, dk, dv))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("b, s, d", [
    (2, 512, 128), (2, 512, 256), (16, 512, 256), (2, 512, 64),
    (2, 512, 32), (2, 1000, 128), (2, 1000, 64), (2, 1000, 32)],
    ids=["d128", "d256", "d256-b16", "d64", "d32", "d128-S1000",
         "d64-S1000", "d32-S1000"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_flash_forward_is_deterministic_on_card(cuda, causal, dtype, b, s,
                                                d):
    # no atomics: each O element and LSE row is summed by one warpgroup
    # in a fixed order over the key tiles (f32 at head_dim 256: each
    # score of a tile summed by one thread from the two ranks' partials,
    # in rank order), launch after launch (bf16 at head_dim 256: b 2
    # gives 32 CTAs of 128 rows, fewer than the card's SMs, so the split
    # variant runs, whose warpgroups' halves combine in a fixed order; b
    # 16 the 128-row CTAs; S = 1000 ends in ragged tiles)
    q, k, v, _ = _flash_inputs((b, 4, s, d), dtype, 35)
    first = ca.flash_attention_fwd(q, k, v, causal)
    second = ca.flash_attention_fwd(q, k, v, causal)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("s, d", [(512, 128), (512, 64), (512, 32),
                                  (1000, 128), (1000, 64), (512, 256),
                                  (1000, 256)],
                         ids=["128", "64", "32", "128-S1000", "64-S1000",
                              "256", "256-S1000"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_flash_f32_backward_keeps_its_limits_on_card(cuda, causal, s, d):
    # f32 storage takes the split-TF32 kernels (wgmma at D 64 and 128, in
    # clusters of two CTAs at 256, mma.sync at 32): f32-accurate
    # products, so the readings stay within
    # the old limits (5e-4 of the largest element, 1e-4 of a tile), a
    # tile even within 1e-5, far under what bf16 or one-pass TF32
    # products would read (~3e-3 of a tile)
    q, k, v, do = _flash_inputs((1, 2, s, d), torch.float32, 34)
    o, lse = ca.flash_attention_fwd(q, k, v, causal)
    dq, delta = ca.flash_attention_dq(q, k, v, o, lse, do, causal)
    dk, dv = ca.flash_attention_dkv(q, k, v, do, lse, delta, causal)
    rdq, rdelta = ca.flash_attention_dq_plain(q, k, v, o, lse, do, causal)
    rdk, rdv = ca.flash_attention_dkv_plain(q, k, v, do, lse, rdelta, causal)
    assert _worst(delta, rdelta) <= 2e-5
    for got, ref in ((dq, rdq), (dk, rdk), (dv, rdv)):
        assert got.dtype == torch.float32
        assert _worst(got, ref) <= 5e-4
        assert _worst_tile(got, ref) <= 1e-5     # the limit is 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("s, d", [(512, 128), (512, 64), (512, 32),
                                  (1000, 128), (1000, 64), (512, 256),
                                  (1000, 256), (512, 192)],
                         ids=["128", "64", "32", "128-S1000", "64-S1000",
                              "256", "256-S1000", "192"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_flash_f32_forward_keeps_its_limits_on_card(cuda, causal, s, d):
    # f32 storage takes the split-TF32 wgmma forward (at head_dim 256,
    # and 192 zero-padded to it, on clusters of two CTAs): f32-accurate
    # products, so O and LSE stay within 2e-5 of the largest element and
    # O's worst tile within 1e-5 (the limit is 1e-4), far under what one
    # TF32 pass reads (~3e-4 of the largest element)
    q, k, v, _ = _flash_inputs((1, 2, s, d), torch.float32, 36)
    o, lse = ca.flash_attention_fwd(q, k, v, causal)
    ro, rlse = ca.flash_attention_fwd_plain(q, k, v, causal)
    assert o.dtype == torch.float32
    assert _worst(o, ro) <= 2e-5
    assert _worst(lse, rlse) <= 2e-5
    assert _worst_tile(o, ro) <= 1e-5


@pytest.mark.cuda
def test_flash_autograd_on_card_matches_cpu(cuda):
    rs = np.random.RandomState(32)
    arrays = [0.5 * rs.randn(2, 2, 256, 64).astype(np.float32)
              for _ in range(4)]
    grads = {}
    for dev in ("cpu", "cuda"):
        q, k, v, g = (torch.from_numpy(a).to(dev) for a in arrays)
        for t in (q, k, v):
            t.requires_grad_()
        ca.flash_attention(q, k, v, True).backward(g)
        grads[dev] = [t.grad.cpu() for t in (q, k, v)]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        assert _worst(a, b) <= 5e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("d", [8, 48, 96, 192])
def test_flash_kernels_take_unbuilt_head_dims_on_card(cuda, d, causal, dtype):
    # D outside HEAD_DIMS runs through the next built D, zero-padded;
    # held to chip_smoke.py's phase-6 limits against the plain versions
    _flash_kernels_against_plain(d, causal, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [2, 24], ids=["b2", "b24"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_flash_kernels_at_head_dim_256_on_card(cuda, causal, dtype, b):
    # the widest built head_dim (ROADMAP B0): the f32 kernels in split
    # TF32 (the backward on wgmma in clusters of two CTAs, 128 columns
    # each; the forward on mma.sync); bf16 on
    # wgmma, one CTA of two warpgroups owning all 256 columns of its rows
    # in every kernel (the forward: b 2 gives fewer 128-row CTAs than the
    # card has SMs, so its split variant runs, 64 rows a CTA; b 24 the
    # 128-row CTAs), S = 300: a ragged last tile
    _flash_kernels_against_plain(256, causal, dtype, b)


def _flash_kernels_against_plain(d, causal, dtype, b=2):
    rs = np.random.RandomState(50 + d)
    q, k, v, do = (torch.from_numpy(0.5 * rs.randn(b, 2, 300, d).astype(
        np.float32)).to("cuda", dtype) for _ in range(4))
    o, lse = ca.flash_attention_fwd(q, k, v, causal)
    dq, delta = ca.flash_attention_dq(q, k, v, o, lse, do, causal)
    dk, dv = ca.flash_attention_dkv(q, k, v, do, lse, delta, causal)
    ro, rlse = ca.flash_attention_fwd_plain(q, k, v, causal)
    rdq, rdelta = ca.flash_attention_dq_plain(q, k, v, o, lse, do, causal)
    rdk, rdv = ca.flash_attention_dkv_plain(q, k, v, do, lse, rdelta, causal)
    for t in (o, dq, dk, dv):
        assert t.shape == q.shape and t.dtype == dtype and t.is_contiguous()
    assert _worst(lse, rlse) <= 2e-5 and _worst(delta, rdelta) <= 2e-5
    assert _worst_tile(o, ro) <= FLASH_TILE_TOL[dtype]
    for got, ref in ((dq, rdq), (dk, rdk), (dv, rdv)):
        assert _worst_tile(got, ref) <= FLASH_BWD_TILE_TOL[dtype]
    if dtype == torch.float32:
        assert _worst(o, ro) <= 2e-5
        for got, ref in ((dq, rdq), (dk, rdk), (dv, rdv)):
            assert _worst(got, ref) <= 5e-4
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
    ca.flash_attention(ql, kl, vl, causal).backward(do)
    for t, ref in ((ql, dq), (kl, dk), (vl, dv)):
        assert torch.equal(t.grad, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("d", [320, 512, 1024, 1100])
def test_flash_wide_kernels_on_card(cuda, d, causal, dtype):
    # past 256 (csrc/flash_wide.cuh): the forward, dQ and dK/dV on
    # thread-block clusters of 128-column slices (320 padded to 384:
    # three; 1024: eight; 1100 padded to 1280: two clusters of five, each
    # building the scores again); two launches of the forward give
    # bitwise the same O and LSE, and of dK/dV the same dK and dV
    _flash_kernels_against_plain(d, causal, dtype)
    rs = np.random.RandomState(60 + d)
    q, k, v, do = (torch.from_numpy(0.5 * rs.randn(1, 2, 200, d).astype(
        np.float32)).to("cuda", dtype) for _ in range(4))
    first = ca.flash_attention_fwd(q, k, v, causal)
    for a, b in zip(first, ca.flash_attention_fwd(q, k, v, causal)):
        assert torch.equal(a, b)
    o, lse = first
    _, delta = ca.flash_attention_dq(q, k, v, o, lse, do, causal)
    grads = ca.flash_attention_dkv(q, k, v, do, lse, delta, causal)
    for a, b in zip(grads, ca.flash_attention_dkv(q, k, v, do, lse, delta,
                                                  causal)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_refuses_what_it_was_not_built_for(cuda):
    x = torch.randn(1, 2, 128, 64, device="cuda")
    # head_dim 300 is taken (zero-padded to 384, the wide kernels) and
    # agrees with the plain forward
    y = torch.randn(1, 2, 128, 300, device="cuda")
    o, lse = ca.flash_attention_fwd(y, y, y)
    ro, rlse = ca.flash_attention_fwd_plain(y, y, y)
    assert o.shape == y.shape
    assert _worst_tile(o, ro) <= FLASH_TILE_TOL[torch.float32]
    assert _worst(lse, rlse) <= 2e-5
    with pytest.raises(ValueError, match="contiguous"):
        ca.flash_attention_fwd(x.transpose(1, 2), x.transpose(1, 2),
                               x.transpose(1, 2))
    with pytest.raises(ValueError, match="not built"):
        ca.flash_attention_fwd(x.half(), x.half(), x.half())
    with pytest.raises(ValueError, match="cuda"):
        ca.flash_attention_fwd(x, x.cpu(), x)
    xb = torch.randn(x.numel() + 1, device="cuda").bfloat16()
    y = xb[1:].view(x.shape)             # contiguous, 2 bytes off
    with pytest.raises(ValueError, match="aligned"):
        ca.flash_attention_dkv(y, y, y, y, torch.zeros(2, 128, device="cuda"),
                               torch.zeros(2, 128, device="cuda"))
    o, lse = ca.flash_attention_fwd(x, x, x)
    with pytest.raises(ValueError, match="per-row"):
        ca.flash_attention_dq(x, x, x, o, lse[:1], x)


@pytest.mark.cuda
def test_train_steps_on_card_match_cpu(cuda):
    """Two SGD steps of a small net with both LRN sites, on the card
    (kernels) and on the CPU (plain versions), from the same weights."""
    from sparknet_tpu_torch.models import dsl, zoo
    from sparknet_tpu_torch.proto import Message
    from sparknet_tpu_torch.solver import Solver
    torch.backends.cudnn.allow_tf32 = True       # PyTorch's default
    net = dsl.NetParam(
        "CardNet", dsl.RDDLayer("data", [2, 3, 12, 12]),
        dsl.RDDLayer("label", [2]),
        zoo._gconv("conv1", "data", 8, 3, pad=1),
        dsl.ReLULayer("relu1", ["conv1"], tops=["conv1"]),
        dsl.PoolingLayer("pool1", ["conv1"], "MAX", (2, 2), (2, 2)),
        dsl.LRNLayer("norm1", ["pool1"], local_size=5, alpha=0.1,
                     beta=0.75),
        zoo._gconv("conv2", "norm1", 12, 3, pad=1),
        dsl.ReLULayer("relu2", ["conv2"], tops=["conv2"]),
        dsl.LRNLayer("norm2", ["conv2"], local_size=5, alpha=0.1,
                     beta=0.75),
        zoo._fc("fc", "norm2", 10, w_type="xavier"),
        dsl.SoftmaxWithLoss("loss", ["fc", "label"]))
    sp = Message("SolverParameter", base_lr=0.05, lr_policy="fixed",
                 momentum=0.9, weight_decay=5e-4, random_seed=2)
    cpu = Solver(sp, net_param=net, device="cpu", log_fn=None)
    card = Solver(sp, net_param=net, device="cuda", log_fn=None)
    rs = np.random.RandomState(0)
    n0 = (cl.lrn_across_bwd.launches, ce.bias_relu_lrn_bwd.launches)
    for _ in range(2):
        b = {"data": rs.randn(2, 3, 12, 12).astype(np.float32),
             "label": rs.randint(0, 10, 2).astype(np.int32)}
        np.testing.assert_allclose(float(card.train_step(b)),
                                   float(cpu.train_step(b)), rtol=1e-5)
    assert cl.lrn_across_bwd.launches == n0[0] + 2
    assert ce.bias_relu_lrn_bwd.launches == n0[1] + 2
    for name, blobs in cpu.params.items():
        for c, g in zip(blobs, card.params[name]):
            torch.testing.assert_close(g.detach().cpu(), c.detach(),
                                       rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("mean", ["full", "channel", "none"])
def test_device_transform_on_card_equals_the_host_transform(cuda, mean):
    """The record feed's transform on the card against the host's numpy
    transform on the same draws: equal bit for bit; a crop one column
    over must differ."""
    from sparknet_tpu_torch.data.device_transform import (
        DeviceTransformer, transform_batch)
    from sparknet_tpu_torch.data.transforms import (DataTransformer,
                                                    transform_batch as host)
    rs = np.random.RandomState(21)
    images = rs.randint(0, 256, (9, 3, 40, 44)).astype(np.uint8)
    t = DataTransformer(rng=np.random.RandomState(22))
    t.crop_size, t.mirror, t.scale = 33, True, 0.017
    if mean == "full":
        t.mean, t.full_mean = (rs.rand(3, 40, 44) * 255).astype(np.float32), \
            True
    elif mean == "channel":
        t.mean = np.array([104.0, 117.0, 123.0], np.float32)
    dev = DeviceTransformer(t)
    aux = dev.aux(9, images.shape[1:])
    ys, xs, flips = aux["data#y"], aux["data#x"], aux["data#flip"]
    want = host(images, 33, ys=ys, xs=xs, mirror=flips, mean=t.mean,
                scale=t.scale, full_mean=t.full_mean)
    got = dev.device_fn()({"data": torch.from_numpy(images).cuda(),
                           **{k: torch.from_numpy(v).cuda()
                              for k, v in aux.items()}})["data"]
    assert got.is_cuda
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    shifted = transform_batch(torch.from_numpy(images).cuda(), 33,
                              ys=ys, xs=np.minimum(xs + 1, 44 - 33),
                              mirror=flips, mean=t.mean, scale=t.scale,
                              full_mean=t.full_mean)
    assert float((shifted.cpu() - torch.from_numpy(want)).abs().max()) > 0


@pytest.mark.cuda
def test_h2d_stager_copies_batches_on_a_side_stream(cuda):
    """Batches staged by the prefetch worker arrive on the card equal to
    their host arrays; the pinned slots are reused, so at most ``slots``
    copies are in flight."""
    from sparknet_tpu_torch.data.prefetch import (H2DStager,
                                                  PrefetchIterator,
                                                  StagedBatch, wait_staged)
    rs = np.random.RandomState(23)
    batches = [{"data": rs.randint(0, 256, (4, 3, 64, 64)).astype(np.uint8),
                "label": rs.randint(0, 10, 4).astype(np.int32)}
               for _ in range(6)]
    stager = H2DStager(slots=2)
    it = PrefetchIterator(iter(batches), depth=2, transform=stager)
    for want in batches:
        got = next(it)
        assert isinstance(got, StagedBatch)
        wait_staged(got)
        for k in want:
            assert got[k].is_cuda
            np.testing.assert_array_equal(got[k].cpu().numpy(), want[k])
    assert it.close()
    assert stager.puts == 6 and len(stager._pinned) == 2
    assert stager(batches[0]) is not batches[0]
    cuda_batch = {k: torch.from_numpy(v).cuda() for k, v in
                  batches[0].items()}
    assert stager(cuda_batch) is cuda_batch
