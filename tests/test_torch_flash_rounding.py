"""The rounding budget of the bf16 tensor-core flash kernels, on the CPU.

The backward: csrc/flash_bwd.cu's bf16 kernels take bf16 q, k, v, dO;
accumulate S and dP in f32; round P and dS to bf16 before the three
second products (dV = P^T dO, dQ = scale dS K, dK = scale dS^T Q), which
sum in f32; and round dQ, dK, dV to bf16 once. That is emulated here in
plain PyTorch (f32 products of bf16 values are exact, so f32 matmuls
stand for the tensor cores up to summation order) and held against the
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
"""

import numpy as np
import pytest
import torch

from sparknet_tpu_torch.ops import cuda_attention as ca

BWD_TILE_LIMIT = 5e-3     # chip_smoke.FLASH_BWD_TILE_LIMIT["bfloat16"]
FWD_TILE_LIMIT = 5e-3     # chip_smoke.FLASH_TILE_LIMIT["bfloat16"]
SHAPES = [pytest.param((1, 2, 512, 128), id="S512-D128"),
          pytest.param((2, 3, 256, 64), id="S256-D64")]


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


def _emulated_backward(q, k, v, o, lse, do, causal):
    """dq, dk, dv with the bf16 kernels' rounding points."""
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
    dq = scale * (dsb @ kf)
    dk = scale * (dsb.transpose(-1, -2) @ qf)
    dv = pb.transpose(-1, -2) @ dof
    return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))


def _emulated_forward(q, k, v, causal, tile=128):
    """O with the bf16 forward kernel's rounding points, key tile by key
    tile as the kernel walks them."""
    b, h, s, d = q.shape
    scale = ca.default_scale(q)
    qf, kf, vf = (t.float() for t in (q, k, v))
    m = torch.full((b, h, s, 1), ca.NEG_INF)
    l = torch.zeros(b, h, s, 1)
    acc = torch.zeros(b, h, s, d)
    rows = torch.arange(s)[:, None]
    for k0 in range(0, s, tile):
        sc = scale * (qf @ kf[:, :, k0:k0 + tile].transpose(-1, -2))
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
    return (acc / l.clamp_min(1e-30)).to(torch.bfloat16)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("shape", SHAPES)
def test_tensor_core_forward_rounding_fits_the_bf16_tile_limit(shape, causal):
    rs = np.random.RandomState(43)
    q, k, v = (torch.from_numpy(0.5 * rs.randn(*shape).astype(
        np.float32)).to(torch.bfloat16) for _ in range(3))
    ro, _ = ca.flash_attention_fwd_plain(q, k, v, causal)
    got = _emulated_forward(q, k, v, causal)
    reading = _worst_tile(got, ro)
    assert 1e-3 < reading < FWD_TILE_LIMIT, reading
    for bad in _planted(got):
        assert _worst_tile(bad, ro) > FWD_TILE_LIMIT


@pytest.mark.parametrize("output", ["dq", "dk", "dv"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("shape", SHAPES)
def test_tensor_core_rounding_fits_the_bf16_tile_limit(shape, causal, output):
    rs = np.random.RandomState(41)
    q, k, v, do = (torch.from_numpy(0.5 * rs.randn(*shape).astype(
        np.float32)).to(torch.bfloat16) for _ in range(4))
    o, lse = ca.flash_attention_fwd_plain(q, k, v, causal)
    got = dict(zip(("dq", "dk", "dv"),
                   _emulated_backward(q, k, v, o, lse, do, causal)))
    rdq, rdelta = ca.flash_attention_dq_plain(q, k, v, o, lse, do, causal)
    rdk, rdv = ca.flash_attention_dkv_plain(q, k, v, do, lse, rdelta, causal)
    ref = {"dq": rdq, "dk": rdk, "dv": rdv}[output]
    reading = _worst_tile(got[output], ref)
    assert 1e-3 < reading < BWD_TILE_LIMIT, reading
    for bad in _planted(got[output]):
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


def test_built_head_dim():
    assert [ca.built_head_dim(d)
            for d in (1, 16, 17, 33, 64, 65, 128, 129, 192, 256)] == \
        [16, 16, 32, 64, 64, 128, 128, 256, 256, 256]
    # past 256: the next multiple of 64 (the wide kernels)
    assert [ca.built_head_dim(d) for d in (257, 300, 320, 321, 512, 1000)] \
        == [320, 320, 320, 384, 512, 1024]
