"""The rounding budget of the bf16 tensor-core flash backward, on the CPU.

csrc/flash_bwd.cu's bf16 kernels take bf16 q, k, v, dO; accumulate S and
dP in f32; round P and dS to bf16 before the three second products
(dV = P^T dO, dQ = scale dS K, dK = scale dS^T Q), which sum in f32; and
round dQ, dK, dV to bf16 once. That is emulated here in plain PyTorch (f32
products of bf16 values are exact, so f32 matmuls stand for the tensor
cores up to summation order) and held against the plain versions
(ops/cuda_attention.py, f32 throughout, outputs rounded once) at the
measure chip_smoke.py holds the kernels to: each output's worst 64-row
tile, as a share of that tile's norm. Every reading must lie under the
card's limit of 5e-3 and above 1e-3 (the rounding of P and dS is real:
rounding only the outputs reads ~2e-4), and both planted faults of
chip_smoke.py must read above the limit.
"""

import numpy as np
import pytest
import torch

from sparknet_tpu_torch.ops import cuda_attention as ca

BWD_TILE_LIMIT = 5e-3     # chip_smoke.FLASH_BWD_TILE_LIMIT["bfloat16"]


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


@pytest.mark.parametrize("output", ["dq", "dk", "dv"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("shape", [(1, 2, 512, 128), (2, 3, 256, 64)],
                         ids=["S512-D128", "S256-D64"])
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
