"""The channel-walk kernels' partition, emulated in plain PyTorch on the
CPU (no JAX; a few seconds).

csrc/channel_walk.cuh gives each CTA a chunk of output channels
[c0, c0 + cc), ceil(C / kChunk) chunks of near-equal size, and stages
only the input rows those outputs need:

    forward:   x (or y)   [c0 - half, c0 + cc + size - 1 - half)
    backward:  x (or y)   [c0 - (size - 1), c0 + cc + size - 1)
               g          [c0 - lo, c0 + cc + half)

with half = (size - 1) // 2 and lo = size - 1 - half: the real
neighbours inside [0, C), zeros outside; in the epilogue the zeros are
those of y = relu(x + b), taken after the ReLU. The emulation below
computes every chunk from that slice alone, with the plain versions' own
formulas, and must agree with the plain versions over the whole tensor
bit for bit: the same window sums in the same order.

H*W is 32 so that every tensor here is a whole number of the CPU's
vector iterations: PyTorch's vectorised pow and its scalar tail round
differently, which would make the bits depend on an element's position
rather than on the partition.
"""

import math
import os
import re

import numpy as np
import pytest
import torch

from sparknet_tpu_torch.ops import cuda_epilogue as ce
from sparknet_tpu_torch.ops import cuda_lrn as cl

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "sparknet_tpu_torch", "csrc")
with open(os.path.join(CSRC, "channel_walk.cuh")) as _f:
    CHUNK = int(re.search(r"constexpr int kChunk = (\d+);", _f.read())[1])

ALPHA, BETA, K = 0.5, 0.75, 1.5       # window terms far above rounding


def chunks(c):
    """[(c0, cc)]: walk_geometry's ceil(C / kChunk) balanced chunks."""
    n = -(-c // CHUNK)
    size = -(-c // n)
    return [(c0, min(size, c - c0)) for c0 in range(0, c, size)]


def halo(t, lo, hi, fn=None):
    """Channels [lo, hi) of ``t`` (dim 1): the real rows inside [0, C),
    mapped by ``fn(rows, first_channel)`` where given, and zero rows
    outside, added after ``fn``."""
    c = t.shape[1]
    a, b = max(lo, 0), min(hi, c)
    rows = t[:, a:b]
    if fn is not None:
        rows = fn(rows, a)
    shape = list(rows.shape)
    shape[1] = a - lo
    before = rows.new_zeros(shape)
    shape[1] = hi - b
    return torch.cat([before, rows, rows.new_zeros(shape)], dim=1)


def biased_relu(b, dtype, in_dtype):
    """fn for halo: y = relu(x + b) of the rows, formed as the plain
    versions form it (f32 in the forward, ``dtype`` in the backward)."""
    def fn(rows, first):
        bias = b[first:first + rows.shape[1]].to(dtype).reshape(1, -1, 1, 1)
        if in_dtype:
            return torch.relu(rows + bias)
        return torch.relu(rows.float() + bias.float())
    return fn


def emulated_forward(x, b, size, after_relu=True):
    """The forward, chunk by chunk from the halo slices; with ``b`` the
    bias+ReLU+LRN epilogue. ``after_relu=False`` plants the tiled
    epilogue's trap: zeros in x and the bias of the nearest channel
    inside, so that a halo row becomes relu(b) and not 0."""
    half = (size - 1) // 2
    out = []
    for c0, cc in chunks(x.shape[1]):
        lo, hi = c0 - half, c0 + cc + size - 1 - half
        if b is None:
            v = halo(x, lo, hi).float()
        elif after_relu:
            v = halo(x, lo, hi, biased_relu(b, x.dtype, False))
        else:
            near = torch.arange(lo, hi).clamp(0, x.shape[1] - 1)
            bias = b[near].to(x.dtype).float().reshape(1, -1, 1, 1)
            v = torch.relu(halo(x, lo, hi).float() + bias)
        out.append(cl.lrn_window_f32(v, size, ALPHA, BETA, K)[:, half:half + cc])
    return torch.cat(out, dim=1).to(x.dtype)


def emulated_backward(x, b, g, size):
    """dx chunk by chunk: scale, t and g * scale^-beta from the slices of
    v and g, the mirrored window sum over t; with ``b`` the fused
    epilogue backward (v = y in x.dtype, dx masked with y > 0). t of a
    row outside [0, C) is 0, as in the kernel."""
    c = x.shape[1]
    half = (size - 1) // 2
    lo = size - 1 - half
    out = []
    for c0, cc in chunks(c):
        v = halo(x, c0 - (size - 1), c0 + cc + size - 1,
                 None if b is None else biased_relu(b, x.dtype, True))
        xf = v.float()
        gf = halo(g, c0 - lo, c0 + cc + half).float()
        # g row j is channel c0 - lo + j, v row j + half
        scale = cl.lrn_scale_f32(xf, size, ALPHA, K)[:, half:half + cc + size - 1]
        inside = torch.tensor([0 <= c0 - lo + j < c
                               for j in range(cc + size - 1)])
        t = gf * xf[:, half:half + cc + size - 1] * scale ** (-BETA - 1.0)
        t = torch.where(inside.reshape(1, -1, 1, 1), t, torch.zeros_like(t))
        acc = cl.window_sum(t, size, lo)[:, lo:lo + cc]
        vc = xf[:, size - 1:size - 1 + cc]
        dx = (gf[:, lo:lo + cc] * scale[:, lo:lo + cc] ** (-BETA)
              - (2.0 * ALPHA * BETA / size) * vc * acc)
        if b is not None:
            dx = torch.where(vc > 0, dx, torch.zeros_like(dx))
        out.append(dx)
    return torch.cat(out, dim=1).to(g.dtype)


def _inputs(c, size, dtype=torch.float32):
    rs = np.random.RandomState(1000 * size + c)
    x, g = (torch.from_numpy(rs.randn(2, c, 4, 8).astype(np.float32)).to(dtype)
            for _ in range(2))
    b = torch.from_numpy(rs.randn(c).astype(np.float32))
    return x, b, g


def _plain(direction, fused, x, b, g, size):
    if direction == "forward":
        return (ce.bias_relu_lrn_plain(x, b, size, ALPHA, BETA, K) if fused
                else cl.lrn_across_plain(x, size, ALPHA, BETA, K))
    return (ce.bias_relu_lrn_bwd_plain(x, b, g, size, ALPHA, BETA, K)[0]
            if fused else cl.lrn_across_bwd_plain(x, g, size, ALPHA, BETA, K))


def _emulated(direction, fused, x, b, g, size):
    if direction == "forward":
        return emulated_forward(x, b if fused else None, size)
    return emulated_backward(x, b if fused else None, g, size)


def _channel_counts(size):
    return sorted(c for c in {1, 2, size - 1, CHUNK - 1, CHUNK, CHUNK + 1,
                              3 * CHUNK + 2} if c >= 1)


CASES = [pytest.param(direction, fused, size, c,
                      id=f"{direction}-{'fused' if fused else 'lrn'}-"
                         f"size{size}-C{c}")
         for direction in ("forward", "backward")
         for fused in (False, True)
         for size in range(1, 8)
         for c in _channel_counts(size)]


@pytest.mark.parametrize("direction,fused,size,c", CASES)
def test_chunked_halos_reproduce_the_plain_versions_bit_for_bit(
        direction, fused, size, c):
    x, b, g = _inputs(c, size)
    got = _emulated(direction, fused, x, b, g, size)
    ref = _plain(direction, fused, x, b, g, size)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert torch.equal(got, ref)


@pytest.mark.parametrize("direction", ["forward", "backward"])
@pytest.mark.parametrize("fused", [False, True], ids=["lrn", "fused"])
def test_chunked_halos_in_bf16(direction, fused):
    x, b, g = _inputs(CHUNK + 1, 5, torch.bfloat16)
    assert torch.equal(_emulated(direction, fused, x, b, g, 5),
                       _plain(direction, fused, x, b, g, 5))


def test_zeros_taken_before_the_relu_are_caught():
    # the tiled epilogue's trap: a halo row outside [0, C) zero in x
    # becomes relu(0 + b) = b > 0 instead of 0
    x, b, _ = _inputs(CHUNK + 1, 5)
    b = b.abs() + 0.5
    ref = ce.bias_relu_lrn_plain(x, b, 5, ALPHA, BETA, K)
    assert torch.equal(emulated_forward(x, b, 5), ref)
    assert not torch.equal(emulated_forward(x, b, 5, after_relu=False), ref)


@pytest.mark.parametrize("c", [1, 2, CHUNK - 1, CHUNK, CHUNK + 1, 64, 96,
                               192, 256, 3 * CHUNK + 2])
def test_chunks_tile_the_channels_exactly(c):
    parts = chunks(c)
    assert len(parts) == math.ceil(c / CHUNK)
    assert [c0 for c0, _ in parts] == list(
        np.cumsum([0] + [cc for _, cc in parts[:-1]]))
    assert sum(cc for _, cc in parts) == c
    sizes = [cc for _, cc in parts]
    assert all(1 <= cc <= CHUNK for cc in sizes)
    assert max(sizes) - min(sizes) < len(parts)      # balanced
