"""MAX, AVE and STOCHASTIC pooling with exact Caffe geometry, and SPP
(the port of sparknet_tpu/ops/pooling.py).

Semantics match Caffe's pooling_layer.cpp:
  * ceil-mode output sizing:  out = ceil((in + 2p - k)/s) + 1, then if padded
    and (out-1)*s >= in + p, out is decremented (pooling_layer.cpp:92-107).
  * MAX ignores padding entirely (window clipped to the real image,
    pooling_layer.cpp:156-161) — realized here by padding with -inf.
  * AVE divides by the window area clipped to [start, in + pad) with the RAW
    (possibly negative) start (pooling_layer.cpp:199-203) — divisors are
    position-dependent at borders and computed once on the host.
  * STOCHASTIC (Zeiler & Fergus; pooling_layer.cu) over each zero-padded
    window p: TEST gives sum(p^2)/sum(p), and 0 where sum(p) <= 0; TRAIN
    picks one element with probability max(p, 0)/sum(max(p, 0)) (a
    window with no positive element picks uniformly), drawn from the
    layer's torch.Generator. The draws follow Caffe's: u*sum against the
    running sum. They cannot match the JAX package's bits, only their
    distribution.
Each pads explicitly (left ``pad``, right whatever the last ceil-mode
window overhangs) and then pools with no implicit padding, so the
geometry never depends on the framework's own ceil-mode rules.
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..graph.registry import Layer, register

MAX, AVE, STOCHASTIC = 0, 1, 2


def caffe_pool_geometry(pp, in_h, in_w):
    """Resolve kernel/stride/pad + ceil-mode output sizes from a
    PoolingParameter, reproducing pooling_layer.cpp LayerSetUp/Reshape."""
    if pp.global_pooling:
        kh, kw = in_h, in_w
        sh = sw = 1
        ph = pw = 0
    else:
        if pp.has_kernel_size():
            kh = kw = int(pp.kernel_size)
        else:
            kh, kw = int(pp.kernel_h), int(pp.kernel_w)
        if pp.has_stride_h():
            sh, sw = int(pp.stride_h), int(pp.stride_w)
        else:
            sh = sw = int(pp.stride)
        if pp.has_pad_h():
            ph, pw = int(pp.pad_h), int(pp.pad_w)
        else:
            ph = pw = int(pp.pad)
    oh = int(np.ceil((in_h + 2 * ph - kh) / sh)) + 1
    ow = int(np.ceil((in_w + 2 * pw - kw) / sw)) + 1
    if ph or pw:
        if (oh - 1) * sh >= in_h + ph:
            oh -= 1
        if (ow - 1) * sw >= in_w + pw:
            ow -= 1
    return (kh, kw), (sh, sw), (ph, pw), (oh, ow)


def _edge_pad(in_size, k, s, p, out):
    """Right-side padding needed so every (possibly overhanging) ceil-mode
    window lies inside the padded array."""
    return max(0, (out - 1) * s + k - p - in_size)


def _ave_counts(in_size, k, s, p, out):
    """Caffe AVE divisor per output position (raw start, end clipped to in+p)."""
    starts = np.arange(out) * s - p
    ends = np.minimum(starts + k, in_size + p)
    return (ends - starts).astype(np.float32)


def _padded(x, kernel, stride, pad, out, value):
    (kh, kw), (sh, sw), (ph, pw), (oh, ow) = kernel, stride, pad, out
    h, w = x.shape[2], x.shape[3]
    rh = _edge_pad(h, kh, sh, ph, oh)
    rw = _edge_pad(w, kw, sw, pw, ow)
    return F.pad(x, (pw, rw, ph, rh), value=value)


def max_pool(x, kernel, stride, pad, out):
    xp = _padded(x, kernel, stride, pad, out, float("-inf"))
    return F.max_pool2d(xp, kernel, stride)


def ave_pool(x, kernel, stride, pad, out):
    (kh, kw), (sh, sw), (ph, pw), (oh, ow) = kernel, stride, pad, out
    h, w = x.shape[2], x.shape[3]
    xp = _padded(x, kernel, stride, pad, out, 0.0)
    sums = F.avg_pool2d(xp, kernel, stride, divisor_override=1)
    counts = np.outer(_ave_counts(h, kh, sh, ph, oh),
                      _ave_counts(w, kw, sw, pw, ow))
    return sums / torch.as_tensor(counts, dtype=x.dtype, device=x.device)


def _patches(x, kernel, stride, pad, out):
    """(N, C, kh*kw, OH, OW) zero-padded windows."""
    (kh, kw), (sh, sw), (oh, ow) = kernel, stride, out
    n, c = x.shape[:2]
    xp = _padded(x, kernel, stride, pad, out, 0.0)
    return F.unfold(xp, (kh, kw), stride=(sh, sw)).reshape(
        n, c, kh * kw, oh, ow)


def stochastic_pool(x, kernel, stride, pad, out, train, rng=None):
    p = _patches(x, kernel, stride, pad, out)
    if not train:
        denom = p.sum(dim=2)
        num = (p * p).sum(dim=2)
        return torch.where(denom > 0, num / denom.clamp_min(1e-30),
                           torch.zeros_like(denom))
    if rng is None:
        raise ValueError("TRAIN-phase STOCHASTIC pooling needs a generator")
    with torch.no_grad():
        w = p.clamp_min(0)
        dead = (w > 0).sum(dim=2, keepdim=True) == 0
        w = torch.where(dead, torch.ones_like(w), w)
        run = w.cumsum(dim=2)
        u = torch.rand(run[:, :, -1:].shape, generator=rng,
                       device=x.device, dtype=run.dtype)
        # the first element whose running sum passes u * total
        idx = (run <= u * run[:, :, -1:]).sum(dim=2, keepdim=True) \
            .clamp_max(p.shape[2] - 1)
    return p.gather(2, idx)[:, :, 0]


def pool(method, x, kernel, stride, pad, out, train, rng=None):
    if method == MAX:
        return max_pool(x, kernel, stride, pad, out)
    if method == AVE:
        return ave_pool(x, kernel, stride, pad, out)
    return stochastic_pool(x, kernel, stride, pad, out, train, rng)


@register
class Pooling(Layer):
    type_name = "Pooling"

    def __init__(self, lp, bottom_shapes, phase):
        super().__init__(lp, bottom_shapes, phase)
        pp = lp.pooling_param
        self.method = int(pp.pool)
        # only STOCHASTIC draws: the compiler makes generators for it alone
        self.needs_rng = self.method == STOCHASTIC
        n, c, h, w = bottom_shapes[0]
        self.kernel, self.stride, self.pad, self.out = \
            caffe_pool_geometry(pp, h, w)

    def out_shapes(self):
        n, c, h, w = self.bottom_shapes[0]
        return [(n, c) + self.out]

    def apply(self, params, bottoms, train, rng=None):
        return [pool(self.method, bottoms[0], self.kernel, self.stride,
                     self.pad, self.out, train, rng)]


@register
class SPP(Layer):
    """Spatial pyramid pooling (Caffe spp_layer.cpp): levels 0..H-1 of
    2^i x 2^i bins, each a pooling with kernel ceil(in/bins), stride the
    kernel and pad (kernel*bins - in + 1)/2, flattened and concatenated
    along dim 1."""

    type_name = "SPP"

    def __init__(self, lp, bottom_shapes, phase):
        super().__init__(lp, bottom_shapes, phase)
        sp = lp.spp_param
        self.method = int(sp.pool)
        self.needs_rng = self.method == STOCHASTIC
        n, c, h, w = bottom_shapes[0]
        self.levels = []
        for i in range(int(sp.pyramid_height)):
            bins = 2 ** i
            kh, kw = -(-h // bins), -(-w // bins)
            ph, pw = (kh * bins - h + 1) // 2, (kw * bins - w + 1) // 2
            self.levels.append(((kh, kw), (kh, kw), (ph, pw), (bins, bins)))

    def out_shapes(self):
        n, c, h, w = self.bottom_shapes[0]
        return [(n, c * sum(b * b for *_, (b, _) in self.levels))]

    def apply(self, params, bottoms, train, rng=None):
        x = bottoms[0]
        return [torch.cat([pool(self.method, x, *level, train, rng)
                           .reshape(x.shape[0], -1)
                           for level in self.levels], dim=1)]
