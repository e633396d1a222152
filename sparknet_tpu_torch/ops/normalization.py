"""BatchNorm, LayerNorm and MVN (the port of
sparknet_tpu/ops/normalization.py).

BatchNorm (Caffe batch_norm_layer.cpp) keeps three non-learnable state
blobs [running mean * s, running var * s, s], s the accumulated scale
factor; ``use_global_stats`` defaults to phase == TEST. It normalizes by
the stored statistics (divided by s, or by 0 while s is 0), or in TRAIN
by the batch's mean and biased variance, and then updates the state with
``moving_average_fraction`` and the m/(m-1) correction of the variance.
The state is threaded through the compiled net (``apply_stateful``
returns the new blobs; graph/compiler.py commits them), never mutated in
place, and carries no autograd graph.

LayerNorm normalizes the last axis with learned gamma (filled 1) and beta
(filled 0); its statistics are taken in f32 whatever the activations'
dtype, and its output has the input's dtype. MVN (Caffe mvn_layer.cpp)
normalizes each sample, per channel or across channels, to zero mean
and, optionally, unit variance with divisor (std + eps).
"""

import torch

from ..graph.registry import Layer, register
from ..proto import Message
from .convolution import _param_mults


def _bcast(v, x):
    shape = [1] * x.dim()
    shape[1] = v.shape[0]
    return v.reshape(shape)


@register
class BatchNorm(Layer):
    type_name = "BatchNorm"
    has_state = True

    def __init__(self, lp, bottom_shapes, phase):
        super().__init__(lp, bottom_shapes, phase)
        p = lp.batch_norm_param
        self.eps = float(p.eps)
        self.maf = float(p.moving_average_fraction)
        self.use_global = bool(p.use_global_stats) \
            if p.has("use_global_stats") else phase == 1   # TEST
        self.channels = bottom_shapes[0][1]

    def state_shapes(self):
        c = self.channels
        return [((c,), 0.0), ((c,), 0.0), ((1,), 0.0)]

    def out_shapes(self):
        return [self.bottom_shapes[0]]

    def apply_stateful(self, params, state, bottoms, train):
        """-> ([top], new state)."""
        x = bottoms[0]
        mean_b, var_b, scale_b = state
        dims = (0,) + tuple(range(2, x.dim()))
        if self.use_global or not train:
            s = scale_b[0]
            factor = torch.where(s == 0, torch.zeros_like(s),
                                 1.0 / torch.where(s == 0,
                                                   torch.ones_like(s), s))
            mean, var = mean_b * factor, var_b * factor
            new_state = state
        else:
            mean = x.mean(dim=dims)
            var = ((x - _bcast(mean, x)) ** 2).mean(dim=dims)
            m = x.numel() // self.channels
            correction = m / (m - 1) if m > 1 else 1.0
            with torch.no_grad():
                new_state = [self.maf * mean_b + mean,
                             self.maf * var_b + correction * var,
                             self.maf * scale_b + 1.0]
        inv = 1.0 / torch.sqrt(var + self.eps)
        return [(x - _bcast(mean, x)) * _bcast(inv, x)], new_state


@register
class LayerNorm(Layer):
    type_name = "LayerNorm"

    def __init__(self, lp, bottom_shapes, phase):
        super().__init__(lp, bottom_shapes, phase)
        p = lp.layer_norm_param
        self.eps = float(p.eps)
        self.affine = bool(int(p.affine))
        self.dim = int(bottom_shapes[0][-1])

    def param_shapes(self):
        if not self.affine:
            return []
        mults = _param_mults(self.lp, 2)
        ones = Message("FillerParameter", type="constant", value=1.0)
        return [((self.dim,), ones, *mults[0]),          # gamma
                ((self.dim,), None, *mults[1])]          # beta (zeros)

    def out_shapes(self):
        return [self.bottom_shapes[0]]

    def apply(self, params, bottoms, train):
        x = bottoms[0]
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
        y = (xf - mean) / torch.sqrt(var + self.eps)
        if self.affine:
            y = y * params[0].float() + params[1].float()
        return [y.to(x.dtype)]


@register
class MVN(Layer):
    type_name = "MVN"

    def __init__(self, lp, bottom_shapes, phase):
        super().__init__(lp, bottom_shapes, phase)
        p = lp.mvn_param
        self.normalize_variance = bool(p.normalize_variance)
        self.across_channels = bool(p.across_channels)
        self.eps = float(p.eps)

    def out_shapes(self):
        return [self.bottom_shapes[0]]

    def apply(self, params, bottoms, train):
        x = bottoms[0]
        dims = tuple(range(1 if self.across_channels else 2, x.dim()))
        y = x - x.mean(dim=dims, keepdim=True)
        if self.normalize_variance:
            std = torch.sqrt((y * y).mean(dim=dims, keepdim=True))
            y = y / (std + self.eps)
        return [y]
