"""LayerNorm and MVN (the port of sparknet_tpu/ops/normalization.py).

LayerNorm normalizes the last axis with learned gamma (filled 1) and beta
(filled 0); its statistics are taken in f32 whatever the activations'
dtype, and its output has the input's dtype. MVN (Caffe mvn_layer.cpp)
normalizes each sample, per channel or across channels, to zero mean
and, optionally, unit variance with divisor (std + eps). BatchNorm, the
stateful one, is not ported yet.
"""

import torch

from ..graph.registry import Layer, register
from ..proto import Message
from .convolution import _param_mults


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
