"""Neuron (elementwise) layers: the port of sparknet_tpu/ops/activations.py
(Caffe's neuron layers: relu, prelu, sigmoid, tanh, bnll, absval, power,
exp, log, threshold and dropout). Each is a plain expression on tensors;
autograd differentiates it.
"""

import torch

from ..graph.registry import Layer, register
from ..proto import Message
from .convolution import _param_mults


class _Elementwise(Layer):
    def out_shapes(self):
        return [self.bottom_shapes[0]]


@register
class ReLU(_Elementwise):
    type_name = "ReLU"

    def apply(self, params, bottoms, train):
        x = bottoms[0]
        slope = self.lp.relu_param.negative_slope if self.lp.has("relu_param") \
            else 0.0
        if slope:
            return [torch.where(x > 0, x, slope * x)]
        return [torch.relu(x)]


@register
class PReLU(_Elementwise):
    """Learned negative slope (Caffe prelu_layer.cpp): one slope per
    channel (dim 1), or a single one when ``channel_shared``; the slope
    blob fills with constant 0.25 unless the layer names a filler."""

    type_name = "PReLU"

    def __init__(self, lp, bottom_shapes, phase):
        super().__init__(lp, bottom_shapes, phase)
        p = lp.prelu_param
        self.shared = bool(p.channel_shared)
        self.channels = bottom_shapes[0][1] if len(bottom_shapes[0]) > 1 \
            else 1
        self.filler = p.filler if p.has("filler") else \
            Message("FillerParameter", type="constant", value=0.25)

    def param_shapes(self):
        shape = (1,) if self.shared else (self.channels,)
        (m,) = _param_mults(self.lp, 1)
        return [(shape, self.filler, *m)]

    def apply(self, params, bottoms, train):
        x = bottoms[0]
        slope = params[0].to(x.dtype)
        if not self.shared:
            bshape = [1] * x.dim()
            bshape[1] = self.channels
            slope = slope.reshape(bshape)
        return [torch.clamp_min(x, 0) + slope * torch.clamp_max(x, 0)]


@register
class Sigmoid(_Elementwise):
    type_name = "Sigmoid"

    def apply(self, params, bottoms, train):
        return [torch.sigmoid(bottoms[0])]


@register
class TanH(_Elementwise):
    type_name = "TanH"

    def apply(self, params, bottoms, train):
        return [torch.tanh(bottoms[0])]


@register
class BNLL(_Elementwise):
    """log(1 + exp(x)) in the overflow-safe form of the JAX layer's
    softplus (``logaddexp(x, 0)``): max(x, 0) + log1p(exp(-|x|))."""

    type_name = "BNLL"

    def apply(self, params, bottoms, train):
        x = bottoms[0]
        return [torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))]


@register
class AbsVal(_Elementwise):
    type_name = "AbsVal"

    def apply(self, params, bottoms, train):
        return [bottoms[0].abs()]


@register
class Power(_Elementwise):
    """(shift + scale * x) ^ power (Caffe power_layer.cpp)."""

    type_name = "Power"

    def apply(self, params, bottoms, train):
        p = self.lp.power_param
        y = p.shift + p.scale * bottoms[0]
        if p.power == 1.0:
            return [y]
        return [y ** p.power]


@register
class Exp(_Elementwise):
    """base ^ (shift + scale * x); base -1 means e (Caffe exp_layer.cpp)."""

    type_name = "Exp"

    def apply(self, params, bottoms, train):
        p = self.lp.exp_param
        x = bottoms[0]
        inner = p.shift + p.scale * x
        if p.base == -1.0:
            return [torch.exp(inner)]
        return [torch.pow(torch.tensor(p.base, dtype=x.dtype,
                                       device=x.device), inner)]


@register
class Log(_Elementwise):
    """log_base(shift + scale * x); base -1 means e (Caffe log_layer.cpp)."""

    type_name = "Log"

    def apply(self, params, bottoms, train):
        p = self.lp.log_param
        x = bottoms[0]
        y = torch.log(p.shift + p.scale * x)
        if p.base != -1.0:
            y = y / torch.log(torch.tensor(p.base, dtype=x.dtype,
                                           device=x.device))
        return [y]


@register
class Threshold(_Elementwise):
    """1 where x > threshold, else 0 (Caffe threshold_layer.cpp); no
    gradient flows through it."""

    type_name = "Threshold"

    def apply(self, params, bottoms, train):
        x = bottoms[0]
        return [(x > self.lp.threshold_param.threshold).to(x.dtype)]


@register
class Dropout(_Elementwise):
    """Inverted dropout (Caffe dropout_layer.cpp): TRAIN keeps each unit
    with probability 1 - ratio and scales the kept ones by 1/(1 - ratio);
    TEST is the identity. The mask is drawn from the torch.Generator the
    compiler hands the layer (``rng``); it cannot match the JAX package's
    bits, only their distribution."""

    type_name = "Dropout"
    needs_rng = True

    def apply(self, params, bottoms, train, rng=None):
        x = bottoms[0]
        if not train:
            return [x]
        if rng is None:
            raise ValueError(f"layer {self.lp.name!r}: a TRAIN-phase "
                             "dropout needs a generator")
        keep = 1.0 - float(self.lp.dropout_param.dropout_ratio)
        mask = torch.rand(x.shape, generator=rng, device=x.device) < keep
        return [torch.where(mask, x / keep, torch.zeros_like(x))]
