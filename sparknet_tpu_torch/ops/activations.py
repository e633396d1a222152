"""Neuron layers: ReLU and Dropout."""

import torch

from ..graph.registry import Layer, register


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
