"""Shape/structure layers: Softmax, Concat, Flatten, Eltwise."""

import numpy as np
import torch

from ..graph.registry import Layer, register


@register
class Softmax(Layer):
    type_name = "Softmax"

    def __init__(self, lp, bottom_shapes, phase):
        super().__init__(lp, bottom_shapes, phase)
        self.axis = self.canonical_axis(lp.softmax_param.axis)

    def out_shapes(self):
        return [self.bottom_shapes[0]]

    def apply(self, params, bottoms, train):
        return [torch.softmax(bottoms[0], dim=self.axis)]


@register
class Concat(Layer):
    type_name = "Concat"

    def __init__(self, lp, bottom_shapes, phase):
        super().__init__(lp, bottom_shapes, phase)
        cp = lp.concat_param
        # legacy concat_dim honored when axis unset (concat_layer.cpp)
        axis = cp.axis if cp.has("axis") or not cp.has("concat_dim") \
            else cp.concat_dim
        self.axis = self.canonical_axis(int(axis))

    def out_shapes(self):
        shape = list(self.bottom_shapes[0])
        shape[self.axis] = sum(s[self.axis] for s in self.bottom_shapes)
        return [tuple(shape)]

    def apply(self, params, bottoms, train):
        return [torch.cat(bottoms, dim=self.axis)]


@register
class Flatten(Layer):
    type_name = "Flatten"

    def __init__(self, lp, bottom_shapes, phase):
        super().__init__(lp, bottom_shapes, phase)
        fp = lp.flatten_param
        self.axis = self.canonical_axis(fp.axis)
        self.end_axis = self.canonical_axis(fp.end_axis)

    def out_shapes(self):
        s = self.bottom_shapes[0]
        mid = int(np.prod(s[self.axis:self.end_axis + 1], dtype=np.int64))
        return [tuple(s[:self.axis]) + (mid,) + tuple(s[self.end_axis + 1:])]

    def apply(self, params, bottoms, train):
        return [bottoms[0].reshape(self.out_shapes()[0])]


@register
class Eltwise(Layer):
    """Caffe eltwise_layer.cpp: PROD, SUM with per-bottom coeff (default
    1), MAX."""

    type_name = "Eltwise"

    PROD, SUM, MAX = 0, 1, 2

    def __init__(self, lp, bottom_shapes, phase):
        super().__init__(lp, bottom_shapes, phase)
        ep = lp.eltwise_param
        self.op = int(ep.operation)
        coeff = list(ep.coeff)
        if coeff and len(coeff) != len(bottom_shapes):
            raise ValueError("eltwise coeff count must equal bottom count")
        self.coeff = coeff or [1.0] * len(bottom_shapes)

    def out_shapes(self):
        return [self.bottom_shapes[0]]

    def apply(self, params, bottoms, train):
        y = bottoms[0]
        if self.op == self.PROD:
            for b in bottoms[1:]:
                y = y * b
        elif self.op == self.SUM:
            # a coefficient of 1 is exact: skip the multiply
            terms = [b if c == 1.0 else c * b
                     for c, b in zip(self.coeff, bottoms)]
            y = terms[0]
            for t in terms[1:]:
                y = y + t
        else:
            for b in bottoms[1:]:
                y = torch.maximum(y, b)
        return [y]
