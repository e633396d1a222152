"""InnerProduct (Caffe inner_product_layer.cpp): bottom flattened from
``axis`` onward, weight blob (num_output, K), y = x @ W^T + b. Embed
(embed_layer.cpp): index -> row gather from a (input_dim, num_output)
table. PositionalEmbed: a learned (max_positions, E) table added to a
(B, S, E) activation."""

import numpy as np

from ..graph.registry import Layer, register
from .convolution import _param_mults


@register
class InnerProduct(Layer):
    type_name = "InnerProduct"

    def __init__(self, lp, bottom_shapes, phase):
        super().__init__(lp, bottom_shapes, phase)
        p = lp.inner_product_param
        self.p = p
        self.num_output = int(p.num_output)
        self.bias_term = bool(p.bias_term)
        self.axis = self.canonical_axis(p.axis)
        shape = bottom_shapes[0]
        self.outer = int(np.prod(shape[:self.axis], dtype=np.int64))
        self.K = int(np.prod(shape[self.axis:], dtype=np.int64))

    def param_shapes(self):
        mults = _param_mults(self.lp, 2 if self.bias_term else 1)
        out = [((self.num_output, self.K), self.p.weight_filler, *mults[0])]
        if self.bias_term:
            out.append(((self.num_output,), self.p.bias_filler, *mults[1]))
        return out

    def out_shapes(self):
        return [tuple(self.bottom_shapes[0][:self.axis]) + (self.num_output,)]

    def apply(self, params, bottoms, train):
        x = bottoms[0]
        y = x.reshape(self.outer, self.K) @ params[0].to(x.dtype).T
        if self.bias_term:
            y = y + params[1].to(x.dtype)
        return [y.reshape(self.out_shapes()[0])]


@register
class Embed(Layer):
    type_name = "Embed"

    def __init__(self, lp, bottom_shapes, phase):
        super().__init__(lp, bottom_shapes, phase)
        p = lp.embed_param
        self.p = p
        self.num_output = int(p.num_output)
        self.input_dim = int(p.input_dim)
        self.bias_term = bool(p.bias_term)

    def param_shapes(self):
        mults = _param_mults(self.lp, 2 if self.bias_term else 1)
        out = [((self.input_dim, self.num_output), self.p.weight_filler,
                *mults[0])]
        if self.bias_term:
            out.append(((self.num_output,), self.p.bias_filler, *mults[1]))
        return out

    def out_shapes(self):
        return [tuple(self.bottom_shapes[0]) + (self.num_output,)]

    def apply(self, params, bottoms, train):
        y = params[0][bottoms[0].long()]
        if self.bias_term:
            y = y + params[1]
        cd = getattr(self, "compute_dtype", None)
        if cd is not None:
            # activations are born here from params alone: this cast puts
            # the whole downstream net in compute_dtype while the table
            # stays an f32 master
            y = y.to(cd)
        return [y]


@register
class PositionalEmbed(Layer):
    """Adds rows [0, S) of a learned (max_positions, E) table to a (B, S,
    E) activation. embed_param: input_dim = max positions (>= S),
    num_output = E. Under a "seq" axis (parallel/context.py) a slot's
    shard holds global positions [i*S, (i+1)*S), i its seq index, and
    adds those rows."""

    type_name = "PositionalEmbed"

    def __init__(self, lp, bottom_shapes, phase):
        super().__init__(lp, bottom_shapes, phase)
        p = lp.embed_param
        self.p = p
        b, s, e = bottom_shapes[0]
        self.max_positions = int(p.input_dim)
        if self.max_positions < s:
            raise ValueError(
                f"{lp.name}: embed_param.input_dim {self.max_positions} < "
                f"sequence length {s}")
        if int(p.num_output) != e:
            raise ValueError(
                f"{lp.name}: embed_param.num_output {p.num_output} != "
                f"embedding dim {e}")
        self.dim = int(e)

    def param_shapes(self):
        mults = _param_mults(self.lp, 1)
        return [((self.max_positions, self.dim), self.p.weight_filler,
                 *mults[0])]

    def out_shapes(self):
        return [tuple(self.bottom_shapes[0])]

    def apply(self, params, bottoms, train):
        from ..parallel import context
        x = bottoms[0]
        s = x.shape[1]
        start = context.axis_index("seq") * s
        return [x + params[0][start:start + s].to(x.dtype)[None]]
