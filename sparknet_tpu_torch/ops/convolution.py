"""Convolution, Deconvolution and Im2col (the port of
sparknet_tpu/ops/convolution.py) as ``torch.nn.functional`` calls.

Shape/param semantics match Caffe's conv_layer.cpp / base_conv_layer.cpp:
  out = (in + 2*pad - kernel) / stride + 1      (floor)
  weight blob (num_output, C/group, kh, kw), bias blob (num_output,)
Grouped convolution (AlexNet conv2/4/5) maps to ``groups``. The layout
stays NCHW; whether channels-last pays on the card is for a measurement
to decide.

Deconvolution (deconv_layer.cpp) is ``conv_transpose2d``: Caffe's weight
blob (C_in, num_output/group, kh, kw) is its (in, out/groups, kh, kw)
layout as it stands, so no flip is needed (the JAX layer flips because it
builds the forward convolution whose gradient this is), and out = stride
* (in - 1) + kernel - 2*pad. Im2col (im2col_layer.cpp) is ``unfold``:
channel-major columns, c*kh*kw + i*kw + j, the order of
``lax.conv_general_dilated_patches``.
"""

import torch.nn.functional as F

from ..graph.registry import Layer, register


def _pair(rep_field, h_field, w_field, lp_param, default):
    """Resolve Caffe's (repeated | _h/_w) spatial-param convention."""
    rep = list(rep_field)
    if lp_param.has(h_field) or lp_param.has(w_field):
        return int(getattr(lp_param, h_field)), int(getattr(lp_param, w_field))
    if len(rep) == 0:
        return default, default
    if len(rep) == 1:
        return int(rep[0]), int(rep[0])
    return int(rep[0]), int(rep[1])


def resolve_conv_geometry(cp):
    kh, kw = _pair(cp.kernel_size, "kernel_h", "kernel_w", cp, None)
    if kh is None:
        raise ValueError("convolution requires kernel_size")
    sh, sw = _pair(cp.stride, "stride_h", "stride_w", cp, 1)
    ph, pw = _pair(cp.pad, "pad_h", "pad_w", cp, 0)
    return (kh, kw), (sh, sw), (ph, pw)


def _param_mults(lp, n_blobs):
    """Per-blob (lr_mult, decay_mult) from the layer's ParamSpecs
    (Caffe net.cpp AppendParam; missing specs default to 1/1)."""
    out = []
    for i in range(n_blobs):
        if i < len(lp.param):
            out.append((lp.param[i].lr_mult, lp.param[i].decay_mult))
        else:
            out.append((1.0, 1.0))
    return out


@register
class Convolution(Layer):
    type_name = "Convolution"

    def __init__(self, lp, bottom_shapes, phase):
        super().__init__(lp, bottom_shapes, phase)
        cp = lp.convolution_param
        self.cp = cp
        (self.kh, self.kw), (self.sh, self.sw), (self.ph, self.pw) = \
            resolve_conv_geometry(cp)
        self.group = int(cp.group)
        self.num_output = int(cp.num_output)
        self.bias_term = bool(cp.bias_term)
        n, c, h, w = bottom_shapes[0]
        if c % self.group or self.num_output % self.group:
            raise ValueError("channels must divide group")
        self.weight_shape = (self.num_output, c // self.group, self.kh, self.kw)

    def param_shapes(self):
        mults = _param_mults(self.lp, 2 if self.bias_term else 1)
        out = [(self.weight_shape, self.cp.weight_filler, *mults[0])]
        if self.bias_term:
            out.append(((self.num_output,), self.cp.bias_filler, *mults[1]))
        return out

    def out_shapes(self):
        n, c, h, w = self.bottom_shapes[0]
        oh = (h + 2 * self.ph - self.kh) // self.sh + 1
        ow = (w + 2 * self.pw - self.kw) // self.sw + 1
        return [(n, self.num_output, oh, ow)]

    def apply_raw(self, params, bottoms, train):
        """The convolution WITHOUT its bias add, NCHW out. The fused-
        epilogue path (graph/compiler.py + ops/cuda_epilogue.py) calls
        this and applies bias+ReLU(+LRN) in one kernel pass."""
        x = bottoms[0]
        return F.conv2d(x, params[0].to(x.dtype), None,
                        stride=(self.sh, self.sw),
                        padding=(self.ph, self.pw), groups=self.group)

    def apply(self, params, bottoms, train):
        x = bottoms[0]
        b = params[1].to(x.dtype) if self.bias_term else None
        return [F.conv2d(x, params[0].to(x.dtype), b,
                         stride=(self.sh, self.sw),
                         padding=(self.ph, self.pw), groups=self.group)]

    def apply_fissioned(self, params, branches, train):
        """The conv over a virtual concat (graph/fission.py): one partial
        conv per branch on the matching input-channel slice of the same
        weight blob, summed left to right; the bias is added once.
        group == 1 only."""
        w = params[0]
        y = None
        off = 0
        for x in branches.parts:
            c = x.shape[1]
            yi = F.conv2d(x, w[:, off:off + c].to(x.dtype), None,
                          stride=(self.sh, self.sw),
                          padding=(self.ph, self.pw))
            off += c
            y = yi if y is None else y + yi
        if self.bias_term:
            y = y + params[1].to(y.dtype)[None, :, None, None]
        return y


@register
class Deconvolution(Layer):
    type_name = "Deconvolution"

    def __init__(self, lp, bottom_shapes, phase):
        super().__init__(lp, bottom_shapes, phase)
        cp = lp.convolution_param
        self.cp = cp
        (self.kh, self.kw), (self.sh, self.sw), (self.ph, self.pw) = \
            resolve_conv_geometry(cp)
        self.group = int(cp.group)
        self.num_output = int(cp.num_output)
        self.bias_term = bool(cp.bias_term)
        n, c, h, w = bottom_shapes[0]
        if c % self.group or self.num_output % self.group:
            raise ValueError("channels must divide group")
        self.weight_shape = (c, self.num_output // self.group, self.kh,
                             self.kw)

    def param_shapes(self):
        mults = _param_mults(self.lp, 2 if self.bias_term else 1)
        out = [(self.weight_shape, self.cp.weight_filler, *mults[0])]
        if self.bias_term:
            out.append(((self.num_output,), self.cp.bias_filler, *mults[1]))
        return out

    def out_shapes(self):
        n, c, h, w = self.bottom_shapes[0]
        oh = self.sh * (h - 1) + self.kh - 2 * self.ph
        ow = self.sw * (w - 1) + self.kw - 2 * self.pw
        return [(n, self.num_output, oh, ow)]

    def apply(self, params, bottoms, train):
        x = bottoms[0]
        b = params[1].to(x.dtype) if self.bias_term else None
        return [F.conv_transpose2d(x, params[0].to(x.dtype), b,
                                   stride=(self.sh, self.sw),
                                   padding=(self.ph, self.pw),
                                   groups=self.group)]


@register
class Im2col(Layer):
    type_name = "Im2col"

    def __init__(self, lp, bottom_shapes, phase):
        super().__init__(lp, bottom_shapes, phase)
        (self.kh, self.kw), (self.sh, self.sw), (self.ph, self.pw) = \
            resolve_conv_geometry(lp.convolution_param)

    def out_shapes(self):
        n, c, h, w = self.bottom_shapes[0]
        oh = (h + 2 * self.ph - self.kh) // self.sh + 1
        ow = (w + 2 * self.pw - self.kw) // self.sw + 1
        return [(n, c * self.kh * self.kw, oh, ow)]

    def apply(self, params, bottoms, train):
        cols = F.unfold(bottoms[0], (self.kh, self.kw),
                        padding=(self.ph, self.pw),
                        stride=(self.sh, self.sw))
        return [cols.reshape(self.out_shapes()[0])]
