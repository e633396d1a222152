"""Shape and structure layers: the port of sparknet_tpu/ops/structural.py
(Caffe's Softmax, Concat, Slice, Split, Flatten, Reshape, Eltwise, Tile,
ArgMax, Reduction, Silence, BatchReindex and Filter). Views, gathers and
reductions on tensors; autograd differentiates them.
"""

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


@register
class Slice(Layer):
    """Caffe slice_layer.cpp: split one axis at ``slice_point`` (or into
    equal parts, one per top); the legacy ``slice_dim`` holds when
    ``axis`` is unset."""

    type_name = "Slice"

    def __init__(self, lp, bottom_shapes, phase):
        super().__init__(lp, bottom_shapes, phase)
        sp = lp.slice_param
        axis = sp.axis if sp.has("axis") or not sp.has("slice_dim") \
            else sp.slice_dim
        self.axis = self.canonical_axis(int(axis))
        self.n_tops = len(lp.top)
        dim = bottom_shapes[0][self.axis]
        points = [int(p) for p in sp.slice_point]
        if points:
            if len(points) != self.n_tops - 1:
                raise ValueError(f"{lp.name}: {len(points)} slice points "
                                 f"for {self.n_tops} tops")
            self.bounds = [0] + points + [dim]
        else:
            if dim % self.n_tops:
                raise ValueError(f"{lp.name}: axis size {dim} does not "
                                 f"split into {self.n_tops} equal parts")
            self.bounds = list(range(0, dim + 1, dim // self.n_tops))

    def out_shapes(self):
        outs = []
        for lo, hi in zip(self.bounds, self.bounds[1:]):
            s = list(self.bottom_shapes[0])
            s[self.axis] = hi - lo
            outs.append(tuple(s))
        return outs

    def apply(self, params, bottoms, train):
        return [bottoms[0].narrow(self.axis, lo, hi - lo)
                for lo, hi in zip(self.bounds, self.bounds[1:])]


@register
class Split(Layer):
    """Fan one blob out to several tops. Caffe inserts these to sum the
    gradients of a fan-out (util/insert_splits.cpp); autograd sums them
    by itself, so each top is the bottom."""

    type_name = "Split"

    def out_shapes(self):
        return [self.bottom_shapes[0]] * max(1, len(self.lp.top))

    def apply(self, params, bottoms, train):
        return [bottoms[0]] * max(1, len(self.lp.top))


@register
class Reshape(Layer):
    """Caffe reshape_layer.cpp: dim 0 copies the bottom's dim, one dim may
    be -1 (inferred); ``axis`` and ``num_axes`` bound the span replaced."""

    type_name = "Reshape"

    def __init__(self, lp, bottom_shapes, phase):
        super().__init__(lp, bottom_shapes, phase)
        rp = lp.reshape_param
        bshape = list(bottom_shapes[0])
        nd = len(bshape)
        axis = rp.axis + nd + 1 if rp.axis < 0 else rp.axis
        end = nd if rp.num_axes == -1 else axis + rp.num_axes
        spec = [int(d) for d in rp.shape.dim] if rp.has("shape") else []
        replaced = bshape[axis:end]
        mid, infer = [], -1
        for i, d in enumerate(spec):
            if d == 0:
                mid.append(replaced[i])
            elif d == -1:
                infer = i
                mid.append(1)
            else:
                mid.append(d)
        total = int(np.prod(bshape, dtype=np.int64))
        if infer >= 0:
            fixed = int(np.prod(bshape[:axis] + mid + bshape[end:],
                                dtype=np.int64))
            mid[infer] = total // fixed
        self.new_shape = tuple(bshape[:axis] + mid + bshape[end:])
        if int(np.prod(self.new_shape, dtype=np.int64)) != total:
            raise ValueError(f"{lp.name}: reshape count mismatch "
                             f"{tuple(bshape)} -> {self.new_shape}")

    def out_shapes(self):
        return [self.new_shape]

    def apply(self, params, bottoms, train):
        return [bottoms[0].reshape(self.new_shape)]


@register
class Tile(Layer):
    """Caffe tile_layer.cpp: ``tiles`` copies of the bottom along ``axis``."""

    type_name = "Tile"

    def __init__(self, lp, bottom_shapes, phase):
        super().__init__(lp, bottom_shapes, phase)
        tp = lp.tile_param
        self.axis = self.canonical_axis(tp.axis)
        self.tiles = int(tp.tiles)

    def out_shapes(self):
        s = list(self.bottom_shapes[0])
        s[self.axis] *= self.tiles
        return [tuple(s)]

    def apply(self, params, bottoms, train):
        reps = [1] * bottoms[0].dim()
        reps[self.axis] = self.tiles
        return [bottoms[0].repeat(reps)]


@register
class ArgMax(Layer):
    """Caffe argmax_layer.cpp: the ``top_k`` largest along ``axis`` (their
    indices, or with ``out_max_val`` their values); without ``axis``, over
    each item's flattened values as (N, 1, k) indices or (N, 2, k)
    [indices; values]. Indices are returned in the input's dtype."""

    type_name = "ArgMax"

    def __init__(self, lp, bottom_shapes, phase):
        super().__init__(lp, bottom_shapes, phase)
        ap = lp.argmax_param
        self.out_max_val = bool(ap.out_max_val)
        self.top_k = int(ap.top_k)
        self.axis = self.canonical_axis(ap.axis) if ap.has("axis") else None

    def out_shapes(self):
        s = self.bottom_shapes[0]
        if self.axis is not None:
            out = list(s)
            out[self.axis] = self.top_k
            return [tuple(out)]
        return [(s[0], 2 if self.out_max_val else 1, self.top_k)]

    def apply(self, params, bottoms, train):
        x = bottoms[0]
        if self.axis is not None:
            vals, idx = torch.topk(x, self.top_k, dim=self.axis)
            return [vals if self.out_max_val else idx.to(x.dtype)]
        vals, idx = torch.topk(x.reshape(x.shape[0], -1), self.top_k, dim=1)
        idxf = idx.to(x.dtype)
        if self.out_max_val:
            return [torch.stack([idxf, vals], dim=1)]
        return [idxf[:, None, :]]


@register
class Reduction(Layer):
    """Caffe reduction_layer.cpp: SUM, ASUM, SUMSQ or MEAN over every axis
    from ``axis`` on, times ``coeff``."""

    type_name = "Reduction"

    SUM, ASUM, SUMSQ, MEAN = 1, 2, 3, 4

    def __init__(self, lp, bottom_shapes, phase):
        super().__init__(lp, bottom_shapes, phase)
        rp = lp.reduction_param
        self.op = int(rp.operation)
        self.axis = self.canonical_axis(rp.axis)
        self.coeff = float(rp.coeff)

    def out_shapes(self):
        return [tuple(self.bottom_shapes[0][:self.axis])]

    def apply(self, params, bottoms, train):
        x = bottoms[0]
        dims = tuple(range(self.axis, x.dim()))
        if self.op == self.SUM:
            y = x.sum(dim=dims)
        elif self.op == self.ASUM:
            y = x.abs().sum(dim=dims)
        elif self.op == self.SUMSQ:
            y = (x * x).sum(dim=dims)
        else:
            y = x.mean(dim=dims)
        return [y * self.coeff]


@register
class Silence(Layer):
    """Takes its bottoms and produces nothing (Caffe silence_layer.cpp)."""

    type_name = "Silence"

    def out_shapes(self):
        return []

    def apply(self, params, bottoms, train):
        return []


@register
class BatchReindex(Layer):
    """bottom[0]'s items gathered by the index blob bottom[1], whose
    values are truncated to integers (Caffe batch_reindex_layer.cpp)."""

    type_name = "BatchReindex"

    def out_shapes(self):
        return [tuple(self.bottom_shapes[1][:1]) +
                tuple(self.bottom_shapes[0][1:])]

    def apply(self, params, bottoms, train):
        return [bottoms[0].index_select(0, bottoms[1].long())]


@register
class Filter(Layer):
    """Selects the batch items whose selector is nonzero (Caffe
    filter_layer.cpp), with the JAX package's CAPACITY-PADDED semantics,
    a deliberate departure from Caffe.

    bottom[0..k-1] are the blobs to filter; bottom[k] is the selector, of
    shape (N,) or (N, 1, ...). Caffe shrinks each top's batch to the
    count selected, a shape that depends on the data. Here, as in the JAX
    package, each top keeps the FULL batch N: the selected items are
    compacted to the front in their order (Caffe's indices_to_forward_
    order) and the rows after them are zero. An optional extra top
    (declare k+1 tops) takes the count selected, an int32 scalar, so that
    consumers can mask. The gradient (autograd of the gather) flows to
    the selected rows and is zero elsewhere, as filter_layer.cpp's
    Backward_cpu gives it."""

    type_name = "Filter"

    def __init__(self, lp, bottom_shapes, phase):
        super().__init__(lp, bottom_shapes, phase)
        sel = bottom_shapes[-1]
        if any(d != 1 for d in sel[1:]):
            raise ValueError(
                f"{lp.name}: selector dims past the first must be "
                f"singletons, got {tuple(sel)}")
        n = sel[0]
        for i, s in enumerate(bottom_shapes[:-1]):
            if s[0] != n:
                raise ValueError(
                    f"{lp.name}: bottom {i} batch {s[0]} != selector "
                    f"batch {n}")
        ndata = len(bottom_shapes) - 1
        if len(lp.top) not in (ndata, ndata + 1):
            raise ValueError(
                f"{lp.name}: Filter needs {ndata} tops (or {ndata + 1} "
                f"with the valid-count top), got {len(lp.top)}")
        self._with_count = len(lp.top) == ndata + 1

    def out_shapes(self):
        shapes = [tuple(s) for s in self.bottom_shapes[:-1]]
        if self._with_count:
            shapes.append(())
        return shapes

    def apply(self, params, bottoms, train):
        keep = bottoms[-1].reshape(bottoms[-1].shape[0]) != 0
        n = keep.shape[0]
        # stable compaction: the selected rows first, in their order
        order = torch.argsort((~keep).to(torch.int8), stable=True)
        kmask = keep[order]
        tops = [x[order] * kmask.reshape((n,) + (1,) * (x.dim() - 1))
                .to(x.dtype) for x in bottoms[:-1]]
        if self._with_count:
            tops.append(keep.sum(dtype=torch.int32))
        return tops
