"""Data-source layers as feeds (the port of sparknet_tpu/ops/feed.py).

The compiled net performs no IO: a data layer is a *feed* whose tops are
taken from the ``batch`` dict handed to ``CompiledNet.apply`` (the
serving engine builds that dict from request rows, the train verb from
the records of data/db_source.py). Net-level inputs of deploy prototxts
(``input:`` + ``input_shape``/``input_dim``) are feeds too; the compiler
handles them without a layer.

Shape resolution:
  JavaData     java_data_param.shape (one top, reference Layers.scala RDDLayer)
  MemoryData   memory_data_param dims; label top (batch,)
  DummyData    dummy_data_param shapes + fillers (generated in the forward)
  Data/ImageData/HDF5Data/WindowData  from the ``feed_shapes`` build argument
  (their on-disk sources are host-side concerns, see data/db_source.py)
"""

import torch

from ..graph import fillers as F
from ..graph.registry import Layer, register


class FeedLayer(Layer):
    """Tops come from the batch dict, keyed by top name."""

    is_feed = True

    def __init__(self, lp, bottom_shapes, phase, feed_shapes=None):
        super().__init__(lp, bottom_shapes, phase)
        self.feed_shapes = feed_shapes or {}

    def _external_shapes(self, batch_size_hint=None):
        shapes = []
        for top in self.lp.top:
            if top in self.feed_shapes:
                shapes.append(tuple(self.feed_shapes[top]))
            elif top == "label" and batch_size_hint:
                shapes.append((batch_size_hint,))
            else:
                raise ValueError(
                    f"data layer {self.lp.name!r}: provide feed_shapes[{top!r}] "
                    f"at build time (its source is host-side)")
        return shapes

    def apply(self, params, bottoms, train):
        raise RuntimeError("feed layers are resolved by the compiler")


@register
class JavaData(FeedLayer):
    """The DSL's RDDLayer: java_data_param.shape gives the first top's
    shape, trailing tops are (batch,) labels; ``feed_shapes`` overrides
    both at build time (the serving buckets)."""

    type_name = "JavaData"

    def out_shapes(self):
        p = self.lp.java_data_param
        shapes = []
        for i, top in enumerate(self.lp.top):
            if top in self.feed_shapes:
                shapes.append(tuple(self.feed_shapes[top]))
            elif i == 0 and p.has("shape"):
                shapes.append(tuple(int(d) for d in p.shape.dim))
            elif i > 0 and p.has("shape"):
                shapes.append((int(p.shape.dim[0]),))
            else:
                raise ValueError(
                    f"JavaData layer {self.lp.name!r}: no shape for top "
                    f"{top!r} (provide feed_shapes[{top!r}])")
        return shapes


class _SourceFeed(FeedLayer):
    """A layer whose tops come from a host-side source: shapes from
    ``feed_shapes``, a bare ``label`` top from its param's batch_size."""

    param_field = None

    def out_shapes(self):
        bs = int(getattr(self.lp, self.param_field).batch_size) \
            if self.lp.has(self.param_field) else None
        return self._external_shapes(batch_size_hint=bs)


@register
class Data(_SourceFeed):
    type_name = "Data"
    param_field = "data_param"


@register
class ImageData(_SourceFeed):
    type_name = "ImageData"
    param_field = "image_data_param"


@register
class WindowData(_SourceFeed):
    type_name = "WindowData"
    param_field = "window_data_param"


@register
class HDF5Data(_SourceFeed):
    type_name = "HDF5Data"
    param_field = "hdf5_data_param"


@register
class MemoryData(FeedLayer):
    type_name = "MemoryData"

    def out_shapes(self):
        p = self.lp.memory_data_param
        shape = (int(p.batch_size), int(p.channels), int(p.height),
                 int(p.width))
        outs = [shape]
        if len(self.lp.top) > 1:
            outs.append((int(p.batch_size),))
        return outs


@register
class DummyData(Layer):
    """Generates tops from fillers in the forward (dummy_data_layer.cpp).
    Random fillers draw from a CPU generator seeded from the layer's
    per-forward generator (seed 0 in a TEST forward, which gets none)."""

    type_name = "DummyData"
    needs_rng = True

    def __init__(self, lp, bottom_shapes, phase):
        super().__init__(lp, bottom_shapes, phase)
        p = lp.dummy_data_param
        if p.shape:
            self.shapes = [tuple(int(d) for d in s.dim) for s in p.shape]
        else:
            self.shapes = [(int(p.num[i]), int(p.channels[i]),
                            int(p.height[i]), int(p.width[i]))
                           for i in range(len(p.num))]
        n = len(self.shapes)
        fl = list(p.data_filler)
        if not fl:
            self.fillers = [None] * n
        elif len(fl) == 1:
            self.fillers = fl * n
        else:
            self.fillers = fl

    def out_shapes(self):
        return self.shapes

    def apply(self, params, bottoms, train, rng):
        seed = 0 if rng is None else int(torch.randint(
            0, 2 ** 62, (), generator=rng, device=rng.device))
        gen = torch.Generator().manual_seed(seed)
        return [F.fill(gen, s, f).to(self.device)
                for s, f in zip(self.shapes, self.fillers)]


@register
class HDF5Output(Layer):
    """Sink layer with no tops (reference hdf5_output_layer.cpp wrote its
    bottoms to disk). In the compiled graph it computes nothing; the
    extract_features verb writes blobs instead."""

    type_name = "HDF5Output"

    def out_shapes(self):
        return []

    def apply(self, params, bottoms, train):
        return []
