"""User-defined layers: the ``type: "Python"`` escape hatch (the port of
sparknet_tpu/ops/python_layer.py; Caffe layer_factory.cpp GetPythonLayer
and include/caffe/python_layer.hpp). A prototxt layer

    layer {
      type: 'Python'
      python_param { module: 'mylayers'  layer: 'MyLayer'
                     param_str: '{"k": 3}' }
    }

imports ``module`` (which must be importable: on PYTHONPATH / sys.path,
or on the colon-separated SPARKNET_PYTHON_LAYER_PATH), instantiates class
``layer`` and drives it through the net build without touching the
framework. As in Caffe, a Python layer is NOT a loss layer by its type;
give it an explicit ``loss_weight``.

The interface is the JAX package's: shape inference plus one pure
forward, in place of Caffe's four hooks that mutate blobs:

    class MyLayer:
        def setup(self, bottom_shapes):           # optional; param_str,
            ...                                   # phase, name already set
        def reshape(self, bottom_shapes):         # required
            return [top_shape, ...]               # (a tuple = ONE shape)
        def forward(self, params, bottoms):       # required
            return [tops]                         # (or one tensor)
        def param_shapes(self):                   # optional learnable
            return [(shape, filler_msg_or_dict_or_None, lr_mult,
                     decay_mult)]

Here ``forward`` takes and returns torch tensors, and autograd
differentiates it: there is no ``backward`` (Caffe made users write
Backward_cpu against mutable diff blobs). It may take a third ``train``
argument to tell the phases apart. A user module written with ``jnp``
runs only in the JAX package; the port calls the same hooks with
tensors. Registering a layer under its own type string is public API
too:

    from sparknet_tpu_torch import Layer, register_layer

    @register_layer
    class MyOp(Layer):
        type_name = "MyOp"
        ...
"""

import importlib
import inspect
import os
import sys

from ..graph.registry import Layer, register
from ..proto import Message


def _load_user_class(module_name, class_name):
    extra = [p for p in
             os.environ.get("SPARKNET_PYTHON_LAYER_PATH", "").split(":")
             if p]
    added = [p for p in extra if p not in sys.path]
    sys.path[:0] = added
    try:
        try:
            mod = importlib.import_module(module_name)
        except ImportError as e:
            raise ImportError(
                f"python_param.module {module_name!r} not importable "
                f"({e}); put it on PYTHONPATH or "
                f"SPARKNET_PYTHON_LAYER_PATH") from e
    finally:
        for p in added:
            sys.path.remove(p)
    try:
        return getattr(mod, class_name)
    except AttributeError:
        raise AttributeError(
            f"module {module_name!r} has no class "
            f"{class_name!r} (python_param.layer)") from None


@register
class PythonLayer(Layer):
    type_name = "Python"

    def __init__(self, lp, bottom_shapes, phase):
        super().__init__(lp, bottom_shapes, phase)
        pp = lp.python_param
        if not pp.module or not pp.layer:
            raise ValueError(
                f"{lp.name}: python_param needs module and layer")
        obj = _load_user_class(pp.module, pp.layer)()
        # python_layer.hpp LayerSetUp: param_str is set on the instance
        # before setup() runs; phase and name come with it
        obj.param_str = pp.param_str
        obj.phase = phase
        obj.name = lp.name
        if hasattr(obj, "setup"):
            obj.setup(self.bottom_shapes)
        if not hasattr(obj, "reshape") or not hasattr(obj, "forward"):
            raise TypeError(
                f"{lp.name}: {pp.module}.{pp.layer} must define "
                "reshape(bottom_shapes) and forward(params, bottoms)")
        tops = obj.reshape(self.bottom_shapes)
        if isinstance(tops, tuple):                # one bare shape tuple
            tops = [tops]
        self._top_shapes = [tuple(s) for s in tops]
        want, got = len(lp.top), len(self._top_shapes)
        if want != got:
            raise ValueError(
                f"{lp.name}: reshape() returned {got} top shape(s) for "
                f"{want} declared top(s)")
        self._obj = obj
        self._fwd_takes_train = \
            len(inspect.signature(obj.forward).parameters) >= 3

    def param_shapes(self):
        if not hasattr(self._obj, "param_shapes"):
            return []
        out = []
        for shape, filler, lr, decay in self._obj.param_shapes():
            if isinstance(filler, dict):       # plain-dict convenience
                filler = Message("FillerParameter", **filler)
            out.append((tuple(shape), filler, lr, decay))
        return out

    def out_shapes(self):
        return self._top_shapes

    def apply(self, params, bottoms, train):
        if self._fwd_takes_train:
            out = self._obj.forward(params, bottoms, train)
        else:
            out = self._obj.forward(params, bottoms)
        if not isinstance(out, (list, tuple)):
            out = [out]
        return list(out)
