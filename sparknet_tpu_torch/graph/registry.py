"""Layer registry: proto ``type`` string -> layer implementation class.

The analog of Caffe's string-keyed layer factory (layer_factory.cpp
REGISTER_LAYER_CLASS). A layer implementation is a small Python class
whose ``apply`` runs PyTorch ops on tensors, differentiable by autograd;
the kernels the port writes by hand (ops/cuda_lrn.py,
ops/cuda_epilogue.py) sit behind autograd-aware wrapper functions that
the layers and the compiler call.
"""

_REGISTRY = {}

# V1 (legacy) layer-type enum name -> V2 type string, for upgrading old nets
# (Caffe util/upgrade_proto.cpp UpgradeV1LayerType).
V1_TYPE_MAP = {
    "ABSVAL": "AbsVal", "ACCURACY": "Accuracy", "ARGMAX": "ArgMax",
    "BNLL": "BNLL", "CONCAT": "Concat", "CONTRASTIVE_LOSS": "ContrastiveLoss",
    "CONVOLUTION": "Convolution", "DATA": "Data",
    "DECONVOLUTION": "Deconvolution", "DROPOUT": "Dropout",
    "DUMMY_DATA": "DummyData", "EUCLIDEAN_LOSS": "EuclideanLoss",
    "ELTWISE": "Eltwise", "EXP": "Exp", "FLATTEN": "Flatten",
    "HDF5_DATA": "HDF5Data", "HDF5_OUTPUT": "HDF5Output",
    "HINGE_LOSS": "HingeLoss", "IM2COL": "Im2col", "IMAGE_DATA": "ImageData",
    "INFOGAIN_LOSS": "InfogainLoss", "INNER_PRODUCT": "InnerProduct",
    "LRN": "LRN", "MEMORY_DATA": "MemoryData",
    "MULTINOMIAL_LOGISTIC_LOSS": "MultinomialLogisticLoss", "MVN": "MVN",
    "POOLING": "Pooling", "POWER": "Power", "RELU": "ReLU",
    "SIGMOID": "Sigmoid", "SIGMOID_CROSS_ENTROPY_LOSS": "SigmoidCrossEntropyLoss",
    "SILENCE": "Silence", "SOFTMAX": "Softmax", "SOFTMAX_LOSS": "SoftmaxWithLoss",
    "SPLIT": "Split", "SLICE": "Slice", "TANH": "TanH",
    "WINDOW_DATA": "WindowData", "THRESHOLD": "Threshold",
}


def register(cls):
    """Class decorator: register under ``cls.type_name`` (str or tuple)."""
    names = cls.type_name
    if isinstance(names, str):
        names = (names,)
    for n in names:
        if n in _REGISTRY:
            raise ValueError(f"duplicate layer type {n}")
        _REGISTRY[n] = cls
    return cls


def get(type_name):
    try:
        return _REGISTRY[type_name]
    except KeyError:
        raise KeyError(
            f"unknown layer type {type_name!r}; registered: "
            f"{sorted(_REGISTRY)}") from None


def known(type_name):
    return type_name in _REGISTRY


class Layer:
    """Base layer implementation.

    One instance per layer in a compiled net, created at build time with the
    layer's proto (``lp``, a LayerParameter Message) and the inferred bottom
    shapes.

      param_shapes() -> [(shape, filler Message|None, lr_mult, decay_mult)]
      state_shapes() -> [(shape, init_value)]       # non-learnable (e.g. BN)
      apply(params, bottoms, train) -> [tops]       # tensors in, tensors out
      apply_stateful(params, state, bottoms, train)  # has_state layers,
          -> ([tops], new_state)                     # in place of apply

    ``loss_like`` marks layers whose top[0] joins the objective with default
    loss_weight 1 (Caffe: any *Loss layer). ``needs_rng`` layers take a
    fourth argument, ``rng``: a torch.Generator of their own per forward.
    """

    type_name = None
    loss_like = False
    has_state = False
    needs_rng = False

    def __init__(self, lp, bottom_shapes, phase):
        self.lp = lp
        self.bottom_shapes = [tuple(s) for s in bottom_shapes]
        self.phase = phase  # 0 TRAIN, 1 TEST

    def param_shapes(self):
        return []

    def state_shapes(self):
        return []

    def out_shapes(self):
        raise NotImplementedError

    def apply(self, params, bottoms, train):
        raise NotImplementedError

    # -- helpers -----------------------------------------------------------
    def canonical_axis(self, axis, ndim=None):
        ndim = ndim if ndim is not None else len(self.bottom_shapes[0])
        return axis + ndim if axis < 0 else axis
