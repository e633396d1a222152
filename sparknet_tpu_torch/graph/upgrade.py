"""Legacy NetParameter upgrades — V0 "layer connections" and deprecated
data-layer transform fields.

Re-derives Caffe's util/upgrade_proto.cpp:
  UpgradeV0PaddingLayers (:120)  fold standalone "padding" layers into the
                                 conv/pool consumer's pad field
  UpgradeV0LayerParameter (:179) per-field mapping of the flat
                                 V0LayerParameter into typed V1 params
  UpgradeV0LayerType (:531)      lowercase type strings -> V1 enum
  NetNeedsDataUpgrade (:586)     deprecated DataParameter-level
                                 scale/mean_file/crop_size/mirror ->
                                 TransformationParameter

The V1 -> V2 step lives in compiler.upgrade_v1; `upgrade_net` chains all
three so any vintage of prototxt/caffemodel loads.
"""

from ..proto.message import Message

# UpgradeV0LayerType (upgrade_proto.cpp:531-584)
V0_TYPE_MAP = {
    "accuracy": "ACCURACY", "bnll": "BNLL", "concat": "CONCAT",
    "conv": "CONVOLUTION", "data": "DATA", "dropout": "DROPOUT",
    "euclidean_loss": "EUCLIDEAN_LOSS", "flatten": "FLATTEN",
    "hdf5_data": "HDF5_DATA", "hdf5_output": "HDF5_OUTPUT",
    "im2col": "IM2COL", "images": "IMAGE_DATA",
    "infogain_loss": "INFOGAIN_LOSS", "innerproduct": "INNER_PRODUCT",
    "lrn": "LRN", "multinomial_logistic_loss": "MULTINOMIAL_LOGISTIC_LOSS",
    "pool": "POOLING", "relu": "RELU", "sigmoid": "SIGMOID",
    "softmax": "SOFTMAX", "softmax_loss": "SOFTMAX_LOSS", "split": "SPLIT",
    "tanh": "TANH", "window_data": "WINDOW_DATA",
}

# V0 field -> (allowed type -> (v1 sub-message, v1 field)). "add" marks
# repeated targets (conv pad/kernel_size/stride became repeated in V2, but
# in V1 they are scalar; we upgrade straight to the V1 scalar fields).
_POOL_ENUM = {0: "MAX", 1: "AVE", 2: "STOCHASTIC"}


def needs_v0_upgrade(net_param):
    """True when any legacy `layers` entry carries a V0 payload
    (upgrade_proto.cpp NetNeedsV0ToV1Upgrade)."""
    return any(v1.has("layer") for v1 in net_param.layers)


def upgrade_v0(net_param):
    """V0 net -> V1 net (upgrade_proto.cpp UpgradeV0Net :93). Returns a new
    NetParameter whose `layers` entries use typed V1 params; raises on
    fields the reference flagged as not-fully-compatible."""
    fused = _fuse_padding_layers(net_param)
    out = net_param.copy()
    out.clear("layers")
    for conn in fused.layers:
        out.layers.append(_upgrade_v0_layer(conn))
    return out


def _fuse_padding_layers(net_param):
    """UpgradeV0PaddingLayers (:120): drop "padding" layers, push their pad
    into the following conv/pool layer and rewire its bottom."""
    out = net_param.copy()
    out.clear("layers")
    last_top = {name: -1 for name in net_param.input}
    layers = list(net_param.layers)
    for i, conn in enumerate(layers):
        v0 = conn.layer
        if v0.type != "padding":
            out.layers.append(conn.copy())
        for j, bname in enumerate(conn.bottom):
            if bname not in last_top:
                raise ValueError(f"unknown blob input {bname} to layer {i}")
            src_idx = last_top[bname]
            if src_idx < 0:
                continue
            src = layers[src_idx]
            if src.layer.type == "padding":
                if v0.type not in ("conv", "pool"):
                    raise ValueError(
                        f"padding layer feeds non-conv/pool layer "
                        f"{v0.type!r} (undefined in Caffe)")
                if len(conn.bottom) != 1 or len(src.bottom) != 1 \
                        or len(src.top) != 1:
                    raise ValueError("padding fusion requires single-"
                                     "input/single-output layers")
                tgt = out.layers[-1]
                tgt.layer.pad = src.layer.pad
                tgt.bottom[j] = src.bottom[0]
        for bname in conn.top:
            last_top[bname] = i
    return out


def _upgrade_v0_layer(conn):
    """UpgradeV0LayerParameter (:179): one V0 layer connection -> V1."""
    v0 = conn.layer
    t = v0.type if v0.has("type") else None
    v1 = Message("V1LayerParameter")
    v1.bottom.extend(conn.bottom)
    v1.top.extend(conn.top)
    if v0.has("name"):
        v1.name = v0.name
    if t is not None:
        if t not in V0_TYPE_MAP:
            raise ValueError(f"unknown V0 layer type {t!r}")
        v1.type = V0_TYPE_MAP[t]
    for b in v0.blobs:
        v1.blobs.append(b.copy())
    v1.blobs_lr.extend(v0.blobs_lr)
    v1.weight_decay.extend(v0.weight_decay)

    def sub(name):
        if not v1.has(name):
            setattr(v1, name, Message({
                "convolution_param": "ConvolutionParameter",
                "inner_product_param": "InnerProductParameter",
                "pooling_param": "PoolingParameter",
                "dropout_param": "DropoutParameter",
                "lrn_param": "LRNParameter",
                "data_param": "DataParameter",
                "hdf5_data_param": "HDF5DataParameter",
                "image_data_param": "ImageDataParameter",
                "window_data_param": "WindowDataParameter",
                "infogain_loss_param": "InfogainLossParameter",
                "concat_param": "ConcatParameter",
                "transform_param": "TransformationParameter",
            }[name]))
        return getattr(v1, name)

    def route(field, table, setter=None):
        if not v0.has(field):
            return
        if t not in table:
            raise ValueError(
                f"unknown parameter {field} for layer type {t!r}")
        pname, attr = table[t]
        target = sub(pname)
        value = getattr(v0, field)
        if setter:
            value = setter(value)
        spec = target.spec(attr)
        if spec[2] != "opt":       # repeated target (conv pad/kernel/stride
            getattr(target, attr).append(value)  # became repeated in V2;
        else:                      # the reference add_pad()s them)
            setattr(target, attr, value)

    route("num_output", {"conv": ("convolution_param", "num_output"),
                         "innerproduct": ("inner_product_param",
                                          "num_output")})
    route("biasterm", {"conv": ("convolution_param", "bias_term"),
                       "innerproduct": ("inner_product_param", "bias_term")})
    if v0.has("weight_filler"):
        if t == "conv":
            sub("convolution_param").weight_filler = v0.weight_filler.copy()
        elif t == "innerproduct":
            sub("inner_product_param").weight_filler = v0.weight_filler.copy()
        else:
            raise ValueError(f"unknown parameter weight_filler for {t!r}")
    if v0.has("bias_filler"):
        if t == "conv":
            sub("convolution_param").bias_filler = v0.bias_filler.copy()
        elif t == "innerproduct":
            sub("inner_product_param").bias_filler = v0.bias_filler.copy()
        else:
            raise ValueError(f"unknown parameter bias_filler for {t!r}")
    route("pad", {"conv": ("convolution_param", "pad"),
                  "pool": ("pooling_param", "pad")})
    route("kernelsize", {"conv": ("convolution_param", "kernel_size"),
                         "pool": ("pooling_param", "kernel_size")})
    route("group", {"conv": ("convolution_param", "group")})
    route("stride", {"conv": ("convolution_param", "stride"),
                     "pool": ("pooling_param", "stride")})
    route("pool", {"pool": ("pooling_param", "pool")},
          setter=lambda v: _POOL_ENUM[int(v)])
    route("dropout_ratio", {"dropout": ("dropout_param", "dropout_ratio")})
    route("local_size", {"lrn": ("lrn_param", "local_size")})
    route("alpha", {"lrn": ("lrn_param", "alpha")})
    route("beta", {"lrn": ("lrn_param", "beta")})
    route("k", {"lrn": ("lrn_param", "k")})
    route("source", {"data": ("data_param", "source"),
                     "hdf5_data": ("hdf5_data_param", "source"),
                     "images": ("image_data_param", "source"),
                     "window_data": ("window_data_param", "source"),
                     "infogain_loss": ("infogain_loss_param", "source")})
    if v0.has("scale"):
        sub("transform_param").scale = v0.scale
    if v0.has("meanfile"):
        sub("transform_param").mean_file = v0.meanfile
    route("batchsize", {"data": ("data_param", "batch_size"),
                        "hdf5_data": ("hdf5_data_param", "batch_size"),
                        "images": ("image_data_param", "batch_size"),
                        "window_data": ("window_data_param", "batch_size")})
    if v0.has("cropsize"):
        sub("transform_param").crop_size = v0.cropsize
    if v0.has("mirror"):
        sub("transform_param").mirror = v0.mirror
    route("rand_skip", {"data": ("data_param", "rand_skip"),
                        "images": ("image_data_param", "rand_skip")})
    route("shuffle_images", {"images": ("image_data_param", "shuffle")})
    route("new_height", {"images": ("image_data_param", "new_height")})
    route("new_width", {"images": ("image_data_param", "new_width")})
    route("concat_dim", {"concat": ("concat_param", "concat_dim")})
    route("det_fg_threshold",
          {"window_data": ("window_data_param", "fg_threshold")})
    route("det_bg_threshold",
          {"window_data": ("window_data_param", "bg_threshold")})
    route("det_fg_fraction",
          {"window_data": ("window_data_param", "fg_fraction")})
    route("det_context_pad",
          {"window_data": ("window_data_param", "context_pad")})
    route("det_crop_mode",
          {"window_data": ("window_data_param", "crop_mode")})
    if v0.has("hdf5_output_param"):
        if t != "hdf5_output":
            raise ValueError("unknown parameter hdf5_output_param for "
                             f"layer type {t!r}")
        v1.hdf5_output_param = v0.hdf5_output_param.copy()
    return v1


_DATA_PARAM_FIELDS = ("data_param", "image_data_param", "window_data_param")
_DEPRECATED_TRANSFORM_FIELDS = ("scale", "mean_file", "crop_size", "mirror")


def net_needs_data_upgrade(net_param):
    """True when any V2 layer still carries deprecated transform fields in
    its data param (upgrade_proto.cpp NetNeedsDataUpgrade :586)."""
    return any(
        lp.has(pf) and any(getattr(lp, pf).has(f)
                           for f in _DEPRECATED_TRANSFORM_FIELDS)
        for lp in net_param.layer for pf in _DATA_PARAM_FIELDS)


def upgrade_data_transform(net_param):
    """Move deprecated DataParameter/ImageDataParameter/WindowDataParameter
    scale/mean_file/crop_size/mirror into the layer's transform_param
    (NetNeedsDataUpgrade :586 + UpgradeNetDataTransformation). Operates on
    V2 `layer` entries, after the V1 upgrade."""
    out = net_param.copy()
    for lp in out.layer:
        for pf in _DATA_PARAM_FIELDS:
            if not lp.has(pf):
                continue
            dp = getattr(lp, pf)
            for f in _DEPRECATED_TRANSFORM_FIELDS:
                if dp.has(f):
                    if not lp.has("transform_param"):
                        lp.transform_param = \
                            Message("TransformationParameter")
                    setattr(lp.transform_param, f, getattr(dp, f))
                    dp.clear(f)
    return out


def solver_needs_type_upgrade(solver_param):
    """True when the deprecated SolverType enum field is set
    (upgrade_proto.cpp SolverNeedsTypeUpgrade :940-946)."""
    return solver_param.has("solver_type")


def upgrade_solver(solver_param):
    """Deprecated `solver_type` enum -> `type` string
    (upgrade_proto.cpp UpgradeSolverType :948-990). Returns a new
    SolverParameter; raises if both old and new fields are set."""
    from ..solver.updates import SOLVER_TYPES
    out = solver_param.copy()
    if out.has("solver_type"):
        if out.has("type"):
            raise ValueError(
                "old solver_type field (enum) and new type field (string) "
                "cannot both be set")
        out.type = SOLVER_TYPES[int(out.solver_type)]
        out.clear("solver_type")
    return out


def upgrade_net(net_param):
    """Chain every upgrade so any prototxt vintage loads:
    V0 layer connections -> V1 typed layers -> deprecated data-transform
    fields -> V2 `layer` list (compiler.upgrade_v1)."""
    from .compiler import upgrade_v1
    if needs_v0_upgrade(net_param):
        net_param = upgrade_v0(net_param)
    net_param = upgrade_v1(net_param)
    return upgrade_data_transform(net_param)
