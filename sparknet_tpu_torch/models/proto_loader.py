"""Prototxt manipulation utilities — parity with reference ProtoLoader.scala
(copied from sparknet_tpu/models/proto_loader.py).

The reference round-tripped prototxt text through a C++ parser to get
protobuf-java objects (ProtoLoader.scala:9-29); here the text parser is
native Python (proto.text_format), so these are plain Message transforms.
"""

from ..proto import Message, text_format


def load_net_prototxt(path):
    """ProtoLoader.loadNetPrototxt (:20-29)."""
    return text_format.load(path, "NetParameter")


def load_solver_prototxt_with_net(solver_path, net, snapshot_prefix=None):
    """ProtoLoader.loadSolverPrototxtWithNet (:31-43): load a solver
    prototxt, embed ``net`` as net_param, and clear file-based net refs;
    snapshotting is cleared unless a prefix is given (the reference apps
    pass None — the app's in-memory weights are the checkpoint)."""
    sp = text_format.load(solver_path, "SolverParameter")
    for f in ("net", "train_net", "test_net", "train_net_param",
              "test_net_param", "net_param"):
        sp.clear(f)
    sp.net_param = net
    if snapshot_prefix is None:
        sp.clear("snapshot")
        sp.clear("snapshot_prefix")
    else:
        sp.snapshot_prefix = snapshot_prefix
    return sp


def replace_data_layers(net, train_batch, test_batch, channels, height,
                        width, data_blob="data", label_blob="label"):
    """ProtoLoader.replaceDataLayers (:50-57): drop the first data layers
    and prepend JavaData train/test pairs producing (data, label) tops."""
    out = net.copy()
    layers = [lp for lp in out.layer
              if lp.type not in ("Data", "JavaData", "ImageData", "HDF5Data",
                                 "MemoryData", "WindowData", "DummyData")]
    out.clear("layer")

    def java_data(name, batch, phase):
        lp = Message("LayerParameter", name=name, type="JavaData")
        lp.top.append(data_blob)
        lp.top.append(label_blob)
        shape = Message("BlobShape")
        shape.dim.extend([batch, channels, height, width])
        lp.java_data_param = Message("JavaDataParameter", shape=shape)
        lp.include.append(Message("NetStateRule", phase=phase))
        return lp

    out.layer.append(java_data("java_train_data", train_batch, 0))  # TRAIN
    out.layer.append(java_data("java_test_data", test_batch, 1))    # TEST
    for lp in layers:
        out.layer.append(lp)
    return out
