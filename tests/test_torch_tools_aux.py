"""The port's HDF5 snapshots, minibatch sampler, upgrade verbs and
extract_features against the JAX package's on the CPU.

  * HDF5 snapshots (.caffemodel.h5 / .solverstate.h5) written by either
    package restore in the other with params and history equal bit for
    bit (f32 both sides), for SGD (one history slot) and Adam (two);
    `--resume auto` finds an HDF5 snapshot through the manifest, and
    without one by its file name.
  * MinibatchSampler, partition_owners and reshard_owners: the same
    windows and owners from the same RandomState and masks.
  * The upgrade verbs write byte-identical files.
  * extract_features: the written values within 1e-5 of the JAX tool's
    (f32 matmuls summed in different orders), the keys and Datum shapes
    equal.

Everything is small and made here from seeds: a conv + ip net on 2x3x6x6
batches, a 10-record 1x4x4 LMDB.
"""

import os

import numpy as np
import pytest
import torch

from sparknet_tpu import cli as jcli
from sparknet_tpu import tools as jtools
from sparknet_tpu.data import sampler as jsampler
from sparknet_tpu.proto import Message as JMessage
from sparknet_tpu.proto import text_format as jtext_format
from sparknet_tpu.solver import Solver as JSolver
from sparknet_tpu_torch import cli, tools
from sparknet_tpu_torch.data import (MinibatchSampler, partition_owners,
                                     reshard_owners)
from sparknet_tpu_torch.data.datum import array_to_datum, datum_to_array
from sparknet_tpu_torch.data.lmdb import LMDBReader, LMDBWriter
from sparknet_tpu_torch.graph import TEST, CompiledNet
from sparknet_tpu_torch.proto import Message, text_format, wire
from sparknet_tpu_torch.resilience import checkpoint
from sparknet_tpu_torch.solver import Solver

NET = """
name: "h5net"
layer { name: "data" type: "JavaData" top: "data"
        java_data_param { shape { dim: 2 dim: 3 dim: 6 dim: 6 } } }
layer { name: "label" type: "JavaData" top: "label"
        java_data_param { shape { dim: 2 } } }
layer { name: "conv" type: "Convolution" bottom: "data" top: "conv"
        convolution_param { num_output: 4 kernel_size: 3
          weight_filler { type: "gaussian" std: 0.1 }
          bias_filler { type: "constant" value: 0.1 } } }
layer { name: "relu" type: "ReLU" bottom: "conv" top: "conv" }
layer { name: "ip" type: "InnerProduct" bottom: "conv" top: "ip"
        inner_product_param { num_output: 5
          weight_filler { type: "gaussian" std: 0.1 } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip" bottom: "label"
        top: "loss" }
"""


def _sp(M, solver_type):
    return M("SolverParameter", base_lr=0.05, lr_policy="fixed",
             momentum=0.9, type=solver_type, random_seed=1, display=0,
             snapshot_format="HDF5")


def _port(solver_type):
    return Solver(_sp(Message, solver_type),
                  net_param=text_format.loads(NET, "NetParameter"),
                  device="cpu", log_fn=None)


def _jax(solver_type):
    return JSolver(_sp(JMessage, solver_type),
                   net_param=jtext_format.loads(NET, "NetParameter"),
                   log_fn=None)


def _batch(seed):
    rs = np.random.RandomState(seed)
    return {"data": rs.randn(2, 3, 6, 6).astype(np.float32),
            "label": rs.randint(0, 5, 2).astype(np.int32)}


def _assert_equal_state(ts, js):
    assert ts.iter == js.iter
    for name, blobs in js.params.items():
        for i, ref in enumerate(blobs):
            np.testing.assert_array_equal(
                ts.params[name][i].detach().numpy(), np.asarray(ref))
            assert len(ts.history[name][i]) == len(js.history[name][i])
            for a, b in zip(ts.history[name][i], js.history[name][i]):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("solver_type", ["SGD", "Adam"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_hdf5_snapshots_cross_between_the_packages(tmp_path, solver_type,
                                                   writer):
    ts, js = _port(solver_type), _jax(solver_type)
    src, dst = (ts, js) if writer == "port" else (js, ts)
    for seed in range(2):              # the history is not zero
        src.train_step(_batch(seed))
    model, state = src.snapshot(str(tmp_path / writer))
    assert model.endswith("_iter_2.caffemodel.h5")
    assert state.endswith("_iter_2.solverstate.h5")
    dst.restore(state)
    _assert_equal_state(ts, js)
    # weights alone, through load_weights, into a fresh solver
    fresh = _port(solver_type) if writer == "jax" else _jax(solver_type)
    fresh.load_weights(model)
    for name, blobs in src.params.items():
        for i, p in enumerate(blobs):
            got = fresh.params[name][i]
            got = got.detach().numpy() if torch.is_tensor(got) \
                else np.asarray(got)
            want = p.detach().numpy() if torch.is_tensor(p) \
                else np.asarray(p)
            np.testing.assert_array_equal(got, want)


def test_resume_auto_finds_an_hdf5_snapshot(tmp_path):
    ts = _port("SGD")
    ts.train_step(_batch(0))
    prefix = str(tmp_path / "snap")
    ts.snapshot(prefix)
    entry = checkpoint.load_manifest(prefix)["latest"]
    assert entry["format"] == "hdf5" and \
        entry["state"] == "snap_iter_1.solverstate.h5"
    other = _port("SGD")
    log = []
    assert checkpoint.resume_auto(other, prefix, log_fn=log.append) == \
        prefix + "_iter_1.solverstate.h5"
    assert other.iter == 1 and "restored iter 1" in log[-1]
    _assert_equal_state(other,
                        _jax_restored(prefix + "_iter_1.solverstate.h5"))



@pytest.mark.parametrize("writer", ["port", "jax"])
def test_resume_auto_scans_unmanifested_hdf5_pairs(tmp_path, writer):
    """With no manifest, --resume auto finds `_iter_N.solverstate.h5`
    beside its `.caffemodel.h5`, as the JAX scan does, and passes over a
    newer pair with an empty file."""
    src = _port("SGD") if writer == "port" else _jax("SGD")
    prefix = str(tmp_path / "snap")
    for it in range(2):
        src.train_step(_batch(it))
        src.snapshot(prefix)
    os.remove(checkpoint.manifest_path(prefix))
    open(prefix + "_iter_2.caffemodel.h5", "w").close()   # a torn write
    state = prefix + "_iter_1.solverstate.h5"
    log = []
    port = _port("SGD")
    assert checkpoint.resume_auto(port, prefix, log_fn=log.append) == state
    assert any("_iter_2.solverstate.h5" in m and "empty file" in m
               for m in log)
    from sparknet_tpu.resilience import checkpoint as jcheckpoint
    js = _jax("SGD")
    assert jcheckpoint.resume_auto(js, prefix) == state
    _assert_equal_state(port, js)

def _jax_restored(state):
    js = _jax("SGD")
    js.restore(state)
    return js


def test_sampler_picks_the_jax_windows_and_owners():
    batches = [{"i": np.array(i)} for i in range(10)]
    for seed in range(5):
        got = [int(b["i"]) for b in MinibatchSampler(
            batches, 10, 4, rng=np.random.RandomState(seed))]
        want = [int(b["i"]) for b in jsampler.MinibatchSampler(
            batches, 10, 4, rng=np.random.RandomState(seed))]
        assert got == want and got == list(range(got[0], got[0] + 4))
    with pytest.raises(ValueError, match="exhausted"):
        list(MinibatchSampler(iter(batches[:2]), 8, 3,
                              rng=np.random.RandomState(1)))
    rs = np.random.RandomState(2)
    for _ in range(10):
        alive = rs.rand(6) < 0.6
        if not alive.any():
            continue
        np.testing.assert_array_equal(partition_owners(6, alive),
                                      jsampler.partition_owners(6, alive))
    for a, b in [(4, 2), (2, 4), (3, 3), (1, 5), (8, 3)]:
        np.testing.assert_array_equal(reshard_owners(a, b),
                                      jsampler.reshard_owners(a, b))
    with pytest.raises(ValueError, match="no live"):
        partition_owners(3, [False] * 3)


V0_NET = """
name: "v0_mini"
input: "data"
input_dim: 2 input_dim: 3 input_dim: 8 input_dim: 8
layers {
  layer {
    name: "conv1" type: "conv" num_output: 4 kernelsize: 3 stride: 1
    weight_filler { type: "gaussian" std: 0.01 }
  }
  bottom: "data" top: "conv1"
}
layers {
  layer { name: "relu1" type: "relu" }
  bottom: "conv1" top: "conv1"
}
layer {
  name: "data2" type: "Data" top: "d2" top: "l2"
  data_param { source: "x_lmdb" batch_size: 4 crop_size: 5 mirror: true }
}
"""


@pytest.mark.parametrize("verb, text_in", [
    ("upgrade_net_proto_text", V0_NET),
    ("upgrade_net_proto_binary", V0_NET),
    ("upgrade_solver_proto_text",
     'base_lr: 0.01\nlr_policy: "fixed"\nsolver_type: ADAM\n'),
    ("upgrade_solver_proto_text", 'base_lr: 0.01\ntype: "Nesterov"\n')],
    ids=["net-text", "net-binary", "solver-enum", "solver-current"])
def test_upgrade_verbs_write_the_jax_files(tmp_path, capsys, verb, text_in):
    inp = tmp_path / "in"
    if verb == "upgrade_net_proto_binary":
        wire.dump(text_format.loads(text_in, "NetParameter"), str(inp))
    else:
        inp.write_text(text_in)
    assert cli.main([verb, str(inp), str(tmp_path / "port")]) == 0
    out = capsys.readouterr().out
    assert jcli.main([verb, str(inp), str(tmp_path / "jax")]) == 0
    assert capsys.readouterr().out == out.replace(
        str(tmp_path / "port"), str(tmp_path / "jax"))
    assert (tmp_path / "port").read_bytes() == (tmp_path / "jax").read_bytes()


FEATURE_NET = """
name: "feat"
layer {
  name: "data" type: "Data" top: "data" top: "label"
  include { phase: TEST }
  data_param { source: "feat_lmdb" batch_size: 4 }
  transform_param { scale: 0.0078125 }
}
layer {
  name: "ip" type: "InnerProduct" bottom: "data" top: "ip"
  inner_product_param { num_output: 6
    weight_filler { type: "gaussian" std: 0.1 }
    bias_filler { type: "constant" value: 0.2 } }
}
layer { name: "prob" type: "Softmax" bottom: "ip" top: "prob" }
"""


def _read(path):
    with LMDBReader(path) as r:
        keys = list(r.keys())
        return keys, [datum_to_array(r.get(k))[0] for k in keys]


def test_extract_features_writes_the_jax_tool_s_values(tmp_path, capsys):
    rs = np.random.RandomState(0)
    imgs = rs.randint(0, 256, (10, 1, 4, 4)).astype(np.uint8)
    with LMDBWriter(str(tmp_path / "feat_lmdb")) as w:
        for i, img in enumerate(imgs):
            w.put(b"%05d" % i, array_to_datum(img, i % 3))
    model = tmp_path / "feat.prototxt"
    model.write_text(FEATURE_NET)
    net = CompiledNet(text_format.loads(FEATURE_NET, "NetParameter"), TEST,
                      feed_shapes={"data": (4, 1, 4, 4), "label": (4,)},
                      device="cpu")
    params, state = net.init(torch.Generator().manual_seed(7))
    weights = str(tmp_path / "feat.caffemodel")
    wire.dump(net.params_to_netproto(params, state), weights)
    dbs = {who: [str(tmp_path / f"{who}_{b}") for b in ("ip", "prob")]
           for who in ("port", "jax")}
    assert cli.main(["extract_features", weights, str(model), "ip,prob",
                     ",".join(dbs["port"]), "2", "--device", "cpu"]) == 0
    jtools.extract_features(str(model), ["ip", "prob"], dbs["jax"], 2,
                            weights_path=weights, log=lambda *a: None)
    out = capsys.readouterr().out
    assert "Extracted features of 8 query images for feature blob prob" \
        in out
    for got_db, want_db in zip(dbs["port"], dbs["jax"]):
        keys, got = _read(got_db)
        jkeys, want = _read(want_db)
        assert keys == jkeys == [b"%010d" % i for i in range(8)]
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == np.float32
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
    # not all-zero features: the check above would pass on those
    assert np.abs(np.stack(_read(dbs["port"][0])[1])).max() > 0.1
    with pytest.raises(ValueError, match="Unknown feature blob"):
        tools.extract_features(str(model), ["nope"],
                               [str(tmp_path / "nope_db")], 1,
                               weights_path=weights, device="cpu",
                               log=lambda *a: None)
    assert not os.path.exists(str(tmp_path / "nope_db"))
