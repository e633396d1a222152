"""The port's CIFAR app path against the JAX package's on the CPU: the
synthetic data generators (bit for bit), the CIFAR binary format and
dataset, make_synth_cifar, the app's per-round batch layout, the
prefetch iterator's close, and the ``cifar`` verb end to end (local SGD,
snapshots and --resume auto, data parallelism, the stock-prototxt path,
and the flags it refuses)."""

import os
import threading
import time

import numpy as np
import pytest

from sparknet_tpu import tools as jtools
from sparknet_tpu.apps import CifarApp as JCifarApp
from sparknet_tpu.data import synthetic as jsyn
from sparknet_tpu.data.cifar import CifarDataset as JCifarDataset
from sparknet_tpu_torch import cli, tools
from sparknet_tpu_torch.apps import CifarApp
from sparknet_tpu_torch.data import (CifarDataset, EchoIterator,
                                     PrefetchIterator, class_gaussian_images,
                                     read_batch_file, shape_texture_images,
                                     write_batch_file)
from sparknet_tpu_torch.models import zoo as tzoo
from sparknet_tpu_torch.proto import Message as TMessage, text_format
from sparknet_tpu_torch.utils import Watchdog


def test_synthetic_images_equal_the_jax_package_s():
    for seed in (0, 7):
        a = class_gaussian_images(50, shape=(3, 8, 8), seed=seed)
        b = jsyn.class_gaussian_images(50, shape=(3, 8, 8), seed=seed)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        a = shape_texture_images(40, seed=seed, chunk=16, label_noise=0.3)
        b = jsyn.shape_texture_images(40, seed=seed, chunk=16,
                                      label_noise=0.3)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def synth_dir(tmp_path_factory):
    """make_synth_cifar's binaries: 250 train and 200 test records."""
    d = tmp_path_factory.mktemp("cifar")
    tools.make_synth_cifar(str(d / "port"), n_train=250, n_test=200, seed=3,
                           log=lambda *a: None)
    return d


def test_make_synth_cifar_writes_the_jax_package_s_files(synth_dir):
    jtools.make_synth_cifar(str(synth_dir / "jax"), n_train=250, n_test=200,
                            seed=3, log=lambda *a: None)
    names = sorted(os.listdir(synth_dir / "port"))
    assert names == sorted(os.listdir(synth_dir / "jax")) == \
        [f"data_batch_{i}.bin" for i in range(1, 6)] + ["test_batch.bin"]
    for n in names:
        with open(synth_dir / "port" / n, "rb") as f, \
                open(synth_dir / "jax" / n, "rb") as g:
            assert f.read() == g.read(), n


def test_batch_file_round_trip_and_dataset_match_jax(tmp_path, synth_dir):
    rs = np.random.RandomState(0)
    imgs = rs.randint(0, 256, (7, 3, 32, 32)).astype(np.uint8)
    labs = rs.randint(0, 10, 7).astype(np.int32)
    write_batch_file(str(tmp_path / "x.bin"), imgs, labs)
    got_i, got_l = read_batch_file(str(tmp_path / "x.bin"))
    np.testing.assert_array_equal(got_i, imgs)
    np.testing.assert_array_equal(got_l, labs)
    assert got_l.dtype == np.int32
    (tmp_path / "bad.bin").write_bytes(b"\0" * 100)
    with pytest.raises(ValueError, match="not a multiple"):
        read_batch_file(str(tmp_path / "bad.bin"))
    ours = CifarDataset(str(synth_dir / "port"), seed=5)
    ref = JCifarDataset(str(synth_dir / "port"), seed=5)
    for k in ("train_images", "train_labels", "test_images", "test_labels",
              "mean_image"):
        np.testing.assert_array_equal(getattr(ours, k), getattr(ref, k))
    a = next(ours.minibatches(16, train=False))
    b = next(ref.minibatches(16, train=False))
    np.testing.assert_array_equal(a["data"], b["data"])
    with pytest.raises(FileNotFoundError, match="test_batch.bin"):
        CifarDataset(str(tmp_path))


def test_tau_batches_lay_out_rounds_as_the_jax_app(synth_dir):
    """Worker-contiguous windows reordered to (tau, W*B, ...): the same
    arrays from the same seed, round after round."""
    ours = CifarApp(num_workers=2, data_dir=str(synth_dir / "port"), seed=9,
                    tau=3, device="cpu")
    ref = JCifarApp(num_workers=2, data_dir=str(synth_dir / "port"), seed=9,
                    tau=3)
    for _ in range(2):
        a, b = ours._tau_batches(3), ref._tau_batches(3)
        assert a["data"].shape == (3, 200, 3, 32, 32)
        assert a["label"].shape == (3, 200)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    a, b = ours._train_arrays(100), ref._train_arrays(100)
    np.testing.assert_array_equal(a[0], b[0])


def _count():
    n = 0
    while True:
        yield n
        n += 1


def test_prefetch_close_joins_its_worker_within_a_limit():
    """The worker blocks on a full queue (depth 1) when close() comes;
    close() must stop and join it inside its own timeout."""
    it = PrefetchIterator(_count(), depth=1)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    time.sleep(0.2)                    # the worker now waits on put()
    t0 = time.monotonic()
    assert it.close(timeout=5.0)
    assert time.monotonic() - t0 < 5.0
    assert not any(t.is_alive() for t in it._threads)
    with pytest.raises(StopIteration):
        next(it)
    echo = EchoIterator(PrefetchIterator(_count(), depth=1), echo=2)
    assert [next(echo) for _ in range(4)] == [0, 0, 1, 1]
    assert echo.close()


def test_prefetch_raises_a_worker_error_once_after_its_batches():
    def source():
        yield 1
        yield 2
        raise KeyError("bad record")
    it = PrefetchIterator(source(), depth=4)
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(KeyError, match="bad record"):
        next(it)
    with pytest.raises(StopIteration):
        next(it)
    assert it.close()
    alive = [t for t in threading.enumerate()
             if t.name.startswith("sparknet-prefetch") and t in it._threads]
    assert not alive


def test_watchdog_reports_a_stall_and_a_nan():
    stalls, nans = [], []
    with Watchdog(stall_seconds=0.1, poll_seconds=0.02,
                  on_stall=stalls.append, on_nan=nans.append) as wd:
        wd.beat(2.3)
        deadline = time.monotonic() + 5.0
        while not stalls and time.monotonic() < deadline:
            time.sleep(0.02)
        wd.beat(float("nan"))
    assert stalls and stalls[0] > 0.1 and wd.stalls >= 1
    assert len(nans) == 1 and np.isnan(nans[0]) and wd.nans == 1
    assert not wd._thread.is_alive()


def _verb(args, capsys):
    assert cli.main(["cifar", "--device", "cpu", *args]) == 0
    return capsys.readouterr().out


def test_cifar_verb_local_sgd_snapshots_and_resumes(tmp_path, synth_dir,
                                                    capsys):
    data = str(synth_dir / "port")
    prefix = str(tmp_path / "snap")
    out = _verb(["--data", data, "--workers", "2", "--tau", "2",
                 "--rounds", "2", "--test-every", "2", "--snapshot-prefix",
                 prefix, "--snapshot-every", "1", "--log",
                 str(tmp_path / "log.txt")], capsys)
    assert "initialized: 2 workers, strategy=local_sgd, device=cpu" in out
    assert "round 0: test accuracy = " in out
    losses = [float(line.split("loss = ")[1]) for line in out.splitlines()
              if ": loss = " in line]
    assert len(losses) == 2 and np.all(np.isfinite(losses))
    assert "done: 2 rounds, iter=4" in out
    assert os.path.exists(f"{prefix}_iter_2.solverstate")
    assert "round 1: loss = " in (tmp_path / "log.txt").read_text()
    out = _verb(["--data", data, "--workers", "2", "--tau", "2",
                 "--rounds", "1", "--snapshot-prefix", prefix, "--resume",
                 "auto"], capsys)
    assert "resume auto: restored iter 4" in out
    assert "done: 1 rounds, iter=6" in out


def test_cifar_verb_dp_and_the_stock_prototxt_path(tmp_path, capsys,
                                                    monkeypatch):
    """Data parallelism over 2 slots on the synthetic class-gaussians;
    then the solver and net from prototxt files, their data layers
    replaced (ProtoLoader.replaceDataLayers)."""
    # --echo writes SPARKNET_ECHO: monkeypatch restores it after the test
    monkeypatch.setenv("SPARKNET_ECHO", "")
    out = _verb(["--strategy", "dp", "--workers", "2", "--rounds", "2",
                 "--test-every", "1", "--echo", "2"], capsys)
    assert "strategy=dp" in out and "round 1: test loss = " in out
    assert "done: 2 rounds, iter=2" in out
    net = tzoo.cifar10_full(batch_size=64)
    text_format.dump(net, str(tmp_path / "cifar10_full_train_test.prototxt"))
    sp = TMessage("SolverParameter", base_lr=0.001, momentum=0.9,
                  weight_decay=0.004, lr_policy="fixed", display=0,
                  net="examples/cifar10/cifar10_full_train_test.prototxt",
                  snapshot=10000, snapshot_prefix="examples/cifar10/x")
    text_format.dump(sp, str(tmp_path / "cifar10_full_solver.prototxt"))
    out = _verb(["--prototxt-dir", str(tmp_path), "--workers", "2",
                 "--tau", "1", "--rounds", "1", "--test-every", "5"],
                capsys)
    assert "done: 1 rounds, iter=1" in out


@pytest.mark.parametrize("flags", [
    ["--hosts", "2"], ["--chaos", "stall_step=1"], ["--reshard", "auto"],
    ["--tp", "2"], ["--quorum", "2"], ["--staleness", "1"],
    ["--heartbeat-dir", "hb"], ["--grow"], ["--evict-after", "2"],
    ["--shard-ingest", "on"], ["--fsdp", "on"], ["--lease-s", "3"]],
    ids=lambda f: f[0])
def test_cifar_verb_refuses_unported_flags(flags, capsys, monkeypatch):
    # the multi-host flags are the JAX verb's now, and parse with its
    # values; --tp and --fsdp, which the JAX cifar verb does not have,
    # are usage errors there and here
    got = []
    monkeypatch.setattr(cli, "cmd_cifar", lambda a: got.append(a) or 0)
    argv = ["cifar", "--device", "cpu", *flags]
    if flags[0] in ("--tp", "--fsdp"):
        with pytest.raises(SystemExit) as e:
            cli.main(argv)
        assert e.value.code == 2
        assert "unrecognized arguments" in capsys.readouterr().err
        return
    assert cli.main(argv) == 0
    v = getattr(got[0], flags[0].lstrip("-").replace("-", "_"))
    assert v == (True if len(flags) == 1 else type(v)(flags[1]))


def test_cifar_verb_takes_the_wire_flags_as_the_jax_verb(capsys,
                                                          monkeypatch):
    # as in the JAX package, the CIFAR feed is host-transformed, so the
    # wire and staging flags only set their env vars; echo with a precrop
    # wire is refused before anything runs
    for env in ("SPARKNET_WIRE", "SPARKNET_WIRE_BITS", "SPARKNET_STAGING",
                "SPARKNET_ECHO"):
        monkeypatch.setenv(env, "")
    out = _verb(["--workers", "1", "--tau", "1", "--rounds", "1",
                 "--test-every", "5", "--wire", "pack", "--wire-bits", "4",
                 "--staging", "off"], capsys)
    assert "done: 1 rounds, iter=1" in out
    assert (os.environ["SPARKNET_WIRE"], os.environ["SPARKNET_WIRE_BITS"],
            os.environ["SPARKNET_STAGING"]) == ("pack", "4", "off")
    with pytest.raises(SystemExit, match="precrop"):
        cli.main(["cifar", "--device", "cpu", "--wire", "precrop",
                  "--echo", "2"])


def test_cifar_app_refuses_hosts():
    with pytest.raises(ValueError, match="hosts"):
        CifarApp(hosts=2, device="cpu")
