"""The input path's queue and cache events in the port (data/prefetch.py,
data/device_cache.py) against the JAX package's emit sites: the prefetch
worker pool, the ``prefetch``, ``h2d_stage`` and ``device_cache`` events'
field sets, the event registry, and the train verb's stream read back by
the report verb."""

import contextlib
import io
import json
import threading

import numpy as np
import pytest

from sparknet_tpu.data import prefetch as jprefetch
from sparknet_tpu.data.db_source import DatumBatchSource as JSource
from sparknet_tpu.data import device_cache as jcache
from sparknet_tpu.obs import event_schema as jschema
from sparknet_tpu.proto import Message as JMessage
from sparknet_tpu_torch import cli
from sparknet_tpu_torch.data import device_cache, prefetch
from sparknet_tpu_torch.data.datum import array_to_datum
from sparknet_tpu_torch.data.db_source import DatumBatchSource
from sparknet_tpu_torch.data.lmdb import LMDBWriter
from sparknet_tpu_torch.obs import event_schema
from sparknet_tpu_torch.proto import Message, text_format

N, BATCH = 12, 2


class Sink:
    """A metrics sink with MetricsLogger's log(event, **fields)."""

    def __init__(self):
        self.events = []
        self._lock = threading.Lock()

    def log(self, event, **fields):
        with self._lock:
            self.events.append((event, fields))

    def fields(self, event):
        return [set(f) for e, f in self.events if e == event]


def _batches(n):
    rs = np.random.RandomState(0)
    return [{"data": rs.randint(0, 256, (2, 3, 4, 4)).astype(np.uint8),
             "label": np.full(2, i, np.int32)} for i in range(n)]


def test_prefetch_pool_delivers_every_batch_and_closes():
    it = prefetch.PrefetchIterator(iter(_batches(40)), depth=2, workers=3)
    got = sorted(int(b["label"][0]) for b in it)
    assert got == list(range(40))
    assert it.close()
    assert len(it._threads) == 3
    assert not any(t.is_alive() for t in it._threads)


def test_prefetch_pool_raises_a_worker_error_once_and_stops_siblings():
    def source():
        yield from _batches(3)
        raise KeyError("bad record")

    it = prefetch.PrefetchIterator(source(), depth=2, workers=2)
    got = []
    with pytest.raises(KeyError, match="bad record"):
        for b in it:
            got.append(int(b["label"][0]))
    assert sorted(got) == [0, 1, 2]
    with pytest.raises(StopIteration):
        next(it)
    assert it.close()


def test_prefetch_close_ends_a_pool_blocked_on_a_full_queue():
    def endless():
        while True:
            yield 1
    it = prefetch.PrefetchIterator(endless(), depth=1, workers=3)
    assert next(it) == 1
    assert it.close(timeout=5.0)


def test_prefetch_and_h2d_events_carry_the_jax_fields():
    extra = {"echo": 1, "staging": 1}
    sinks = {}
    for name, mod, kw in (("jax", jprefetch, {}),
                          ("port", prefetch, {"device": "cpu"})):
        sink = sinks[name] = Sink()
        stager = mod.H2DStager(slots=2, metrics=sink, name="train_feed",
                               emit_every=2, **kw)
        it = mod.PrefetchIterator(iter(_batches(6)), depth=2,
                                  transform=stager, metrics=sink,
                                  name="train_feed", emit_every=2,
                                  extra=extra)
        assert len(list(it)) == 6
        it.close()
    for event in ("prefetch", "h2d_stage"):
        port, ref = sinks["port"].fields(event), sinks["jax"].fields(event)
        assert port and port == ref, event
    last = [f for e, f in sinks["port"].events if e == "h2d_stage"][-1]
    assert last["puts"] == 6 and last["bytes"] == 6 * (2 * 48 + 8)
    assert last["in_flight"] == 0 and last["slots"] == 2
    pf = [f for e, f in sinks["port"].events if e == "prefetch"]
    assert pf[-1]["name"] == "train_feed" and pf[-1]["echo"] == 1
    assert pf[-1]["gets"] == 7          # six batches and the end


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    d = tmp_path_factory.mktemp("events_db")
    rs = np.random.RandomState(0)
    with LMDBWriter(str(d / "db")) as w:
        for i in range(N):
            w.put(b"%05d" % i, array_to_datum(
                rs.randint(0, 256, (3, 8, 8)).astype(np.uint8), i % 4))
    return d


def _source(db, msg, cls):
    return cls(str(db / "db"),
               transform_param=msg("TransformationParameter", crop_size=6,
                                   mirror=True),
               batch_size=BATCH, phase=0, seed=1, base_dir=str(db),
               device_transform=True)


def test_device_cache_events_carry_the_jax_fields(db):
    sinks = {}
    for name, cache, kw, msg, cls in (
            ("jax", jcache, {}, JMessage, JSource),
            ("port", device_cache, {"device": "cpu", "log_fn": None},
             Message, DatumBatchSource)):
        sink = sinks[name] = Sink()
        src = cache.maybe_device_cache(_source(db, msg, cls), 64,
                                       metrics=sink, **kw)
        src.emit_every = 2
        it = iter(src)
        for _ in range(5):
            next(it)
        src.close()
        # the refusals: iter_size > 1 and a budget the records overflow
        for size, budget in ((2, 64), (1, 1e-6)):
            refused = cache.maybe_device_cache(
                _source(db, msg, cls), budget, iter_size=size,
                metrics=sink, **kw)
            assert not hasattr(refused, "hits")
    port, ref = (sinks[k].fields("device_cache") for k in ("port", "jax"))
    assert port == ref and len(port) == 6
    ev = [f for e, f in sinks["port"].events if e == "device_cache"]
    assert ev[0]["resident"] is True and ev[0]["hits"] == 0
    assert [e["hits"] for e in ev[1:4]] == [2, 4, 5]
    assert ev[0]["records"] == N and ev[0]["hit_rate"] == 1.0
    assert [e["reason"] for e in ev[4:]] == ["iter_size", "over_budget"]
    assert all(e["hit_rate"] == 0.0 and e["resident"] is False
               for e in ev[4:])


def test_registry_is_the_jax_one_and_covers_the_new_events():
    assert event_schema.EVENTS == jschema.EVENTS
    assert event_schema.KINDS == jschema.KINDS
    for name in ("prefetch", "h2d_stage", "device_cache"):
        assert name in event_schema.EVENTS


def _train_val(db):
    net = Message("NetParameter", name="events")
    lp = Message("LayerParameter", name="data", type="Data",
                 data_param=dict(source="db", batch_size=BATCH,
                                 backend="LMDB"),
                 transform_param=dict(crop_size=6, mirror=True))
    lp.top.extend(["data", "label"])
    net.layer.append(lp)
    ip = Message("LayerParameter", name="ip", type="InnerProduct",
                 inner_product_param=dict(
                     num_output=4, weight_filler=dict(type="xavier")))
    ip.bottom.append("data")
    ip.top.append("ip")
    net.layer.append(ip)
    loss = Message("LayerParameter", name="loss", type="SoftmaxWithLoss")
    loss.bottom.extend(["ip", "label"])
    loss.top.append("loss")
    net.layer.append(loss)
    text_format.dump(net, str(db / "train_val.prototxt"))
    sp = Message("SolverParameter", net="train_val.prototxt", base_lr=0.01,
                 lr_policy="fixed", display=0, max_iter=55, random_seed=5)
    text_format.dump(sp, str(db / "solver.prototxt"))
    return str(db / "solver.prototxt")


def test_train_verb_streams_the_input_events_and_report_reads_them(
        db, tmp_path):
    metrics = str(tmp_path / "m.jsonl")
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(["train", "--solver", _train_val(db), "--device",
                         "cpu", "--metrics", metrics]) == 0
    events = [json.loads(line) for line in open(metrics)]
    names = {e["event"] for e in events}
    assert {"prefetch", "h2d_stage", "device_cache"} <= names
    for e in events:
        spec = event_schema.EVENTS[e["event"]]
        if not spec["open"]:
            assert set(e) - {"event", "t"} <= set(spec["fields"]), e
    pf = [e for e in events if e["event"] == "prefetch"][-1]
    assert pf["name"] == "train_feed" and pf["staging"] == 1
    dc = [e for e in events if e["event"] == "device_cache"]
    assert dc[0]["resident"] is True and dc[-1]["hits"] >= 55
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["report", metrics, "--format", "json"]) == 0
    rep = json.loads(buf.getvalue())
    assert rep["device_cache"]["records"] == N
    assert rep["prefetch"]["name"] == "train_feed"
    assert "h2d_stage" in json.dumps(rep)
