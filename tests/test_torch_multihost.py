"""The multi-host runtime of the port against the JAX package's, on the
CPU: one rendezvous directory shared across the packages, restart,
reshard and ingest, the retry policy under chaos, the topology, two
`cifar --hosts 2` processes, and the training verbs' flags.

A JAX host and a port host lease into one directory: a JAX FileConsensus
and a port FileConsensus, each on its own package's
HeartbeatCoordinator, in two threads, write the same mask files and adopt
the same average, bit for bit (both average the same part files in
float64), with the authority alive or killed, and the async relay
likewise. The processes test runs `python -m sparknet_tpu_torch cifar
--device cpu` twice over with leases of 1.5 s: one process killed at a
round gate, the survivor evicting it and exiting 0; and with --quorum 2,
the survivor exiting 4 holding an agreed manifest.
"""

import argparse
import json
import os
import subprocess
import sys
import threading
from unittest import mock

import numpy as np
import pytest

from sparknet_tpu import cli as jcli
from sparknet_tpu.data import ingest as jingest
from sparknet_tpu.resilience import chaos as jchaos
from sparknet_tpu.resilience import checkpoint as jckpt
from sparknet_tpu.resilience import heartbeat as jhb
from sparknet_tpu.resilience import retry as jretry
from sparknet_tpu_torch import cli as tcli
from sparknet_tpu_torch.data import ingest as tingest
from sparknet_tpu_torch.parallel import multihost
from sparknet_tpu_torch.resilience import chaos as tchaos
from sparknet_tpu_torch.resilience import checkpoint as tckpt
from sparknet_tpu_torch.resilience import heartbeat as thb
from sparknet_tpu_torch.resilience import retry as tretry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = {"jax": jhb, "port": thb}


def _coord(mod, d, host, n, lease=0.5):
    return mod.HeartbeatCoordinator(str(d), host=host, n_hosts=n,
                                    interval_s=0.05, lease_s=lease,
                                    log_fn=None).start()


def _leaves(host):
    rs = np.random.RandomState(10 + host)
    return [rs.randn(3, 4).astype(np.float32),
            rs.randn(5).astype(np.float32), np.float32(host + 0.5)]


def _threads(*fns):
    out = [None] * len(fns)

    def run(i, fn):
        out[i] = fn()
    ts = [threading.Thread(target=run, args=(i, fn))
          for i, fn in enumerate(fns)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    return out


# -- the relay across the packages ------------------------------------------

@pytest.mark.parametrize("host0", ["jax", "port"])
def test_file_consensus_across_packages(tmp_path, host0):
    host1 = "port" if host0 == "jax" else "jax"
    c0, c1 = (_coord(PKG[p], tmp_path, h, 2)
              for h, p in ((0, host0), (1, host1)))
    try:
        f0, f1 = PKG[host0].FileConsensus(c0), PKG[host1].FileConsensus(c1)
        for r in range(2):
            (o0, a0), (o1, a1) = _threads(
                lambda: f0.exchange(r, _leaves(0), True, 0.25, [0, 1]),
                lambda: f1.exchange(r, _leaves(1), True, 0.75, [0, 1]))
            for x, y in zip(o0, o1):
                assert np.asarray(x).tobytes() == np.asarray(y).tobytes()
            want = [(np.float64(a) + np.float64(b)) * 0.5
                    for a, b in zip(_leaves(0), _leaves(1))]
            for x, w in zip(o0, want):
                np.testing.assert_array_equal(x, w.astype(np.float32))
            assert list(a0["valid"]) == list(a1["valid"]) == [1.0, 1.0]
            np.testing.assert_array_equal(a0["worker_loss"], [0.25, 0.75])
            mask = json.loads((tmp_path / f"mask-{r}.json").read_text())
            assert mask == {"round": r, "included": [0, 1], "authority": 0}
    finally:
        c0.stop()
        c1.stop()


@pytest.mark.parametrize("dead", ["jax", "port"])
def test_file_consensus_authority_killed(tmp_path, dead):
    """The authority (host 0) never posts and its lease lapses: host 1,
    of the other package, becomes the authority and adopts its own part."""
    live = "port" if dead == "jax" else "jax"
    c0 = _coord(PKG[dead], tmp_path, 0, 2, lease=0.4)
    c1 = _coord(PKG[live], tmp_path, 1, 2, lease=0.4)
    c0.stop()                       # the authority dies silently
    try:
        out, aux = PKG[live].FileConsensus(c1).exchange(
            0, _leaves(1), True, 0.5, [0, 1], timeout=0.4)
        for x, y in zip(out, _leaves(1)):
            assert np.asarray(x).tobytes() == np.asarray(y).tobytes()
        assert list(aux["valid"]) == [0.0, 1.0]
        mask = json.loads((tmp_path / "mask-0.json").read_text())
        assert mask == {"round": 0, "included": [1], "authority": 1}
    finally:
        c1.stop()


@pytest.mark.parametrize("host0", ["jax", "port"])
def test_async_file_consensus_across_packages(tmp_path, host0):
    """Host 1 pushes first (no consensus yet: it keeps its own); host 0,
    the merge authority, pushes and merges both deltas into consensus-0
    and adopts it; host 1's next exchange adopts that same consensus."""
    host1 = "port" if host0 == "jax" else "jax"
    c0, c1 = (_coord(PKG[p], tmp_path, h, 2)
              for h, p in ((0, host0), (1, host1)))
    try:
        f0 = PKG[host0].AsyncFileConsensus(c0, s=1, decay=0.5)
        f1 = PKG[host1].AsyncFileConsensus(c1, s=1, decay=0.5)
        o1, _ = f1.exchange(0, _leaves(1), True, 0.75, [0, 1])
        for x, y in zip(o1, _leaves(1)):
            np.testing.assert_array_equal(x, y)
        o0, a0 = f0.exchange(0, _leaves(0), True, 0.25, [0, 1])
        o1, a1 = f1.exchange(1, _leaves(1), True, 0.75, [0, 1])
        for x, y in zip(o0, o1):
            assert np.asarray(x).tobytes() == np.asarray(y).tobytes()
        want = [(np.float64(a) + np.float64(b)) / 2
                for a, b in zip(_leaves(0), _leaves(1))]
        for x, w in zip(o0, want):
            np.testing.assert_allclose(x, w, rtol=1e-6)
        assert a0["transport"] == a1["transport"] == "async-relay"
        meta = json.loads((tmp_path / "consensus-0.json").read_text())
        assert [e["host"] for e in meta["included"]] == [0, 1]
    finally:
        c0.stop()
        c1.stop()


@pytest.mark.parametrize("shas,agreed", [(("abc", "abc"), True),
                                         (("abc", "xyz"), False)],
                         ids=["agree", "disagree"])
def test_restart_barrier_across_packages(tmp_path, shas, agreed):
    c0, c1 = _coord(jhb, tmp_path, 0, 2), _coord(thb, tmp_path, 1, 2)
    try:
        (ja, js), (ta, ts) = _threads(
            lambda: jhb.restart_barrier(c0, shas[0], timeout=5),
            lambda: thb.restart_barrier(c1, shas[1], timeout=5))
        assert ja is ta is agreed
        assert js == ts == {0: shas[0], 1: shas[1]}
    finally:
        c0.stop()
        c1.stop()
    p = tmp_path / "snap"
    tckpt.atomic_write_json(tckpt.manifest_path(str(p)), {"latest": {}})
    assert thb.manifest_sha(str(p)) == jhb.manifest_sha(str(p))


# -- reshard, ingest, retry ---------------------------------------------------

WORLDS = [{"processes": 1}, {"processes": 2, "mesh": {"data": 2}},
          {"processes": 1, "mesh": {"host": 2, "data": 2}},
          {"processes": 3, "mesh": {"host": 1, "data": 4}},
          {"processes": 1, "mesh": {"data": 8}}, None]


@pytest.mark.parametrize("a", range(len(WORLDS)))
def test_reshard_for_world_and_world_slots_match_jax(a):
    for b in range(len(WORLDS)):
        assert tckpt.reshard_for_world(WORLDS[a], WORLDS[b]) == \
            jckpt.reshard_for_world(WORLDS[a], WORLDS[b])
    assert tckpt.world_slots(WORLDS[a]) == jckpt.world_slots(WORLDS[a])


@pytest.mark.parametrize("hosts", [1, 2, 3, 5])
def test_ingest_shard_respread_matches_jax(hosts):
    rs = np.random.RandomState(hosts)
    for host in range(hosts):
        t = tingest.IngestShard(103, host, hosts)
        j = jingest.IngestShard(103, host, hosts)
        for _ in range(3):
            alive = rs.rand(hosts) > 0.3
            alive[host] = True
            t, j = t.respread(alive), j.respread(alive)
            np.testing.assert_array_equal(t.indices, j.indices)
            assert t.describe() == j.describe()
            np.testing.assert_array_equal(t.take(7, 20), j.take(7, 20))


class _Sink:
    def __init__(self):
        self.events = []

    def log(self, event, **fields):
        self.events.append((event, fields))


@pytest.mark.parametrize("budget", [None, 3])
def test_retry_policy_under_chaos_matches_jax(budget):
    runs = []
    for chaos_mod, retry_mod in ((jchaos, jretry), (tchaos, tretry)):
        sink, sleeps = _Sink(), []
        monkey = chaos_mod.ChaosMonkey.parse("io_p=0.5,seed=7")
        pol = retry_mod.RetryPolicy(attempts=3, budget=budget, seed=1,
                                    sleep=sleeps.append, metrics=sink)
        calls, errors = [], []

        def read(i):
            calls.append(i)
            monkey.maybe_io_error(f"rec{i}")
            return i
        for i in range(12):
            try:
                pol.call(read, i, where=f"rec{i}")
            except retry_mod.RetryExhausted as e:
                errors.append(str(e))
        runs.append((calls, sleeps, sink.events, errors,
                     pol.retries_used))
    assert runs[0] == runs[1]
    assert runs[1][4] > 0


def test_retry_from_env_matches_jax(monkeypatch):
    for v in ("0", "2", "junk", None):
        if v is None:
            monkeypatch.delenv("SPARKNET_IO_RETRIES", raising=False)
        else:
            monkeypatch.setenv("SPARKNET_IO_RETRIES", v)
        t, j = tretry.retry_from_env(), jretry.retry_from_env()
        assert (t is None) == (j is None)
        if t is not None:
            assert t.attempts == j.attempts


# -- topology -----------------------------------------------------------------

def test_topology_from_the_variables(monkeypatch):
    monkeypatch.setattr(multihost.context, "_host_topology", None)
    monkeypatch.setenv("SPARKNET_NUM_PROCESSES", "3")
    monkeypatch.setenv("SPARKNET_PROCESS_ID", "2")
    monkeypatch.setenv("SPARKNET_COORDINATOR", "localhost:1234")
    try:
        topo = multihost.init_runtime()
        assert (topo["num_processes"], topo["process_id"],
                topo["coordinator"]) == (3, 2, "localhost:1234")
        assert multihost.needs_host_relay()
        grid = multihost.auto_host_mesh(hosts=3, per_host=2)
        assert grid.shape == {"host": 1, "data": 2} and grid.is_local()
        assert multihost.local_batch_rows(8, grid) == (0, 8)
        monkeypatch.setenv("SPARKNET_PROCESS_ID", "3")
        with pytest.raises(ValueError, match="process id 3"):
            multihost.init_runtime()
    finally:
        multihost.context._host_topology = None


def test_slot_grids_in_one_process(monkeypatch):
    monkeypatch.setattr(multihost.context, "_host_topology", None)
    for k in ("SPARKNET_NUM_PROCESSES", "SPARKNET_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    grid = multihost.host_mesh(hosts=4, per_host=2)
    assert grid.shape == {"host": 4, "data": 2} and grid.slots == 8
    assert multihost.my_host_rows(grid) == [0, 1, 2, 3]
    assert multihost.local_batch_rows(16, grid) == (0, 16)
    shrunk = multihost.survivor_mesh(grid, [0, 2])
    assert shrunk.shape == {"host": 2, "data": 2} and shrunk.is_local()
    with pytest.raises(ValueError, match="not divisible"):
        multihost.local_batch_rows(10, grid)
    assert not multihost.needs_host_relay()
    assert tckpt.world_signature() == {"processes": 1}


# -- two processes --------------------------------------------------------------

def _cifar(tmp_path, pid, n, extra, hb):
    env = dict(os.environ, SPARKNET_NUM_PROCESSES=str(n),
               SPARKNET_PROCESS_ID=str(pid))
    cmd = [sys.executable, "-m", "sparknet_tpu_torch", "cifar", "--device",
           "cpu", "--hosts", str(n), "--workers", str(n), "--tau", "1",
           "--test-every", "1000", "--heartbeat-dir", str(hb),
           "--lease-s", "1.5", "--heartbeat-interval", "0.1",
           "--metrics", str(tmp_path / f"m{pid}.jsonl"), *extra]
    return subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _events(path, kind):
    with open(path) as f:
        return [e for e in map(json.loads, f) if e.get("event") == kind]


@pytest.mark.parametrize("quorum,rc", [(1, 0), (2, 4)])
def test_two_cifar_processes_survive_or_restart(tmp_path, quorum, rc):
    """Host 1 dies by SIGKILL at the gate of round 2. With --quorum 1 the
    survivor evicts it (lease_expired) and finishes with exit 0; with
    --quorum 2 it snapshots, passes the restart barrier agreed on the
    manifest's sha256 and exits 4."""
    hb = tmp_path / "hb"
    prefix = str(tmp_path / "ckpt" / "snap")
    extra = ["--rounds", "4", "--quorum", str(quorum), "--evict-after", "1",
             "--snapshot-prefix", prefix]
    procs = [_cifar(tmp_path, 0, 2, extra, hb),
             _cifar(tmp_path, 1, 2, extra + [
                 "--chaos", "kill_host=1,kill_host_round=2"], hb)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert procs[1].returncode == -9, outs[1][-2000:]
    assert procs[0].returncode == rc, outs[0][-3000:]
    ev = _events(tmp_path / "m0.jsonl", "eviction")
    member = _events(tmp_path / "m0.jsonl", "membership")
    if rc == 0:
        assert [(e["worker"], e["reason"]) for e in ev] == \
            [(1, "lease_expired")]
        assert "done: 4 rounds" in outs[0]
    else:
        # the eviction would break the quorum: it is refused, and the
        # run ends on the snapshot every survivor agrees on
        assert ev == []
        assert [e["kind"] for e in member][:1] == ["quorum_lost"]
        cr = [e for e in member if e.get("kind") == "coordinated_restart"]
        assert cr and cr[0]["agreed"] and \
            cr[0]["sha"] == thb.manifest_sha(prefix)
        assert "QUORUM LOST" in outs[0]


# -- the training verbs' flags ------------------------------------------------

class _Parsed(Exception):
    pass


def _verb_flags(main, verb):
    box = {}

    def grab(self, args=None, namespace=None):
        box["parser"] = self
        raise _Parsed

    with mock.patch.object(argparse.ArgumentParser, "parse_args", grab):
        with pytest.raises(_Parsed):
            main([verb])
    sub = next(a for a in box["parser"]._actions
               if isinstance(a, argparse._SubParsersAction))
    out = {}
    for a in sub.choices[verb]._actions:
        if isinstance(a, argparse._HelpAction):
            continue
        out[tuple(sorted(a.option_strings)) or (a.dest,)] = dict(
            dest=a.dest, default=a.default, nargs=a.nargs, const=a.const,
            required=a.required, kind=type(a).__name__,
            choices=None if a.choices is None else list(a.choices))
    return out


@pytest.mark.parametrize("verb", ["train", "cifar", "simfleet"])
def test_training_verbs_take_every_jax_flag_with_its_default(verb):
    port, ref = _verb_flags(tcli.main, verb), _verb_flags(jcli.main, verb)
    assert set(port) - set(ref) == ({("--device",)} if verb != "simfleet"
                                    else set())
    assert set(ref) <= set(port)
    for key, spec in ref.items():
        assert port[key] == spec, (verb, key)
    for flag in port:
        assert port[flag]["kind"] != "_NotPorted", (verb, flag)
    if verb != "simfleet":
        assert port[("--device",)]["default"] == "cuda"
