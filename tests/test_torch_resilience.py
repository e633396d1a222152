"""Run safety in the port against the JAX package: the signal policy,
SIGTERM through both train verbs, the watchdog's kill path (exit 42
with an emergency snapshot), divergence recovery (rollback, lr decay,
abort and the train verb's exit 3), and keep-N retention with
resume_auto's fallback, each on the same prefix in both packages.

The kill and signal paths run in subprocesses: os._exit and a real
SIGTERM must never reach the pytest process."""

import contextlib
import io
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from sparknet_tpu import cli as jcli
from sparknet_tpu.proto import Message as JMessage
from sparknet_tpu.resilience import checkpoint as jcheckpoint
from sparknet_tpu.resilience.recovery import RecoveryAbort as JAbort
from sparknet_tpu.solver.solver import Solver as JSolver
from sparknet_tpu.utils.signals import SignalPolicy as JSignalPolicy
from sparknet_tpu.utils.watchdog import Watchdog as JWatchdog
from sparknet_tpu_torch import cli
from sparknet_tpu_torch.models import dsl
from sparknet_tpu_torch.proto import Message, text_format
from sparknet_tpu_torch.resilience import checkpoint
from sparknet_tpu_torch.resilience.recovery import RecoveryAbort
from sparknet_tpu_torch.solver import Solver
from sparknet_tpu_torch.utils.exit_codes import (EXIT_RECOVERY_ABORT,
                                                 EXIT_WATCHDOG_STALL)
from sparknet_tpu_torch.utils.signals import SignalPolicy
from sparknet_tpu_torch.utils.watchdog import Watchdog

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
B, D = 4, 16

# a pass-through layer that stalls or turns its input non-finite from its
# N-th call on (param_str "stall:N" / "nan:N"), or pauses S seconds at
# its N-th call only ("pause:N:S"): a feed that hangs, a batch that blows
# the loss up, a feed that hiccups once
TAP = '''
import time


class Tap:
    def setup(self, bottom_shapes):
        mode, at, *rest = self.param_str.split(":")
        self.mode, self.at, self.calls = mode, int(at), 0
        self.pause_s = float(rest[0]) if rest else 0.0

    def reshape(self, bottom_shapes):
        return [bottom_shapes[0]]

    def forward(self, params, bottoms):
        self.calls += 1
        x = bottoms[0]
        if self.calls >= self.at and self.mode == "stall":
            time.sleep(600)
        if self.calls == self.at and self.mode == "pause":
            time.sleep(self.pause_s)
        if self.calls >= self.at and self.mode == "nan":
            return [x * float("nan")]
        return [x]
'''


def _net(tap=None):
    layers = [dsl.RDDLayer("data", (B, D)), dsl.RDDLayer("label", (B,))]
    bottom = "data"
    if tap:
        lp = Message("LayerParameter", name="tap", type="Python")
        lp.bottom.append("data")
        lp.top.append("tapped")
        lp.python_param = Message("PythonParameter", module="tap_layer",
                                  layer="Tap", param_str=tap)
        layers.append(lp)
        bottom = "tapped"
    filler = dict(type="gaussian", std=0.3)
    layers += [dsl.InnerProductLayer("ip1", [bottom], 32,
                                     weight_filler=filler),
               dsl.ReLULayer("relu", ["ip1"], tops=["ip1"]),
               dsl.InnerProductLayer("ip2", ["ip1"], 10,
                                     weight_filler=filler),
               dsl.SoftmaxWithLoss("loss", ["ip2", "label"])]
    return dsl.NetParam("tiny", *layers)


def _jnet():
    """The JAX package's twin of _net() without the tap."""
    from sparknet_tpu.models import dsl as jdsl
    filler = dict(type="gaussian", std=0.3)
    return jdsl.NetParam(
        "tiny", jdsl.RDDLayer("data", (B, D)), jdsl.RDDLayer("label", (B,)),
        jdsl.InnerProductLayer("ip1", ["data"], 32, weight_filler=filler),
        jdsl.ReLULayer("relu", ["ip1"], tops=["ip1"]),
        jdsl.InnerProductLayer("ip2", ["ip1"], 10, weight_filler=filler),
        jdsl.SoftmaxWithLoss("loss", ["ip2", "label"]))


def _solvers(**kw):
    """A port and a JAX Solver on the tiny net (fresh weights)."""
    tsp, jsp = _sp(Message, **kw), _sp(JMessage, **kw)
    tsp.net_param, jsp.net_param = _net(), _jnet()
    return Solver(tsp, device="cpu", log_fn=None), JSolver(jsp, log_fn=None)


def _sp(message, prefix=None, **kw):
    fields = dict(base_lr=0.1, lr_policy="fixed", momentum=0.9,
                  display=1, random_seed=3, max_iter=1000)
    fields.update(kw)
    sp = message("SolverParameter", **fields)
    if prefix:
        sp.snapshot_prefix = prefix
    return sp


def _solver_file(tmp_path, prefix, tap=None, **kw):
    sp = _sp(Message, prefix, **kw)
    sp.net_param = _net(tap)
    path = tmp_path / "solver.prototxt"
    text_format.dump(sp, str(path))
    (tmp_path / "tap_layer.py").write_text(TAP)
    return str(path)


def _batches(seed=0, nan_at=(), nan_from=None, n=1000):
    """Batches of the tiny net; those at ``nan_at`` (indices) and from
    ``nan_from`` on are NaN."""
    rs = np.random.RandomState(seed)
    for i in range(n):
        data = rs.randn(B, D).astype(np.float32)
        if i in nan_at or (nan_from is not None and i >= nan_from):
            data[:] = np.nan
        yield {"data": data,
               "label": rs.randint(0, 10, B).astype(np.int32)}


def _env(tmp_path):
    env = dict(os.environ, PYTHONUNBUFFERED="1",
               SPARKNET_PYTHON_LAYER_PATH=str(tmp_path),
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    return env


# -- the signal policy -----------------------------------------------------

@pytest.mark.parametrize("effects", [
    ("stop", "snapshot", "snapshot_stop"), ("none", "none", "stop"),
    ("snapshot_stop", "stop", "none")])
def test_signal_policy_records_as_in_jax(effects):
    sigint, sighup, sigterm = effects
    seqs = []
    for cls in (SignalPolicy, JSignalPolicy):
        p = cls(sigint=sigint, sighup=sighup, sigterm=sigterm)
        for s in (signal.SIGHUP, signal.SIGTERM, signal.SIGHUP):
            p._handler(s, None)
        seqs.append([p.pending() for _ in range(4)])
    assert seqs[0] == seqs[1]
    with pytest.raises(ValueError, match="unknown signal action"):
        SignalPolicy(sigterm="explode")


def _sigterm_run(argv, env, tmp_path):
    """Start a train verb, SIGTERM it once it has printed its third
    iteration; -> (exit code, output)."""
    p = subprocess.Popen(argv, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True, env=env,
                         cwd=str(tmp_path))
    out = []
    try:
        for line in p.stdout:
            out.append(line)
            if line.startswith("Iteration 2,"):
                p.send_signal(signal.SIGTERM)
                break
        out.append(p.communicate(timeout=180)[0])
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    return p.returncode, "".join(out)


def test_sigterm_snapshots_stops_and_resumes_as_in_jax(tmp_path):
    """SIGTERM (snapshot_stop) in both train verbs: each finishes its
    100-iteration block, snapshots iteration 100 and exits 0; --resume
    auto then restores iteration 100 from either package's prefix."""
    for module, extra in (("sparknet_tpu_torch", ["--device", "cpu"]),
                          ("sparknet_tpu", [])):
        d = tmp_path / module
        d.mkdir()
        solver = _solver_file(d, str(d / "snap" / "s"))
        rc, out = _sigterm_run(
            [sys.executable, "-m", module, "train", "--solver", solver,
             "--iterations", "100000", *extra], _env(d), d)
        assert rc == 0, (module, out[-2000:])
        assert "stopping early on signal" in out, module
        assert "Optimization done, iter=100" in out, module
        assert checkpoint.load_manifest(
            str(d / "snap" / "s"))["latest"]["iter"] == 100
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli.main(["train", "--solver", solver, "--device", "cpu",
                             "--resume", "auto", "--iterations", "101"]) == 0
        assert "resume auto: restored iter 100" in buf.getvalue()
        assert "Optimization done, iter=101" in buf.getvalue()


# -- the watchdog's kill path ------------------------------------------------

KILL_SCRIPT = '''
import sys, time
import numpy as np
pkg, prefix = sys.argv[1], sys.argv[2]
if pkg == "port":
    from sparknet_tpu_torch.models import dsl
    from sparknet_tpu_torch.proto import Message
    from sparknet_tpu_torch.solver import Solver
    kw = dict(device="cpu")
else:
    from sparknet_tpu.models import dsl
    from sparknet_tpu.proto import Message
    from sparknet_tpu.solver.solver import Solver
    kw = {}
net = dsl.NetParam("tiny", dsl.RDDLayer("data", (4, 16)),
                   dsl.RDDLayer("label", (4,)),
                   dsl.InnerProductLayer("ip", ["data"], 10,
                                         weight_filler=dict(type="xavier")),
                   dsl.SoftmaxWithLoss("loss", ["ip", "label"]))
sp = Message("SolverParameter", base_lr=0.1, lr_policy="fixed", display=1,
             random_seed=3, snapshot_prefix=prefix)
s = Solver(sp, net_param=net, log_fn=print, metrics=prefix + ".jsonl",
           **kw)
s.arm_watchdog(stall_seconds=3.0, poll_seconds=0.1, kill_on_stall=True)

def feed():
    rs = np.random.RandomState(0)
    for i in range(1000):
        if i == 3:
            time.sleep(600)            # the feed hangs before step 4
        yield {"data": rs.randn(4, 16).astype(np.float32),
               "label": rs.randint(0, 10, 4).astype(np.int32)}
s.step(10, feed())
print("NOT REACHED")
'''


def test_watchdog_kills_with_exit_42_and_a_restorable_snapshot(tmp_path):
    """A feed that hangs before step 4: both packages' solvers, armed
    with kill_on_stall, take an emergency snapshot of iteration 3, log
    the kill and exit 42; the snapshot restores in either package."""
    script = tmp_path / "kill.py"
    script.write_text(KILL_SCRIPT)
    procs = {}
    for pkg in ("port", "jax"):
        (tmp_path / pkg).mkdir()
        procs[pkg] = subprocess.Popen(
            [sys.executable, str(script), pkg, str(tmp_path / pkg / "s")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=_env(tmp_path))
    outs = {}
    try:
        for pkg, p in procs.items():
            outs[pkg] = p.communicate(timeout=180)[0]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for pkg, p in procs.items():
        assert p.returncode == EXIT_WATCHDOG_STALL, (pkg, outs[pkg][-2000:])
        assert "NOT REACHED" not in outs[pkg]
    for pkg, prefix in (("port", tmp_path / "port" / "s"),
                        ("jax", tmp_path / "jax" / "s")):
        kills = [e for e in map(json.loads, open(f"{prefix}.jsonl"))
                 if e["event"] == "watchdog"]
        assert [e["kind"] for e in kills] == ["stall", "killed"], pkg
        assert kills[-1]["exit_code"] == 42
        assert kills[-1]["emergency_snapshot_ok"] is True
        assert checkpoint.load_manifest(str(prefix))["latest"]["iter"] == 3
    # either package restores either package's emergency snapshot
    for pkg in ("port", "jax"):
        prefix = str(tmp_path / pkg / "s")
        tsp, jsp = _sp(Message), _sp(JMessage)
        tsp.net_param = dsl.NetParam(
            "tiny", dsl.RDDLayer("data", (4, 16)),
            dsl.RDDLayer("label", (4,)),
            dsl.InnerProductLayer("ip", ["data"], 10),
            dsl.SoftmaxWithLoss("loss", ["ip", "label"]))
        from sparknet_tpu.models import dsl as jdsl
        jsp.net_param = jdsl.NetParam(
            "tiny", jdsl.RDDLayer("data", (4, 16)),
            jdsl.RDDLayer("label", (4,)),
            jdsl.InnerProductLayer("ip", ["data"], 10),
            jdsl.SoftmaxWithLoss("loss", ["ip", "label"]))
        ts, js = Solver(tsp, device="cpu", log_fn=None), \
            JSolver(jsp, log_fn=None)
        assert checkpoint.resume_auto(ts, prefix) and ts.iter == 3
        assert jcheckpoint.resume_auto(js, prefix) and js.iter == 3
        for n, ps in ts.params.items():
            for p, q in zip(ps, js.params[n]):
                np.testing.assert_array_equal(p.detach().numpy(),
                                              np.asarray(q))


PAUSE_SCRIPT = '''
import sys, time
import numpy as np
pkg, prefix = sys.argv[1], sys.argv[2]
if pkg == "port":
    from sparknet_tpu_torch.models import dsl
    from sparknet_tpu_torch.proto import Message
    from sparknet_tpu_torch.solver import Solver
    kw = dict(device="cpu")
else:
    from sparknet_tpu.models import dsl
    from sparknet_tpu.proto import Message
    from sparknet_tpu.solver.solver import Solver
    kw = {}
net = dsl.NetParam("tiny", dsl.RDDLayer("data", (4, 16)),
                   dsl.RDDLayer("label", (4,)),
                   dsl.InnerProductLayer("ip", ["data"], 10,
                                         weight_filler=dict(type="xavier")),
                   dsl.SoftmaxWithLoss("loss", ["ip", "label"]))
sp = Message("SolverParameter", base_lr=0.1, lr_policy="fixed", display=1,
             random_seed=3, snapshot_prefix=prefix)
s = Solver(sp, net_param=net, log_fn=print, metrics=prefix + ".jsonl",
           **kw)
s.arm_watchdog(stall_seconds=1.0)          # as the JAX train verb arms it

def feed():
    rs = np.random.RandomState(0)
    for i in range(8):
        if i == 3:
            time.sleep(3.0)            # the feed hiccups before step 4
        yield {"data": rs.randn(4, 16).astype(np.float32),
               "label": rs.randint(0, 10, 4).astype(np.int32)}
s.step(8, feed())
s.close()
print("DONE", s.iter)
'''


def test_train_verb_stall_logs_as_the_jax_verb(tmp_path):
    """--stall-seconds arms the watchdog as the JAX train verb does
    (``arm_watchdog(stall_seconds=...)``, no kill): a layer that pauses
    3 s once under a 1 s watchdog gives ``stall`` events and nothing
    else, and the verb trains on to its end with exit 0 — the events
    and the ending that both packages' Solvers give when armed that way
    on a feed that pauses as long."""
    script = tmp_path / "pause.py"
    script.write_text(PAUSE_SCRIPT)
    verb = tmp_path / "verb"
    verb.mkdir()
    solver = _solver_file(verb, str(verb / "snap" / "s"), tap="pause:4:3",
                          max_iter=8)
    procs = {"verb": subprocess.Popen(
        [sys.executable, "-m", "sparknet_tpu_torch", "train", "--solver",
         solver, "--device", "cpu", "--stall-seconds", "1",
         "--metrics", str(verb / "m.jsonl")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_env(verb), cwd=str(verb))}
    for pkg in ("port", "jax"):
        (tmp_path / pkg).mkdir()
        procs[pkg] = subprocess.Popen(
            [sys.executable, str(script), pkg, str(tmp_path / pkg / "s")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=_env(tmp_path))
    outs = {}
    try:
        for pkg, p in procs.items():
            outs[pkg] = p.communicate(timeout=180)[0]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    kinds = {}
    for pkg, p in procs.items():
        assert p.returncode == 0, (pkg, outs[pkg][-2000:])
        stream = verb / "m.jsonl" if pkg == "verb" else \
            tmp_path / pkg / "s.jsonl"
        kinds[pkg] = {e["kind"] for e in map(json.loads, open(stream))
                      if e["event"] == "watchdog"}
    assert "Optimization done, iter=8" in outs["verb"]
    assert "DONE 8" in outs["port"] and "DONE 8" in outs["jax"]
    assert kinds["verb"] == kinds["port"] == kinds["jax"] == {"stall"}, kinds


@pytest.mark.parametrize("package", ["port", "jax"])
def test_watchdog_kill_path_in_process(package, tmp_path):
    """The kill path with an injected exit: the stall event, the
    emergency snapshot, the killed event, the exit code — the same
    events in both packages."""
    cls = Watchdog if package == "port" else JWatchdog
    events, exits, snaps = [], [], []

    class Sink:
        def log(self, event, **f):
            events.append((event, f.get("kind"), f.get("exit_code"),
                           f.get("emergency_snapshot_ok")))

        def close(self):
            pass

    wd = cls(stall_seconds=0.1, poll_seconds=0.02, kill_on_stall=True,
             metrics=Sink(), on_stall=lambda dt: None,
             emergency_snapshot=lambda: snaps.append(1) or "p",
             exit_fn=exits.append).start()
    wd.beat(float("nan"))
    deadline = time.time() + 10
    while not exits and time.time() < deadline:
        time.sleep(0.02)
    wd.stop()
    assert exits[0] == 42 and snaps
    assert events[:3] == [("watchdog", "nan", None, None),
                          ("watchdog", "stall", None, None),
                          ("watchdog", "killed", 42, True)]


# -- divergence recovery -----------------------------------------------------

class _Sink:
    def __init__(self):
        self.events = []

    def log(self, event, **fields):
        self.events.append(dict(fields, event=event))


def _pair(tmp_path, **kw):
    """A port and a JAX Solver on the tiny net from the same weights,
    each with its own metrics sink."""
    ts, js = _solvers(**kw)
    ts.metrics, js.metrics = _Sink(), _Sink()
    _, state = js.snapshot(str(tmp_path / "start"))
    ts.restore(state)
    return js, ts, js.metrics.events, ts.metrics.events


def _recovery(sink):
    return [(e["kind"], e.get("to_iter"), e.get("attempt"),
             e.get("lr_decay")) for e in sink if e["event"] == "recovery"]


def test_recovery_rolls_back_and_decays_lr_as_in_jax(tmp_path):
    """A NaN batch at step 4 (index 3): both solvers roll back to the
    last good iteration (3), halve the lr and go on; the same recovery
    events, iterations, lrs and losses (within 1e-5)."""
    js, ts, jsink, tsink = _pair(tmp_path)
    js.arm_recovery(max_rollbacks=2, lr_decay=0.5)
    ts.arm_recovery(max_rollbacks=2, lr_decay=0.5)
    js.step(7, _batches(nan_at=(3,)))
    ts.step(7, _batches(nan_at=(3,)))
    assert _recovery(tsink) == _recovery(jsink) == \
        [("rollback", 3, 1, 0.5)]
    assert ts.iter == js.iter == 6
    jt = [(e["iter"], e["lr"], e["loss"]) for e in jsink
          if e["event"] == "train"]
    tt = [(e["iter"], e["lr"], e["loss"]) for e in tsink
          if e["event"] == "train"]
    assert [x[:2] for x in tt] == [x[:2] for x in jt]
    assert [x[1] for x in tt] == pytest.approx([0.1] * 3 + [0.05] * 3)
    np.testing.assert_allclose([x[2] for x in tt], [x[2] for x in jt],
                               rtol=1e-5)
    assert all(np.isfinite(x[2]) for x in tt)


def test_recovery_aborts_after_its_budget_as_in_jax(tmp_path):
    js, ts, jsink, tsink = _pair(tmp_path)
    js.arm_recovery(max_rollbacks=2)
    ts.arm_recovery(max_rollbacks=2)
    with pytest.raises(JAbort):
        js.step(20, _batches(nan_from=3))
    with pytest.raises(RecoveryAbort, match="diverged at iter 4"):
        ts.step(20, _batches(nan_from=3))
    assert _recovery(tsink) == _recovery(jsink) == [
        ("rollback", 3, 1, 1.0), ("rollback", 3, 2, 1.0),
        ("abort", None, None, None)]


def test_train_verb_recovery_abort_exits_3(tmp_path, monkeypatch, capsys):
    """--recover 2 on a layer that turns the input non-finite from its
    4th call on: two rollbacks, then ABORT and exit 3, and no snapshot
    written after the abort."""
    monkeypatch.setenv("SPARKNET_PYTHON_LAYER_PATH", str(tmp_path))
    solver = _solver_file(tmp_path, str(tmp_path / "snap" / "s"),
                          tap="nan:4", snapshot=2)
    rc = cli.main(["train", "--solver", solver, "--device", "cpu",
                   "--iterations", "10", "--recover", "2",
                   "--recover-lr-decay", "0.5"])
    out = capsys.readouterr().out
    assert rc == EXIT_RECOVERY_ABORT
    assert out.count("rolled back to iter 3") == 2 and "ABORT:" in out
    assert "lr x0.5" in out
    assert checkpoint.load_manifest(
        str(tmp_path / "snap" / "s"))["latest"]["iter"] == 2


def test_recovery_rolls_back_the_slot_solver(tmp_path):
    """LocalSGDSolver.run with recovery: a NaN round is rolled back and
    redone from the stacked slots' known-good copy."""
    from sparknet_tpu_torch.parallel import LocalSGDSolver
    sp = _sp(Message, display=0)
    sp.net_param = _net()
    s = LocalSGDSolver(sp, workers=2, tau=2, device="cpu", log_fn=None)
    s.arm_recovery(max_rollbacks=3)
    rs = np.random.RandomState(0)
    calls = []

    def batch_fn(tau):
        calls.append(1)
        data = rs.randn(tau, 2 * B, D).astype(np.float32)
        if len(calls) == 2:
            data[:] = np.nan
        return {"data": data,
                "label": rs.randint(0, 10, (tau, 2 * B)).astype(np.int32)}

    loss = s.run(3, batch_fn)
    assert np.isfinite(loss) and s.iter == 6 and len(calls) == 4
    assert s.recovery.rollbacks == 1
    assert all(torch.isfinite(P).all() for ps in s.slot_params.values()
               for P in ps)


# -- keep-N retention and resume_auto's fallback -----------------------------

def _snapshots(tmp_path, main, extra):
    prefix = str(tmp_path / "snap" / "s")
    solver = _solver_file(tmp_path, prefix, snapshot=2)
    with contextlib.redirect_stdout(io.StringIO()):
        assert main(["train", "--solver", solver, "--iterations", "6",
                     "--keep", "2", *extra]) == 0
    return prefix


@pytest.mark.parametrize("package", ["port", "jax"])
def test_keep_2_and_resume_auto_fallback_on_the_same_prefix(tmp_path,
                                                            package):
    """--keep 2 leaves iterations 4 and 6 in both packages; with the
    newest pair deleted behind the manifest's back, and with a restore
    that fails after the check, both packages' resume_auto fall back to
    iteration 4 and say why."""
    main, extra = (cli.main, ["--device", "cpu"]) if package == "port" \
        else (jcli.main, [])
    prefix = _snapshots(tmp_path, main, extra)
    man = checkpoint.load_manifest(prefix)
    assert [e["iter"] for e in man["snapshots"]] == [4, 6]
    assert not os.path.exists(f"{prefix}_iter_2.caffemodel")
    # a restore that fails after the check (a concurrent pruner)
    newest = os.path.join(os.path.dirname(prefix), man["latest"]["state"])
    for s, resume in zip(_solvers(), (checkpoint.resume_auto,
                                      jcheckpoint.resume_auto)):
        real = s.restore

        def racy(path, real=real):
            if path == newest:
                raise OSError(f"{path}: vanished mid-restore")
            return real(path)
        s.restore = racy
        logs = []
        assert resume(s, prefix, log_fn=logs.append).endswith(
            "_iter_4.solverstate")
        assert s.iter == 4
        assert any("restore failed" in m and "falling back" in m
                   for m in logs)
    # the newest pair's files gone, its manifest entry still there
    for k in ("model", "state"):
        os.remove(os.path.join(os.path.dirname(prefix), man["latest"][k]))
    for s, resume in zip(_solvers(), (checkpoint.resume_auto,
                                      jcheckpoint.resume_auto)):
        logs = []
        assert resume(s, prefix, log_fn=logs.append)
        assert s.iter == 4 and any("missing" in m for m in logs)
