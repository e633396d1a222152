"""The port's solver against the JAX package's on the CPU: lr policies,
every update rule, the solver end to end from the same snapshot (with the
conv epilogue fused and not), .caffemodel/.solverstate interchange in
both directions, and the ``train`` verb with ``--resume auto``.

Inputs and batches are made with numpy from a seed and handed to both
packages. Tolerances:
  * lr policies: rtol=2e-6 (the JAX package evaluates them in f32, the
    port in f64);
  * updates: rtol=1e-5, atol=1e-6 after 3 steps (both f32, same formula
    order; clipping norms sum in another order, Adam's bias correction
    is f64 here and f32 there);
  * solver end to end: losses rtol=1e-4, params rtol=1e-4 with atol=1e-5
    of each blob's largest value (XLA:CPU and PyTorch's CPU convolutions
    sum in different orders, and 3 steps of momentum carry it).
Dropout runs at ratio 0 in the parity nets: the two packages' masks come
from different generators.
"""

import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from sparknet_tpu.graph.upgrade import upgrade_solver as j_upgrade_solver
from sparknet_tpu.models import dsl as jdsl, zoo as jzoo
from sparknet_tpu.proto import Message as JMessage
from sparknet_tpu.solver import Solver as JSolver
from sparknet_tpu.solver.lr_policy import make_lr_fn as j_make_lr_fn
from sparknet_tpu.solver.updates import Updater as JUpdater
from sparknet_tpu_torch import cli
from sparknet_tpu_torch.graph import history_from_numpy, params_from_numpy
from sparknet_tpu_torch.graph.upgrade import upgrade_solver
from sparknet_tpu_torch.models import dsl as tdsl, zoo as tzoo
from sparknet_tpu_torch.proto import Message as TMessage, text_format
from sparknet_tpu_torch.solver import Solver as TSolver
from sparknet_tpu_torch.solver.lr_policy import make_lr_fn
from sparknet_tpu_torch.solver.updates import SOLVER_TYPES, Updater

POLICIES = [
    ("fixed", {}),
    ("step", dict(gamma=0.5, stepsize=3)),
    ("exp", dict(gamma=0.9)),
    ("inv", dict(gamma=1e-2, power=0.75)),
    ("multistep", dict(gamma=0.3, stepvalue=[2, 5, 9])),
    ("poly", dict(power=2.0, max_iter=20)),
    ("sigmoid", dict(gamma=-0.5, stepsize=6)),
]


@pytest.mark.parametrize("policy,fields", POLICIES,
                         ids=[p for p, _ in POLICIES])
def test_lr_policy_matches_jax(policy, fields):
    jf = j_make_lr_fn(JMessage("SolverParameter", base_lr=0.01,
                               lr_policy=policy, **fields))
    tf = make_lr_fn(TMessage("SolverParameter", base_lr=0.01,
                             lr_policy=policy, **fields))
    for it in (0, 1, 2, 3, 5, 8, 9, 13, 19):
        ref = float(jf(jnp.asarray(it, jnp.int32)))
        assert isinstance(tf(it), float)
        np.testing.assert_allclose(tf(it), ref, rtol=2e-6, err_msg=str(it))


def test_unknown_lr_policy_raises():
    with pytest.raises(ValueError, match="lr_policy"):
        make_lr_fn(TMessage("SolverParameter", lr_policy="cosine"))


def test_upgrade_solver_matches_jax():
    for t in range(len(SOLVER_TYPES)):
        j = j_upgrade_solver(JMessage("SolverParameter", solver_type=t))
        u = upgrade_solver(TMessage("SolverParameter", solver_type=t))
        assert u.type == j.type == SOLVER_TYPES[t]
        assert not u.has("solver_type")
    with pytest.raises(ValueError, match="both"):
        upgrade_solver(TMessage("SolverParameter", solver_type=1,
                                type="Adam"))


# -- update rules ----------------------------------------------------------
SHAPES = {"a": [(3, 4), (3,)], "b": [(2, 2, 3)]}
MULTS = {"a": [(1.0, 1.0), (2.0, 0.0)], "b": [(0.5, 2.0)]}
MOMENTUM = {"SGD": 0.9, "Nesterov": 0.9, "AdaGrad": 0.0, "RMSProp": 0.0,
            "AdaDelta": 0.95, "Adam": 0.9}


def _updater_sp(message, solver_type, reg, clip, iter_size):
    sp = message("SolverParameter", type=solver_type, weight_decay=5e-3,
                 regularization_type=reg, clip_gradients=clip,
                 iter_size=iter_size, rms_decay=0.98)
    if MOMENTUM[solver_type]:
        sp.momentum = MOMENTUM[solver_type]
    if solver_type == "AdaDelta":
        sp.delta = 1e-6
    return sp


@pytest.mark.parametrize("iter_size", [1, 2])
@pytest.mark.parametrize("clip", [-1.0, 0.5], ids=["noclip", "clip"])
@pytest.mark.parametrize("reg", ["L1", "L2"])
@pytest.mark.parametrize("solver_type", SOLVER_TYPES)
def test_update_rule_matches_jax(solver_type, reg, clip, iter_size):
    # with RandomState(7) one element's regularized gradient cancels to
    # 6e-8, where AdaGrad's g / (sqrt(h) + delta) amplifies f32 rounding
    # past any tolerance; this seed has no such element in any case
    rs = np.random.RandomState(11)
    params_np = {k: [rs.randn(*s).astype(np.float32) for s in v]
                 for k, v in SHAPES.items()}
    ju = JUpdater(_updater_sp(JMessage, solver_type, reg, clip, iter_size),
                  MULTS)
    tu = Updater(_updater_sp(TMessage, solver_type, reg, clip, iter_size),
                 MULTS)
    jp = {k: [jnp.asarray(a) for a in v] for k, v in params_np.items()}
    tp = {k: [torch.from_numpy(a.copy()) for a in v]
          for k, v in params_np.items()}
    jh, th = ju.init(jp), tu.init(tp)
    for it in range(3):
        grads = {k: [rs.randn(*s).astype(np.float32) for s in v]
                 for k, v in SHAPES.items()}
        rate = 0.1 * 0.9 ** it
        jp, jh = ju(jp, {k: [jnp.asarray(g) for g in v]
                         for k, v in grads.items()}, jh, rate, it)
        tu(tp, {k: [torch.from_numpy(g) for g in v]
                for k, v in grads.items()}, th, rate, it)
    for k in SHAPES:
        for i in range(len(SHAPES[k])):
            np.testing.assert_allclose(tp[k][i].numpy(), np.asarray(jp[k][i]),
                                       rtol=1e-5, atol=1e-6)
            assert len(th[k][i]) == len(jh[k][i])
            for a, b in zip(th[k][i], jh[k][i]):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-5, atol=1e-6)


# -- the solver end to end -------------------------------------------------
def small_net(dsl, zoo):
    """A standalone ACROSS LRN after conv -> ReLU -> pool (C = 4 < n = 5),
    a conv -> ReLU -> LRN epilogue site, a pool, an aux loss head at
    weight 0.3, Dropout at ratio 0 and SoftmaxWithLoss."""
    aux = dsl.SoftmaxWithLoss("aux/loss", ["aux/fc", "label"])
    aux.clear("top")
    aux.top.append("aux/loss1")
    aux.loss_weight.append(0.3)
    return dsl.NetParam(
        "SmallNet",
        dsl.RDDLayer("data", [2, 3, 12, 12]), dsl.RDDLayer("label", [2]),
        zoo._gconv("conv1", "data", 4, 3, pad=1),
        dsl.ReLULayer("relu1", ["conv1"], tops=["conv1"]),
        dsl.PoolingLayer("pool1", ["conv1"], "MAX", (2, 2), (2, 2)),
        dsl.LRNLayer("norm1", ["pool1"], local_size=5, alpha=0.1,
                     beta=0.75),
        zoo._gconv("conv2", "norm1", 6, 3, pad=1),
        dsl.ReLULayer("relu2", ["conv2"], tops=["conv2"]),
        dsl.LRNLayer("norm2", ["conv2"], local_size=3, alpha=0.05,
                     beta=0.75),
        dsl.PoolingLayer("pool2", ["norm2"], "MAX", (2, 2), (2, 2)),
        zoo._fc("aux/fc", "pool2", 10, w_type="xavier"),
        aux,
        dsl.DropoutLayer("drop", ["pool2"], tops=["pool2"], ratio=0.0),
        zoo._fc("fc", "pool2", 10, w_type="xavier", bias_value=0.1),
        dsl.SoftmaxWithLoss("loss", ["fc", "label"]))


def _solver_sp(message, solver_type="SGD"):
    sp = message("SolverParameter", base_lr=0.05, lr_policy="step",
                 gamma=0.5, stepsize=2, momentum=0.9, weight_decay=5e-4,
                 type=solver_type, random_seed=1, display=0)
    return sp


def _batches(n, seed=3):
    rs = np.random.RandomState(seed)
    return [{"data": rs.randn(2, 3, 12, 12).astype(np.float32),
             "label": rs.randint(0, 10, 2).astype(np.int32)}
            for _ in range(n)]


def _jax_solver(solver_type="SGD"):
    return JSolver(_solver_sp(JMessage, solver_type),
                   net_param=small_net(jdsl, jzoo), log_fn=None)


def _port_solver(solver_type="SGD"):
    return TSolver(_solver_sp(TMessage, solver_type),
                   net_param=small_net(tdsl, tzoo), device="cpu",
                   log_fn=None)


def _assert_states_close(ts, js, rtol=1e-4, atol_scale=1e-5):
    assert ts.iter == js.iter
    for name, blobs in js.params.items():
        for i, ref in enumerate(blobs):
            ref = np.asarray(ref)
            got = ts.params[name][i].detach().numpy()
            np.testing.assert_allclose(
                got, ref, rtol=rtol,
                atol=atol_scale * max(float(np.abs(ref).max()), 1e-30),
                err_msg=f"{name}[{i}]")
            for a, b in zip(ts.history[name][i], js.history[name][i]):
                b = np.asarray(b)
                np.testing.assert_allclose(
                    a.numpy(), b, rtol=rtol,
                    atol=atol_scale * max(float(np.abs(b).max()), 1e-30),
                    err_msg=f"history {name}[{i}]")


def _train_both(ts, js, batches):
    for b in batches:
        jl = float(js.train_step(b))
        tl = float(ts.train_step(b))
        assert np.isfinite(tl)
        np.testing.assert_allclose(tl, jl, rtol=1e-4)


@pytest.mark.parametrize("mode", ["off", "on"])
def test_solver_matches_jax_from_a_jax_snapshot(tmp_path, monkeypatch,
                                                mode):
    monkeypatch.setenv("SPARKNET_EPILOGUE", mode)
    batches = _batches(4)
    js = _jax_solver()
    js.train_step(batches[0])          # the momentum history is not zero
    _, state = js.snapshot(str(tmp_path / "jax"))
    ts = _port_solver()
    ts.restore(state)
    _assert_states_close(ts, js, rtol=0, atol_scale=0)   # the same bits
    _train_both(ts, js, batches[1:])
    _assert_states_close(ts, js)


@pytest.mark.parametrize("solver_type", ["SGD", "Adam"])
def test_port_snapshot_restores_in_jax(tmp_path, solver_type):
    batches = _batches(3, seed=4)
    ts = _port_solver(solver_type)
    ts.train_step(batches[0])
    model, state = ts.snapshot(str(tmp_path / "port"))
    assert os.path.exists(model) and os.path.exists(state)
    js = _jax_solver(solver_type)
    js.restore(state)
    _assert_states_close(ts, js, rtol=0, atol_scale=0)
    _train_both(ts, js, batches[1:])
    _assert_states_close(ts, js)


def test_history_from_numpy_starts_from_jax_state():
    batches = _batches(3, seed=5)
    js = _jax_solver("Adam")
    js.train_step(batches[0])
    ts = _port_solver("Adam")
    ts.params, _ = params_from_numpy(
        ts.net, jax.tree.map(np.asarray, js.params))
    ts._arm_grads()
    ts.history = history_from_numpy(ts.net, "adam",
                                    jax.tree.map(np.asarray, js.history))
    ts.iter = js.iter
    _assert_states_close(ts, js, rtol=0, atol_scale=0)
    _train_both(ts, js, batches[1:])
    _assert_states_close(ts, js)
    with pytest.raises(ValueError, match="slots"):
        history_from_numpy(ts.net, "SGD",
                           jax.tree.map(np.asarray, js.history))


def test_restore_refuses_another_solver_type(tmp_path):
    ts = _port_solver("Adam")
    _, state = ts.snapshot(str(tmp_path / "adam"))
    with pytest.raises(ValueError, match="different solver type"):
        _port_solver("SGD").restore(state)


def test_solver_learns_a_fixed_batch():
    ts = _port_solver()
    b = _batches(1, seed=6)[0]
    losses = [float(ts.train_step(b)) for _ in range(8)]
    assert losses[-1] < 0.5 * losses[0]


# -- the train verb --------------------------------------------------------
def test_cli_train_snapshots_and_resumes(tmp_path, capsys):
    sp = _solver_sp(TMessage)
    sp.net_param = small_net(tdsl, tzoo)
    sp.display = 1
    sp.snapshot = 2
    sp.snapshot_prefix = str(tmp_path / "snap")
    path = tmp_path / "solver.prototxt"
    text_format.dump(sp, str(path))
    base = ["train", "--solver", str(path), "--device", "cpu"]
    assert cli.main(base + ["--iterations", "3"]) == 0
    out = capsys.readouterr().out
    assert "Iteration 0, loss = " in out and "iter=3" in out
    for it in (2, 3):
        assert (tmp_path / f"snap_iter_{it}.caffemodel").exists()
        assert (tmp_path / f"snap_iter_{it}.solverstate").exists()
    assert cli.main(base + ["--iterations", "5", "--resume", "auto"]) == 0
    out = capsys.readouterr().out
    assert "resume auto: restored iter 3" in out
    assert "Iteration 3, loss = " in out and "Iteration 0," not in out
    assert "Optimization done, iter=5" in out
    assert (tmp_path / "snap_iter_5.solverstate").exists()
    # the last line counts the CUDA kernels' launches: none on the CPU
    last = out.strip().splitlines()[-1]
    assert last.startswith("Kernel launches: ")
    counts = json.loads(last[len("Kernel launches: "):])
    assert set(counts) == {"lrn_across", "lrn_across_bwd", "bias_relu_lrn",
                           "bias_relu_lrn_bwd", "bias_relu", "flash_attention",
                           "flash_attention_dq", "flash_attention_dkv"}
    assert not any(counts.values())


def test_card_device_turns_tf32_off(monkeypatch):
    """Every entry point resolves its device through resolve_device, which
    turns TF32 off on the card (float32 as in the JAX package) and leaves
    the settings alone for the CPU."""
    from sparknet_tpu_torch.device import resolve_device
    flags = (torch.backends.cudnn, torch.backends.cuda.matmul)
    saved = [f.allow_tf32 for f in flags]
    try:
        for f in flags:
            f.allow_tf32 = True
        assert resolve_device("cpu").type == "cpu"
        assert all(f.allow_tf32 for f in flags)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        assert resolve_device("cuda").type == "cuda"
        assert not any(f.allow_tf32 for f in flags)
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v


def test_resume_auto_skips_a_corrupt_snapshot_and_refuses_another_world(
        tmp_path):
    from sparknet_tpu_torch.resilience import (WorldMismatch, manifest_path,
                                               resume_auto)
    prefix = str(tmp_path / "snap")
    ts = _port_solver()
    b = _batches(2, seed=7)
    for batch in b:
        ts.train_step(batch)
        ts.snapshot(prefix)
    with open(f"{prefix}_iter_2.solverstate", "r+b") as f:
        f.truncate(10)                       # a torn write of iter 2
    fresh = _port_solver()
    log = []
    assert resume_auto(fresh, prefix, log_fn=log.append).endswith(
        "snap_iter_1.solverstate")
    assert fresh.iter == 1
    assert any("refusing snapshot" in m and "iter_2" in m for m in log)
    man = json.load(open(manifest_path(prefix)))
    for e in man["snapshots"]:
        e["world"] = {"processes": 4}
    json.dump(man, open(manifest_path(prefix), "w"))
    with pytest.raises(WorldMismatch, match="process count 4"):
        resume_auto(_port_solver(), prefix)
