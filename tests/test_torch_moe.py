"""The port's Switch-MoE layer and the MoE LM against the JAX package's on
the CPU: the layer (forward, every top, gradients, with and without
overflow, expert_parallel on one device), a 2-layer MoE LM's loss and
gradients from carried-over weights in f32 and bf16, and the ``lm`` verb
with ``--moe-experts`` against the JAX verb's losses.

The expert choice is an argmax over the router's logits, so a token
whose two largest logits lie within the frameworks' rounding of each
other may go to different experts, a near-tie and not a port defect.
Every comparison first asserts that the top-2 logit margin of every
token exceeds MARGIN, far above f32 rounding of the logits (~1e-6);
bf16 activations shift the logits by up to ~3e-2, so the bf16 case
holds every token that clears twice its own shift to the JAX expert and
bounds how many do not (tests/test_torch_mesh_parity.py routing_agreement).

Tolerances: the layer's outputs and gradients rtol 1e-4 and atol 1e-5
times the largest absolute value (its expert products sum in different
orders in XLA:CPU and PyTorch); the LM's f32 loss 1e-5 relative and each
gradient within 1e-4 of its blob's largest; bf16 loss 1e-2 relative (as
in test_torch_lm.py); the verbs' losses 1e-5 relative per step.
"""

import re

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from sparknet_tpu import cli as jcli
from sparknet_tpu.graph.compiler import CompiledNet as JNet
from sparknet_tpu.graph.registry import get as jget
from sparknet_tpu.models import zoo as jzoo
from sparknet_tpu.proto import Message as JMessage
from sparknet_tpu_torch import cli as tcli
from sparknet_tpu_torch.data import lm_batch_stream
from sparknet_tpu_torch.graph import params_from_numpy
from sparknet_tpu_torch.graph.compiler import CompiledNet as TNet
from sparknet_tpu_torch.graph.registry import get as tget
from sparknet_tpu_torch.models import zoo as tzoo
from sparknet_tpu_torch.proto import Message as TMessage
from sparknet_tpu_torch.solver import Solver as TSolver
from test_torch_mesh_parity import routing_agreement

TRAIN = 0
MARGIN = 1e-4
BF16_FACTOR = 2
SHAPE = (2, 16, 8)          # (batch, seq, embed)


def _assert_margin(logits, limit=MARGIN, where="router"):
    top2 = np.sort(np.asarray(logits, np.float64), axis=-1)[:, -2:]
    margin = float((top2[:, 1] - top2[:, 0]).min())
    assert margin > limit, (
        f"{where}: the smallest top-2 router-logit margin is {margin:.3e}, "
        f"within {limit:g}: a near-tie whose expert may flip between the "
        "frameworks' rounding; this is not a port defect")
    return margin


def _layers(tops, **mp):
    out = []
    for M, get in ((JMessage, jget), (TMessage, tget)):
        lp = M("LayerParameter", name="moe", type="MoE", top=tops,
               moe_param=dict(num_experts=4, hidden_dim=12, **mp))
        out.append(get("MoE")(lp, [SHAPE], TRAIN))
    return out


def _inputs(seed=0, scale=0.5):
    rs = np.random.RandomState(seed)
    jl, _ = _layers(["y"])
    params = [(scale * rs.randn(*s)).astype(np.float32)
              for s, *_ in jl.param_shapes()]
    x = rs.randn(*SHAPE).astype(np.float32)
    return params, x, rs


def _close(j, t):
    j = np.asarray(j)
    assert t.shape == j.shape and np.abs(j).max() > 0
    np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-5 * np.abs(j).max())


def _both(tops, params, x, cots, **mp):
    """-> (jax tops, port tops, jax grads, port grads); grads over the
    params then x, of sum(top * cot) over the float tops but the
    stats."""
    jl, tl = _layers(tops, **mp)
    _assert_margin(x.reshape(-1, SHAPE[-1]) @ params[0].T)
    n_grad = min(len(tops), 2)

    def jf(ps, xj):
        return jl.apply(ps, [xj], True, None)[:n_grad]
    jp = [jnp.asarray(p) for p in params]
    jout = jl.apply(jp, [jnp.asarray(x)], True, None)
    _, vjp = jax.vjp(jf, jp, jnp.asarray(x))
    jgp, jgx = vjp([jnp.asarray(c) for c in cots[:n_grad]])
    tp = [torch.from_numpy(p).requires_grad_(True) for p in params]
    tx = torch.from_numpy(x).requires_grad_(True)
    tout = tl.apply(tp, [tx], True)
    loss = sum((o * torch.from_numpy(c)).sum()
               for o, c in zip(tout[:n_grad], cots))
    tg = torch.autograd.grad(loss, tp + [tx])
    return jout, [o.detach().numpy() for o in tout], \
        list(jgp) + [jgx], [g.numpy() for g in tg]


@pytest.mark.parametrize("cf", [1.25, 0.5], ids=["no-overflow",
                                                  "overflow"])
@pytest.mark.parametrize("n_tops", [1, 2, 3])
def test_layer_matches_jax(cf, n_tops):
    params, x, rs = _inputs()
    tops = ["y", "aux", "stats"][:n_tops]
    cots = [rs.randn(*SHAPE).astype(np.float32),
            np.asarray(rs.randn(), np.float32)]
    jout, tout, jg, tg = _both(tops, params, x, cots, capacity_factor=cf)
    for j, t in zip(jout, tout):
        _close(j, t)
    for j, t in zip(jg, tg):
        _close(j, t)
    if n_tops == 3:
        stats = tout[2]
        np.testing.assert_allclose(stats[:4].sum(), 1.0, rtol=1e-6)
        assert (stats[4] > 0) == (cf == 0.5), stats


def test_dropped_tokens_get_exactly_zero_gradient():
    params, x, rs = _inputs()
    cot = rs.randn(*SHAPE).astype(np.float32)
    _, tout, jg, tg = _both(["y"], params, x, [cot], capacity_factor=0.5)
    dropped = np.all(tout[0].reshape(-1, SHAPE[-1]) == 0, axis=1)
    assert 0 < dropped.sum() < len(dropped)
    for g in (np.asarray(jg[-1]), tg[-1]):
        rows = g.reshape(-1, SHAPE[-1])
        assert not rows[dropped].any() and rows[~dropped].any()


def test_layer_is_deterministic_and_expert_parallel_is_the_same():
    params, x, rs = _inputs(seed=1)
    tops = ["y", "aux", "stats"]
    _, tl = _layers(tops)
    _, tl_ep = _layers(tops, expert_parallel=True)
    assert tl_ep.expert_parallel and not tl.expert_parallel
    args = ([torch.from_numpy(p) for p in params], [torch.from_numpy(x)],
            True)
    a, b, c = tl.apply(*args), tl.apply(*args), tl_ep.apply(*args)
    for u, v, w in zip(a, b, c):
        assert torch.equal(u, v) and torch.equal(u, w)
    jl_ep, _ = _layers(tops, expert_parallel=True)
    j = jl_ep.apply([jnp.asarray(p) for p in params], [jnp.asarray(x)],
                    True, None)
    for u, v in zip(j[:2], a[:2]):
        _close(u, v.numpy())


def test_weight_fillers_are_per_expert_uniform():
    _, tl = _layers(["y"])
    shapes = tl.param_shapes()
    assert [s for s, *_ in shapes] == [(4, 8), (4, 12, 8), (4, 12),
                                       (4, 8, 12), (4, 8)]
    lims = [f.max if f is not None else None for _, f, *_ in shapes]
    assert lims[0] == lims[1] == pytest.approx((3 / 8) ** 0.5)
    assert lims[3] == pytest.approx((3 / 12) ** 0.5)
    assert lims[2] is None and lims[4] is None
    tn = TNet(tzoo.transformer_lm(**LM, moe_experts=4), TRAIN, device="cpu")
    params, _ = tn.init()
    w1 = params["block0/moe"][1]
    assert float(w1.abs().max()) <= (3 / 32) ** 0.5
    assert float(w1.std()) == pytest.approx((3 / 32) ** 0.5 / 3 ** 0.5,
                                            rel=0.05)


def test_single_expert_is_refused():
    lp = TMessage("LayerParameter", name="m", type="MoE",
                  moe_param=dict(num_experts=1))
    with pytest.raises(ValueError, match="num_experts must be >= 2"):
        tget("MoE")(lp, [SHAPE], TRAIN)


# -- the MoE LM --------------------------------------------------------------
LM = dict(vocab_size=64, seq_len=64, batch_size=2, d_model=32,
          num_layers=2, num_heads=4)


def _batch(seed=0):
    stream, _ = lm_batch_stream(64, 2, 64, seed=seed)
    return next(stream)


def _lm_margins(blobs, params, limit):
    for i in range(LM["num_layers"]):
        x = np.asarray(blobs[f"block{i}/ln2"], np.float32).reshape(
            -1, LM["d_model"])
        _assert_margin(x @ np.asarray(params[f"block{i}/moe"][0]).T, limit,
                       where=f"block{i}/moe")


@pytest.fixture(scope="module")
def jax_moe_lm():
    jn = JNet(jzoo.transformer_lm(**LM, moe_experts=4), TRAIN)
    params, state = jn.init(jax.random.PRNGKey(0))
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}

    def loss(p):
        return jn.loss_fn(p, state, batch, jax.random.PRNGKey(1))

    (value, (blobs, _)), grads = jax.value_and_grad(loss, has_aux=True)(
        params)
    return (jax.tree.map(np.asarray, params), float(value),
            jax.tree.map(np.asarray, grads), blobs)


def _port_lm(params_np, compute_dtype=None):
    net = TNet(tzoo.transformer_lm(**LM, moe_experts=4), TRAIN,
               device="cpu", compute_dtype=compute_dtype)
    params, state = params_from_numpy(net, params_np)
    for blobs in params.values():
        for p in blobs:
            p.requires_grad_(True)
    return net, params, state


def test_moe_lm_loss_and_gradients_match_jax(jax_moe_lm):
    params_np, j_loss, j_grads, j_blobs = jax_moe_lm
    _lm_margins(j_blobs, params_np, MARGIN)
    net, params, state = _port_lm(params_np)
    loss, (blobs, _) = net.loss_fn(params, state, _batch())
    loss.backward()
    np.testing.assert_allclose(loss.item(), j_loss, rtol=1e-5)
    assert "block1/moe_aux" in blobs
    for name, ps in params.items():
        for i, p in enumerate(ps):
            want = j_grads[name][i]
            scale = float(np.abs(want).max())
            assert scale > 0, f"{name}[{i}] has a zero gradient"
            np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                       atol=1e-4 * scale,
                                       err_msg=f"{name}[{i}]")


def test_moe_lm_bf16_loss_matches_jax(jax_moe_lm):
    """bf16 activations: the two packages' router logits lie up to ~3e-2
    apart (their bf16 residual streams differ in the last bit). With the
    f32 test's weights (no key chosen to avoid near-ties, ROADMAP C12)
    every token whose top-2 margin clears BF16_FACTOR times its own
    logits' shift must go to the JAX expert, and at most 2% of the
    tokens may fall inside their shift (a near-tie whose expert may flip
    between the frameworks' rounding, not a port defect; 4 of the 256
    do here, and the loss still agrees)."""
    params_np = jax_moe_lm[0]
    jn = JNet(jzoo.transformer_lm(**LM, moe_experts=4), TRAIN,
              compute_dtype=jnp.bfloat16)
    batch = _batch()
    j_loss, (j_blobs, _) = jn.loss_fn(
        {n: [jnp.asarray(p) for p in v] for n, v in params_np.items()}, {},
        {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(1))
    net, params, state = _port_lm(params_np, torch.bfloat16)
    loss, (blobs, _) = net.loss_fn(params, state, batch)
    assert blobs["block0/moe"].dtype == torch.bfloat16
    j, t = [], []
    for i in range(LM["num_layers"]):
        router = params_np[f"block{i}/moe"][0].T
        j.append(np.asarray(j_blobs[f"block{i}/ln2"], np.float32).reshape(
            -1, LM["d_model"]) @ router)
        t.append(blobs[f"block{i}/ln2"].detach().float().reshape(
            -1, LM["d_model"]).numpy() @ router)
    routing_agreement(np.concatenate(j), np.concatenate(t),
                      factor=BF16_FACTOR, floor=MARGIN)
    loss.backward()
    assert all(p.grad.dtype == torch.float32 and torch.isfinite(p.grad).all()
               for v in params.values() for p in v)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-2)


# -- the lm verb -------------------------------------------------------------
VERB = ["lm", "--vocab", "32", "--seq-len", "64", "--batch", "2",
        "--d-model", "32", "--layers", "2", "--heads", "2", "--display",
        "1", "--moe-experts", "4", "--no-flash", "--seed", "4"]
STEPS = 3


def _verb_losses(out):
    return [float(m) for m in re.findall(r"Iteration \d+, loss = (\S+),",
                                         out)]


def test_lm_verb_with_moe_matches_the_jax_verb(tmp_path, capsys):
    prefix = str(tmp_path / "start")
    assert jcli.main(VERB + ["--steps", "0", "--snapshot-prefix",
                             prefix]) in (0, None)
    state = f"{prefix}_iter_0.solverstate"
    capsys.readouterr()
    # the routing margins of the steps the verbs take: the port's Solver
    # on the verb's settings, from the same snapshot and batches
    sp = TMessage("SolverParameter", base_lr=3e-4, lr_policy="fixed",
                  type="Adam", random_seed=4, display=0)
    net = tzoo.transformer_lm(vocab_size=32, seq_len=64, batch_size=2,
                              d_model=32, num_layers=2, num_heads=2,
                              flash=False, moe_experts=4)
    solver = TSolver(sp, net_param=net, device="cpu", log_fn=None)
    solver.restore(state)
    stream, _ = lm_batch_stream(32, 2, 64, seed=4)
    for _ in range(STEPS):
        b = next(stream)
        with torch.no_grad():
            blobs, _ = solver.net.apply(solver.params, solver.state, b)
        for i in range(2):
            x = blobs[f"block{i}/ln2"].reshape(-1, 32).numpy()
            _assert_margin(
                x @ solver.params[f"block{i}/moe"][0].detach().numpy().T,
                where=f"block{i}/moe")
        solver.train_step(b)

    args = VERB + ["--steps", str(STEPS), "--resume", state]
    assert tcli.main(args + ["--device", "cpu"]) == 0
    port = _verb_losses(capsys.readouterr().out)
    assert jcli.main(args) in (0, None)
    ref = _verb_losses(capsys.readouterr().out)
    assert len(port) == len(ref) == STEPS
    np.testing.assert_allclose(port, ref, rtol=1e-5)


@pytest.mark.parametrize("extra", [
    pytest.param(["--ep", "2", "--moe-experts", "4"], id="ep-moe"),
    pytest.param(["--ep", "2"], id="ep-alone"),
    pytest.param(["--dp", "2", "--moe-experts", "4"], id="dp-moe"),
    pytest.param(["--sp", "2"], id="sp"),
])
def test_lm_verb_refuses_the_mesh_flags_naming_a5(extra, capsys,
                                                  monkeypatch):
    """The mesh flags are ported (ROADMAP A5b; their parity with the JAX
    verb is tests/test_torch_lm_mesh.py): each MoE combination trains a
    step with the routing line, and --ep alone exits with the JAX verb's
    message instead of naming A5."""
    monkeypatch.setenv("SPARKNET_FSDP", "off")
    monkeypatch.setenv("SPARKNET_TP", "0")
    i = VERB.index("--moe-experts")
    argv = VERB[:i] + VERB[i + 2:] + ["--device", "cpu", "--steps",
                                      "1"] + extra
    if extra == ["--ep", "2"]:
        with pytest.raises(SystemExit, match="--ep needs --moe-experts"):
            tcli.main(argv)
        return
    assert tcli.main(argv) == 0
    out = capsys.readouterr().out
    assert "done: 1 steps" in out and "ROADMAP A5" not in out
    if "--moe-experts" in extra:
        assert "expert util [" in out
