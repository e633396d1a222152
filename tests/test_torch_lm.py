"""The port's transformer-LM slice against the JAX package's on the CPU:
zoo.transformer_lm(vocab 64, S 128, batch 2, d 64, 2 layers, 4 heads),
TRAIN phase, flash on (the Pallas kernel in interpret mode on the JAX
side, the plain versions on the port's), weights from the JAX net;
three Adam steps of the Solver from one JAX snapshot; params and Adam
history carried over in memory; snapshots in both directions; and the
``lm`` verb with --device cpu.

Batches come from the bigram stream with a fixed seed; both packages
draw the same tokens. Tolerances (f32 on both sides): loss 1e-5
relative; each param gradient within 1e-4 of its blob's largest |grad|;
bf16 activations: loss within 1e-2 relative (the two frameworks round
to bf16 at the same places, but may differ in the last bit); Adam steps:
loss 1e-5 relative per step, each blob's weight change within 1e-4 of
the JAX run's largest change in that blob (the attention's key bias
excepted: its gradient is rounding noise, see the test).
"""

import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from sparknet_tpu.data.synthetic import lm_batch_stream as j_stream
from sparknet_tpu.graph.compiler import CompiledNet as JNet
from sparknet_tpu.models import zoo as jzoo
from sparknet_tpu.proto import Message as JMessage
from sparknet_tpu.solver import Solver as JSolver
from sparknet_tpu_torch import cli
from sparknet_tpu_torch.data import lm_batch_stream
from sparknet_tpu_torch.graph import history_from_numpy, params_from_numpy
from sparknet_tpu_torch.graph.compiler import CompiledNet as TNet
from sparknet_tpu_torch.models import zoo as tzoo
from sparknet_tpu_torch.ops import KERNEL_WRAPPERS
from sparknet_tpu_torch.proto import Message as TMessage
from sparknet_tpu_torch.solver import Solver as TSolver

TRAIN = 0
LM = dict(vocab_size=64, seq_len=128, batch_size=2, d_model=64,
          num_layers=2, num_heads=4)


def _batches(n, seed=0):
    stream, _ = lm_batch_stream(64, 2, 128, seed=seed)
    return [next(stream) for _ in range(n)]


def test_bigram_stream_matches_jax():
    (jit, jfloor), (tit, tfloor) = j_stream(64, 2, 16, seed=3), \
        lm_batch_stream(64, 2, 16, seed=3)
    assert tfloor == jfloor
    for _ in range(3):
        a, b = next(jit), next(tit)
        for k in ("data", "label"):
            np.testing.assert_array_equal(a[k], b[k])
            assert b[k].dtype == np.int32


@pytest.mark.parametrize("seed", [0, 5])
def test_bigram_table_is_made_once_and_streams_stay_the_jax_ones(seed):
    """The transition table is kept for the process: a second stream of
    one corpus reuses it (read-only), a stream of another seed does not,
    and every stream stays the JAX package's, draw for draw."""
    from sparknet_tpu_torch.data.synthetic import _bigram_table
    first = _bigram_table(96, seed, 0.3)
    assert _bigram_table(96, seed, 0.3) is first
    assert _bigram_table(96, seed + 1, 0.3)[0] is not first[0]
    assert not first[0].flags.writeable
    (jit, jfloor), (tit, tfloor), (again, _) = (
        j_stream(96, 3, 24, seed=seed), lm_batch_stream(96, 3, 24, seed=seed),
        lm_batch_stream(96, 3, 24, seed=seed))
    assert tfloor == jfloor
    for _ in range(2):
        a, b, c = next(jit), next(tit), next(again)
        for k in ("data", "label"):
            np.testing.assert_array_equal(a[k], b[k])
            np.testing.assert_array_equal(b[k], c[k])


@pytest.fixture(scope="module")
def jax_lm():
    """The JAX net, its params (numpy) and, for one batch, its f32 loss
    and param gradients."""
    jn = JNet(jzoo.transformer_lm(**LM), TRAIN)
    params, state = jn.init(jax.random.PRNGKey(0))
    batch = {k: jnp.asarray(v) for k, v in _batches(1)[0].items()}

    def loss(p):
        return jn.loss_fn(p, state, batch, jax.random.PRNGKey(1))[0]

    value, grads = jax.value_and_grad(loss)(params)
    return (jax.tree.map(np.asarray, params), float(value),
            jax.tree.map(np.asarray, grads))


def _port_net(params_np, compute_dtype=None):
    net = TNet(tzoo.transformer_lm(**LM), TRAIN, device="cpu",
               compute_dtype=compute_dtype)
    params, state = params_from_numpy(net, params_np)
    for blobs in params.values():
        for p in blobs:
            p.requires_grad_(True)
    return net, params, state


def test_lm_loss_and_gradients_match_jax(jax_lm):
    params_np, j_loss, j_grads = jax_lm
    net, params, state = _port_net(params_np)
    attn = [impl for _, impl, _, _ in net.layers
            if impl.type_name == "Attention"]
    assert len(attn) == 2 and all(a.flash and a.causal for a in attn)
    loss, (blobs, _) = net.loss_fn(params, state, _batches(1)[0])
    assert blobs["block0/attn"].dtype == torch.float32
    loss.backward()
    np.testing.assert_allclose(loss.item(), j_loss, rtol=1e-5)
    assert set(params) == set(j_grads)
    for name, blobs in params.items():
        for i, p in enumerate(blobs):
            want = j_grads[name][i]
            scale = float(np.abs(want).max())
            assert scale > 0, f"{name}[{i}] has a zero gradient"
            np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                       atol=1e-4 * scale,
                                       err_msg=f"{name}[{i}]")


def test_lm_bf16_loss_matches_jax(jax_lm):
    params_np = jax_lm[0]
    jn = JNet(jzoo.transformer_lm(**LM), TRAIN,
              compute_dtype=jnp.bfloat16)
    batch = _batches(1)[0]
    j_loss = float(jn.loss_fn(
        {n: [jnp.asarray(p) for p in v] for n, v in params_np.items()}, {},
        {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(1))[0])
    net, params, state = _port_net(params_np, torch.bfloat16)
    loss, (blobs, _) = net.loss_fn(params, state, batch)
    assert blobs["block0/attn"].dtype == torch.bfloat16
    assert loss.dtype == torch.float32
    loss.backward()
    assert all(p.grad.dtype == torch.float32 and torch.isfinite(p.grad).all()
               for v in params.values() for p in v)
    np.testing.assert_allclose(loss.item(), j_loss, rtol=1e-2)


def test_env_precision_alone_leaves_activations_f32(monkeypatch):
    """SPARKNET_PRECISION=bf16 resolves the JAX net's compute_dtype, but
    its layers get the constructor argument (None): the activations stay
    f32 in both packages."""
    monkeypatch.setenv("SPARKNET_PRECISION", "bf16")
    jn = JNet(jzoo.transformer_lm(**LM), TRAIN)
    tn = TNet(tzoo.transformer_lm(**LM), TRAIN, device="cpu")
    assert jn.compute_dtype == jnp.bfloat16
    batch = _batches(1)[0]
    j_blobs, _ = jn.apply(*jn.init(jax.random.PRNGKey(0)),
                          {k: jnp.asarray(v) for k, v in batch.items()})
    assert j_blobs["embed"].dtype == jnp.float32
    params, state = tn.init()
    blobs, _ = tn.apply(params, state, batch)
    assert blobs["embed"].dtype == torch.float32


# -- the Solver ------------------------------------------------------------
def _sp(message):
    return message("SolverParameter", base_lr=1e-3, lr_policy="fixed",
                   type="Adam", random_seed=0, display=0)


def _weights(solver):
    return {n: [np.array(p.detach().numpy() if torch.is_tensor(p) else p,
                         np.float64) for p in v]
            for n, v in solver.params.items()}


def test_adam_steps_from_a_jax_snapshot_match_jax(tmp_path):
    batches = _batches(4, seed=1)
    js = JSolver(_sp(JMessage), net_param=jzoo.transformer_lm(**LM),
                 log_fn=None)
    js.train_step(batches[0])          # Adam's history is not zero
    _, state = js.snapshot(str(tmp_path / "jax"))
    ts = TSolver(_sp(TMessage), net_param=tzoo.transformer_lm(**LM),
                 device="cpu", log_fn=None)
    ts.restore(state)
    assert ts.iter == js.iter == 1
    w0 = _weights(js)
    for b in batches[1:]:
        np.testing.assert_allclose(float(ts.train_step(b)),
                                   float(js.train_step(b)), rtol=1e-5)
    jw, tw = _weights(js), _weights(ts)
    for name in w0:
        for i, w in enumerate(w0[name]):
            dj, dt = jw[name][i] - w, tw[name][i] - w
            if name.endswith("/attn") and i == 1:
                # the key bias adds q.b_k to every score of a row, which
                # the softmax cancels: its gradient is 0 up to rounding,
                # and Adam scales that rounding noise up to steps of ~lr
                # in either package. Compare the query and value biases.
                inner = dj.shape[0] // 3
                dj, dt = np.delete(dj, np.s_[inner:2 * inner]), \
                    np.delete(dt, np.s_[inner:2 * inner])
            scale = np.abs(dj).max()
            assert scale > 0, f"{name}[{i}] did not move"
            np.testing.assert_allclose(dt, dj, rtol=0, atol=1e-4 * scale,
                                       err_msg=f"{name}[{i}]")


def test_lm_params_and_adam_history_move_across_in_memory():
    batches = _batches(2, seed=3)
    js = JSolver(_sp(JMessage), net_param=jzoo.transformer_lm(**LM),
                 log_fn=None)
    js.train_step(batches[0])
    ts = TSolver(_sp(TMessage), net_param=tzoo.transformer_lm(**LM),
                 device="cpu", log_fn=None)
    ts.params, _ = params_from_numpy(ts.net,
                                     jax.tree.map(np.asarray, js.params))
    ts._arm_grads()
    ts.history = history_from_numpy(ts.net, "Adam",
                                    jax.tree.map(np.asarray, js.history))
    ts.iter = js.iter
    np.testing.assert_allclose(float(ts.train_step(batches[1])),
                               float(js.train_step(batches[1])), rtol=1e-5)


def test_port_lm_snapshot_restores_in_jax(tmp_path):
    batches = _batches(2, seed=2)
    ts = TSolver(_sp(TMessage), net_param=tzoo.transformer_lm(**LM),
                 device="cpu", log_fn=None)
    ts.train_step(batches[0])
    _, state = ts.snapshot(str(tmp_path / "port"))
    js = JSolver(_sp(JMessage), net_param=jzoo.transformer_lm(**LM),
                 log_fn=None)
    js.restore(state)
    assert js.iter == 1
    for name, blobs in ts.params.items():
        for i, p in enumerate(blobs):
            np.testing.assert_array_equal(np.asarray(js.params[name][i]),
                                          p.detach().numpy())
            for a, b in zip(ts.history[name][i], js.history[name][i]):
                np.testing.assert_array_equal(np.asarray(b), a.numpy())
    np.testing.assert_allclose(float(ts.train_step(batches[1])),
                               float(js.train_step(batches[1])), rtol=1e-5)


# -- the lm verb -----------------------------------------------------------
TINY = ["lm", "--device", "cpu", "--vocab", "32", "--seq-len", "128",
        "--batch", "2", "--d-model", "32", "--layers", "1", "--heads", "2",
        "--display", "1"]


def _launches(out):
    last = out.strip().splitlines()[-1]
    assert last.startswith("Kernel launches: ")
    return json.loads(last[len("Kernel launches: "):])


def test_lm_verb_trains_snapshots_and_resumes(tmp_path, capsys):
    prefix = str(tmp_path / "lm")
    metrics = tmp_path / "lm.jsonl"
    assert cli.main(TINY + ["--steps", "3", "--snapshot-every", "2",
                            "--snapshot-prefix", prefix,
                            "--metrics", str(metrics)]) == 0
    out = capsys.readouterr().out
    assert out.startswith("bigram corpus floor: ")
    assert f"(untrained: {np.log(32):.4f})" in out
    assert "Iteration 0, loss = " in out and "Iteration 2, loss = " in out
    assert "done: 3 steps, " in out and " tokens/s wall, final loss " in out
    counts = _launches(out)
    assert set(counts) == {fn.__name__ for fn in KERNEL_WRAPPERS}
    assert not any(counts.values())          # the CPU launches nothing
    for it in (2, 3):
        assert (tmp_path / f"lm_iter_{it}.solverstate").exists()
    events = [json.loads(line) for line in open(metrics)]
    kinds = [e["event"] for e in events]
    assert kinds[0] == "config" and kinds[-1] == "summary"
    assert kinds.count("train") == 3
    assert events[-1]["steps"] == 3 and events[0]["layers"] == 1

    assert cli.main(TINY + ["--steps", "5", "--resume",
                            f"{prefix}_iter_2.solverstate"]) == 0
    out = capsys.readouterr().out
    assert "Iteration 2, loss = " in out and "Iteration 1," not in out
    assert "done: 3 steps, " in out


def test_lm_verb_refuses_unported_flags_and_missing_prefix(capsys,
                                                           monkeypatch):
    """The mesh flags and --scan on are ported (tests/test_torch_lm_mesh.py,
    tests/test_torch_scan.py); what the verb still refuses: a --scan
    value outside auto|on|off (argparse's exit 2), --ep without experts
    and --snapshot-every without a prefix (the JAX verb's messages)."""
    monkeypatch.setenv("SPARKNET_FSDP", "off")
    monkeypatch.setenv("SPARKNET_TP", "0")
    with pytest.raises(SystemExit) as e:
        cli.main(TINY + ["--scan", "always"])
    assert e.value.code == 2
    assert "invalid choice: 'always'" in capsys.readouterr().err
    with pytest.raises(SystemExit, match="--ep needs --moe-experts"):
        cli.main(TINY + ["--ep", "2"])
    with pytest.raises(SystemExit, match="--snapshot-prefix"):
        cli.main(TINY + ["--snapshot-every", "2"])


def test_lm_verb_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        cli.main([a for a in TINY if a not in ("--device", "cpu")]
                 + ["--steps", "1"])
