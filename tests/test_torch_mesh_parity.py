"""Helpers shared by the port's mesh-solver parity tests
(tests/test_torch_{fsdp,gspmd,seq_parallel,expert_parallel,pipeline,
moe}.py; it holds no test of its own): start a JAX solver and the port's
from one JAX snapshot, step both on the same bigram batches, compare
losses and params, and hold the MoE routing of the two packages to each
other.
"""

import numpy as np

from sparknet_tpu_torch.data import lm_batch_stream

LOSS_RTOL, PARAM_ATOL, STEPS = 1e-5, 1e-4, 3


def start_together(tmp_path, js, ts):
    """The port solver takes the JAX solver's weights and history through
    a JAX snapshot (.caffemodel + .solverstate, or the pipeline's
    .lm.npz)."""
    out = js.snapshot(str(tmp_path / "start"))
    ts.restore(out if isinstance(out, str) else out[1])


def assert_params_match(js, ts, atol=PARAM_ATOL):
    worst, where = 0.0, None
    for name, blobs in js.params.items():
        for i, p in enumerate(blobs):
            e = float(np.abs(np.asarray(p) - ts.params[name][i]
                             .detach().numpy()).max())
            if e > worst:
                worst, where = e, f"{name}[{i}]"
    assert worst <= atol, f"params differ by {worst:.3e} at {where}"


def run_steps(js, ts, vocab, batch, seq_len, steps=STEPS, seed=1):
    """``steps`` train steps of both on the same batches; the losses
    within LOSS_RTOL; -> the batches."""
    stream, _ = lm_batch_stream(vocab, batch, seq_len, seed=seed)
    jl, tl, batches = [], [], []
    for _ in range(steps):
        b = next(stream)
        batches.append(b)
        jl.append(float(js.train_step(b)))
        tl.append(float(ts.train_step(b)))
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    return batches


def routing_agreement(j_logits, t_logits, factor=2.0, floor=1e-6,
                      max_unclear=0.02):
    """The seed-free routing check (ROADMAP C12): every token whose top-2
    router-logit margin clears ``factor`` times the two packages' logit
    difference on that token (at least ``floor``) goes to the JAX
    expert in the port too; at most ``max_unclear`` of the tokens may
    fall inside their own shift (a near-tie whose expert may flip
    between the frameworks' rounding, not a port defect). -> (clear
    count, unclear count)."""
    j = np.asarray(j_logits, np.float64)
    t = np.asarray(t_logits, np.float64)
    shift = np.maximum(np.abs(j - t).max(axis=1), floor)
    top2 = np.sort(j, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > factor * shift
    same = j.argmax(1) == t.argmax(1)
    bad = np.flatnonzero(clear & ~same)
    assert not len(bad), (
        f"tokens {bad.tolist()} clear their margin yet go to another "
        "expert than in the JAX package")
    unclear = int((~clear).sum())
    assert unclear <= max_unclear * len(j), (
        f"{unclear} of {len(j)} tokens lie within {factor}x their "
        "logit shift")
    return int(clear.sum()), unclear
