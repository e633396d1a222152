"""GPipe pipeline parallelism over the "pipe" slots (the port of
sparknet_tpu/parallel/pipeline.py).

The model's repeated trunk is ONE ``block_fn(block_params, x) -> x``
applied L times with stacked params (leaves shaped (L, ...)); stage d of
S owns the L/S consecutive blocks [d*L/S, (d+1)*L/S) (a view of the
stack) and applies them in order. The batch is cut into M
microbatches; the GPipe schedule runs M + S - 1 ticks: at tick t stage
0 takes microbatch t, every stage applies its blocks to what it holds,
and one ppermute (parallel/mesh.py) hands each stage's output to the
next; the last stage's output at tick t is microbatch t - (S - 1). The
JAX schedule computes the warm-up and drain ticks on zeros and never
collects them; here a stage with no microbatch in flight idles (the
same outputs, the same gradients). The embedding and head stay outside
the pipeline.
"""

import torch

from .mesh import PIPE_AXIS, ppermute


def _block(local_params, i):
    """Block ``i`` of a stage's stacked param tree."""
    return {k: [leaf[i] for leaf in v] for k, v in local_params.items()}


def gpipe(block_fn, stage_params, microbatches, mesh, axis=PIPE_AXIS):
    """The schedule over the pipe slots of ``mesh``. stage_params: one
    stacked param tree a stage, leaves (L/S, ...); microbatches: (M, mb,
    ...). -> (M, mb, ...) outputs of the last stage."""
    S = mesh.shape[axis]
    M = microbatches.shape[0]
    stages = [mesh.axis_index(w, axis) for w in range(mesh.size)]
    n_local = [next(iter(p.values()))[0].shape[0] for p in stage_params]

    def stage(w, x):
        for i in range(n_local[w]):
            x = block_fn(_block(stage_params[w], i), x)
        return x

    held = [None] * mesh.size
    outs = [None] * M
    for t in range(M + S - 1):
        ys = [None] * mesh.size
        for w, d in enumerate(stages):
            m = t - d
            if not 0 <= m < M:
                continue                # bubble: nothing in flight here
            ys[w] = stage(w, microbatches[m] if d == 0 else held[w])
            if d == S - 1:
                outs[m] = ys[w]
        held = ppermute(ys, mesh, axis)
    return torch.stack(outs)


def pipeline_apply(block_fn, stacked_params, x, mesh, num_microbatches,
                   axis=PIPE_AXIS):
    """Run a stack of L identical blocks as an S-stage pipeline.
    stacked_params: {name: [leaves (L, ...)]}, L divisible by the stage
    count; x: (B, ...) with B divisible by ``num_microbatches``.
    -> (B, ...) after all L blocks."""
    B = x.shape[0]
    M = num_microbatches
    if B % M:
        raise ValueError(f"batch {B} not divisible by microbatches {M}")
    S = mesh.shape[axis]
    L = next(iter(stacked_params.values()))[0].shape[0]
    if L % S:
        raise ValueError(
            f"block count {L} not divisible by pipeline stages {S}")
    per = L // S
    stage_params = [
        {k: [leaf[d * per:(d + 1) * per] for leaf in v]
         for k, v in stacked_params.items()}
        for d in (mesh.axis_index(w, axis) for w in range(mesh.size))]
    mb = x.reshape((M, B // M) + tuple(x.shape[1:]))
    out = gpipe(block_fn, stage_params, mb, mesh, axis)
    return out.reshape((B,) + tuple(x.shape[1:]))


def stack_params(per_block_params):
    """[block0 tree, block1 tree, ...] (identical structures) -> one tree
    with each leaf stacked on a new leading (L) dim."""
    first = per_block_params[0]
    return {k: [torch.stack([p[k][i] for p in per_block_params])
                for i in range(len(v))] for k, v in first.items()}
