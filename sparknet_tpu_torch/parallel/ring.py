"""Sequence parallelism: exact attention over a sequence split across the
"seq" slots (the port of sparknet_tpu/parallel/ring.py).

  ring_attention     the K/V blocks rotate around the ring (ppermute)
                     while a numerically stable running softmax (the
                     flash recurrence m/l/o of ``_stable_block_update``)
                     accumulates per query block; slot i at step t holds
                     the block of slot (i - t) mod n.
  ulysses_attention  two all_to_alls reshard (sequence-split, all heads)
                     -> (whole sequence, H/n heads) around dense
                     attention, and back.

Both take one (B, H, S/n, D) tensor a slot of the mesh and return one a
slot; the rotation and the exchange are parallel/mesh.py's collectives.
As in the JAX module the scores are f32 and the core is the plain one:
the ring does not run the flash kernels (the JAX verb runs ``--sp``
with ``flash=False``).
"""

import functools

import torch

from .mesh import all_to_all, ppermute
from ..ops.attention import dense_attention


def _stable_block_update(o, m, l, s, v):
    """One flash-attention accumulation step.
    o: (..., Sq, D) running unnormalized output
    m: (..., Sq)    running max
    l: (..., Sq)    running denominator
    s: (..., Sq, Sk) raw scores for this K/V block
    v: (..., Sk, D)
    """
    m_blk = s.amax(dim=-1)
    m_new = torch.maximum(m, m_blk)
    # renormalize history; exp(-inf - -inf) guarded to 0
    alpha = torch.exp(torch.where(m == float("-inf"),
                                  torch.full_like(m, float("-inf")),
                                  m - m_new))
    p = torch.exp(s - m_new[..., None])
    l_new = l * alpha + p.sum(-1)
    o_new = o * alpha[..., None] + p @ v
    return o_new, m_new, l_new


def ring_attention(qs, ks, vs, mesh, axis, causal=False, scale=None):
    """Exact attention over a sequence split on ``axis``: ``qs``, ``ks``,
    ``vs`` hold each slot's (B, H, S_local, D) shard; returns each
    slot's (B, H, S_local, D) output."""
    W = mesh.size
    n = mesh.shape[axis]
    s_local, d = qs[0].shape[-2], qs[0].shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    dev = qs[0].device
    my = [mesh.axis_index(w, axis) for w in range(W)]
    qf = [(q * scale).float() for q in qs]
    o = [torch.zeros(q.shape, dtype=torch.float32, device=dev) for q in qs]
    m = [torch.full(q.shape[:-1], float("-inf"), device=dev) for q in qs]
    l = [torch.zeros(q.shape[:-1], dtype=torch.float32, device=dev)
         for q in qs]
    ar = torch.arange(s_local, device=dev)
    k_cur, v_cur = list(ks), list(vs)
    for step in range(n):
        for w in range(W):
            s = qf[w] @ k_cur[w].float().transpose(-1, -2)
            if causal:
                src = (my[w] - step) % n
                keep = (my[w] * s_local + ar)[:, None] >= \
                    (src * s_local + ar)[None, :]
                s = s.masked_fill(~keep, float("-inf"))
            o[w], m[w], l[w] = _stable_block_update(
                o[w], m[w], l[w], s, v_cur[w].float())
        if step < n - 1:    # the last rotation would only bring blocks home
            k_cur = ppermute(k_cur, mesh, axis)
            v_cur = ppermute(v_cur, mesh, axis)
    # fully masked rows (cannot happen with causal self-attention)
    return [(o[w] / torch.clamp(l[w], min=1e-30)[..., None]).to(qs[w].dtype)
            for w in range(W)]


def ulysses_attention(qs, ks, vs, mesh, axis, causal=False, scale=None):
    """All-to-all sequence parallelism (Ulysses): reshard so each slot
    holds every position of H/n heads, run dense attention, reshard
    back. Needs H % n == 0."""
    seq_to_head = functools.partial(all_to_all, mesh=mesh, axis=axis,
                                    split_dim=1, concat_dim=2)
    qh, kh, vh = seq_to_head(qs), seq_to_head(ks), seq_to_head(vs)
    out = [dense_attention(q, k, v, causal=causal, scale=scale)
           for q, k, v in zip(qh, kh, vh)]
    return all_to_all(out, mesh, axis, split_dim=2, concat_dim=1)


def ring_attention_comm_bytes(block_shape, n, itemsize=4):
    """Per-chip bytes one ring_attention forward moves over the seq axis
    on a multi-device mesh: the K and V blocks (each ``block_shape``, the
    local shard) pass ``n`` times around the ring (the JAX module's
    count; its final rotation returns blocks home)."""
    total = 1
    for dim in block_shape:
        total *= int(dim)
    return int(2 * int(n) * total * itemsize)


def sequence_sharded_apply(fn, mesh, seq_axis="seq", seq_dim=1):
    """Wrap ``fn(*tensors)`` so it runs once a slot of ``mesh``, each
    argument cut along ``seq_dim`` over ``seq_axis``, with the seq axis
    published in the parallelism context; the slots' outputs are joined
    along ``seq_dim``. ``fn`` sees one slot's shards and
    ``context.axis_index("seq")``."""
    from . import context

    @functools.wraps(fn)
    def wrapped(*args):
        n = mesh.shape[seq_axis]
        outs = [None] * mesh.size
        with context.axis_context(seq=seq_axis), \
                context.mesh_context(mesh):
            for w in range(mesh.size):
                i = mesh.axis_index(w, seq_axis)
                shards = [torch.chunk(a, n, seq_dim)[i] for a in args]
                with context.slot_context(mesh, w):
                    outs[w] = fn(*shards)
        group = next(g for g in mesh.groups(seq_axis) if 0 in g)
        return torch.cat([outs[w] for w in group], seq_dim)

    return wrapped
