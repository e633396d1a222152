"""Bucketed gradient consensus: the slot average split into reverse-order
buckets (the port of sparknet_tpu/parallel/overlap.py).

On a mesh of devices the JAX package splits the gradient tree into
fixed-size buckets in reverse flatten order, so the deepest layers'
gradients, which backward finishes first, start their allreduce while
the shallower layers still differentiate. The port's slots share one
card and average in one place, so nothing overlaps here; the solvers
honour SPARKNET_OVERLAP the same way (the consensus goes bucket by
bucket, bit for bit the whole-tree one: the average is elementwise and
concatenation changes neither values nor the order of the slot sum) and
register the bucket split in their ``comms`` events, the traffic a
multi-card version would overlap.

Gates: SPARKNET_OVERLAP=on|off (default on), SPARKNET_BUCKET_MB
(default 4). Trees are the solvers' {layer: [blobs]} (or stacked slot)
trees; their leaves are taken in jax.tree_util order (dict keys sorted,
lists in order), so a plan equals the JAX package's on the same tree.
"""

import os

import torch

DEFAULT_BUCKET_MB = 4


def overlap_enabled():
    v = os.environ.get("SPARKNET_OVERLAP", "on").strip().lower()
    if v in ("on", "1", ""):
        return True
    if v in ("off", "0"):
        return False
    raise ValueError(f"SPARKNET_OVERLAP={v!r}: expected on|off")


def bucket_bytes():
    mb = os.environ.get("SPARKNET_BUCKET_MB", "").strip()
    mb = float(mb) if mb else float(DEFAULT_BUCKET_MB)
    if mb <= 0:
        raise ValueError(f"SPARKNET_BUCKET_MB={mb}: must be > 0")
    return int(mb * (1 << 20))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _rebuild(tree, leaves):
    """``tree``'s structure with its leaves taken from the iterator."""
    if isinstance(tree, dict):
        built = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return {k: built[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def plan_buckets(tree, max_bytes=None):
    """Partition ``tree``'s leaves into contiguous per-dtype buckets of
    at most ``max_bytes`` each, walking the leaves in reverse flatten
    order (bucket 0 holds the last layers'). A leaf larger than
    ``max_bytes`` gets a bucket of its own; dtypes never mix in a
    bucket. Entries are (leaf index, shape, dtype, size)."""
    leaves = _leaves(tree)
    if max_bytes is None:
        max_bytes = bucket_bytes()
    buckets = []
    cur, cur_bytes, cur_dtype = [], 0, None
    for idx in reversed(range(len(leaves))):
        leaf = leaves[idx]
        dt = leaf.dtype
        size = int(leaf.numel())
        nb = size * leaf.element_size()
        if cur and (dt != cur_dtype or cur_bytes + nb > max_bytes):
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append((idx, tuple(leaf.shape), dt, size))
        cur_dtype = dt
        cur_bytes += nb
    if cur:
        buckets.append(cur)
    return {"tree": tree, "n_leaves": len(leaves), "buckets": buckets}


def bucket_sizes(plan):
    """Per-bucket payload bytes, in issue order."""
    return [sum(size * torch.empty((), dtype=dt).element_size()
                for _, _, dt, size in b) for b in plan["buckets"]]


def to_buckets(plan, tree):
    """Tree -> list of flat 1-D per-dtype buffers, in issue order. A
    stacked (slot-major) tree keeps its leading slot dim: each leaf
    flattens from dim ``lead`` on, where ``lead`` is how many dims the
    leaf has past the plan's shape."""
    leaves = _leaves(tree)
    out = []
    for b in plan["buckets"]:
        flats = []
        for idx, shape, _, _ in b:
            x = leaves[idx]
            lead = x.dim() - len(shape)
            flats.append(x.reshape(tuple(x.shape[:lead]) + (-1,)))
        out.append(flats[0] if len(flats) == 1 else torch.cat(flats, -1))
    return out


def from_buckets(plan, buckets):
    """Inverse of to_buckets: bucket list -> the plan's tree."""
    leaves = [None] * plan["n_leaves"]
    for b, flat in zip(plan["buckets"], buckets):
        off = 0
        lead = tuple(flat.shape[:-1])
        for idx, shape, _, size in b:
            leaves[idx] = flat[..., off:off + size].reshape(lead + shape)
            off += size
    return _rebuild(plan["tree"], iter(leaves))


def bucketed_consensus(consensus_fn, stacked, weight):
    """Run ``consensus_fn`` (resilience/elastic.py's masked_consensus or
    weighted_consensus, over a slot-stacked tree) on the bucketed form of
    ``stacked`` and restore the tree. Returns the same (consensus, n)
    pair as the direct call, bit for bit."""
    leaves = _leaves(stacked)
    one = _rebuild(stacked, iter([x[0] for x in leaves]))
    plan = plan_buckets(one)
    out, n = consensus_fn(to_buckets(plan, stacked), weight)
    return from_buckets(plan, out), n
