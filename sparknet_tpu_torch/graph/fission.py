"""Virtual channel-concat ("inception fission"): the port of
sparknet_tpu/graph/fission.py, the graph pass the JAX package runs by
default on every backend.

A Concat over dim 1 yields a ``Branches`` value (the list of branch
tensors) instead of one fused tensor. Consumers that can take the
branches directly do so:

  * Convolution (group=1) fissions over input channels:
        conv(concat(x_1..x_k), W) == sum_i conv(x_i, W[:, o_i:o_i+c_i])
    with the slices taken from the one weight blob (the checkpoint
    format is unchanged), and no concat gradient: each branch gets its
    input gradient from its own partial conv's backward.
  * Pooling (MAX/AVE) is per-channel, so it maps over the branches and
    stays virtual.

Any other consumer materializes the concatenate (``materialize``) just
before it runs. CompiledNet.apply hands its blobs back in a mapping that
concatenates a virtual blob only when a caller reads it, so a concat no
one reads is never computed (the JAX package relies on XLA's dead-code
elimination for that). Fission reorders the input-channel summation
(k partial convs instead of one), so outputs match the literal graph to
accumulation rounding, not bit for bit.

Enabled by default, as in the JAX package; SPARKNET_FISSION=0 compiles
the literal graph.
"""

import os

import torch

MAX_POOL, AVE_POOL = 0, 1


def enabled():
    return os.environ.get("SPARKNET_FISSION", "1") != "0"


class Branches:
    """A channel-concat that was never materialized: an ordered list of
    4-D tensors agreeing on every dim but the channel axis (1)."""

    __slots__ = ("parts",)
    axis = 1

    def __init__(self, parts):
        flat = []
        for p in parts:
            if isinstance(p, Branches):
                flat.extend(p.parts)
            else:
                flat.append(p)
        self.parts = flat

    @property
    def channels(self):
        return [p.shape[self.axis] for p in self.parts]

    def concat(self):
        return torch.cat(self.parts, dim=self.axis)


def materialize(v):
    return v.concat() if isinstance(v, Branches) else v


def spread(vals):
    """Tensors with each Branches spread into its parts, and each value's
    part count (0 for a tensor): how a virtual concat crosses a remat
    boundary. It crosses as its branches (the JAX package concatenates
    it there), so its consumers dispatch as they do without remat and
    every policy computes the numbers ``none`` does. The compiler's
    segments and the mesh path's segments both cross through here."""
    flat, parts = [], []
    for v in vals:
        if isinstance(v, Branches):
            flat.extend(v.parts)
            parts.append(len(v.parts))
        else:
            flat.append(v)
            parts.append(0)
    return flat, parts


def gather(flat, parts):
    """spread's inverse."""
    out, k = [], 0
    for c in parts:
        if c:
            out.append(Branches(list(flat[k:k + c])))
            k += c
        else:
            out.append(flat[k])
            k += 1
    return out


def try_apply(lp, impl, lparams, bvals, train):
    """Fission-aware dispatch for one layer. Returns the layer's top values
    (which may hold Branches), or None to mean "run the normal path"
    (the caller materializes any Branches bottoms first)."""
    if lp.type == "Concat" and getattr(impl, "axis", None) == 1 \
            and len(bvals) > 1 \
            and all(getattr(v, "ndim", 4) == 4 or isinstance(v, Branches)
                    for v in bvals):
        return [Branches(bvals)]
    if not any(isinstance(v, Branches) for v in bvals):
        return None
    if lp.type == "Convolution" and impl.group == 1 \
            and isinstance(bvals[0], Branches):
        return [impl.apply_fissioned(lparams, bvals[0], train)]
    if lp.type == "Pooling" and impl.method in (MAX_POOL, AVE_POOL) \
            and isinstance(bvals[0], Branches):
        return [Branches([impl.apply(lparams, [p], train)[0]
                          for p in bvals[0].parts])]
    return None


class LazyBlobs(dict):
    """The blob dict CompiledNet.apply returns: a virtual concat
    (Branches) is concatenated the first time a caller reads it, and the
    tensor replaces it. Every read path (indexing, ``get``, ``values``,
    ``items``, ``pop``, ``dict(...)`` and ``**`` copies) sees tensors
    only; ``copy`` stays lazy."""

    def __getitem__(self, key):
        v = dict.__getitem__(self, key)
        if isinstance(v, Branches):
            v = v.concat()
            dict.__setitem__(self, key, v)
        return v

    def __iter__(self):
        # overriding __iter__ makes dict(self) and {**self} copy through
        # keys() and __getitem__ rather than the raw slots
        return dict.__iter__(self)

    def get(self, key, default=None):
        return self[key] if key in self else default

    def values(self):
        return [self[k] for k in self]

    def items(self):
        return [(k, self[k]) for k in self]

    def pop(self, key, *default):
        return materialize(dict.pop(self, key, *default))

    def copy(self):
        out = LazyBlobs()
        for k in self:
            dict.__setitem__(out, k, dict.__getitem__(self, k))
        return out
