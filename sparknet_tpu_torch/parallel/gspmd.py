"""Tensor parallelism over a (data, model) slot grid (the port of
sparknet_tpu/parallel/gspmd.py).

The JAX solver annotates the shardings of params, optimizer state and
batch over a (data, model) mesh and lets XLA's SPMD partitioner place
the collectives; a param rule maps (layer, blob index, shape) to a
PartitionSpec. The port keeps the rules (``default_param_rule``,
``transformer_tp_rule``, specs as tuples) and writes the Megatron
recipe out over the slots: the batch splits over the "data" slots, and
each "model" slot holds and computes its shard of every split blob,
layer by layer in lock step (parallel/lockstep.py):

  * column-split (dim 0 over "model"): an InnerProduct's output features
    (ffn1, lm_head) — its output stays split across the slots; the
    attention's wqkv/bqkv by heads, so each slot owns H/N heads and
    runs the flash kernels on them; the vocab (or position) rows of an
    Embed or PositionalEmbed table, looked up masked and psum'd;
  * row-split (dim 1 over "model"): wo and ffn2 take their slot's part
    of the split input, and their partial products are psum'd over the
    slots before the (replicated) bias;
  * a layer that reads a split activation and has no split form
    (SoftmaxWithLoss after a split lm_head) all_gathers it first, so the
    loss sees the whole row; a split blob of a layer with no split form
    is all_gathered at use. LayerNorms, the post-reduce biases and every
    blob whose dim does not divide stay replicated (the JAX rule).

The gradient is the single-device one: every slot's loss is the same
number, the step takes their mean, and autograd carries each psum's and
all_gather's transpose back to the shards. Each slot's shards are views
into the full tensors of ``params``, so snapshots are the single-device
files.

``seq_axis`` adds a third axis (dp x tp x sp on one mesh): dim 1 of
every feed blob of rank 2 or more splits over the "seq" slots, as the
JAX solver's batch annotation does. Under jax.jit no "seq" axis is
published, so every JAX layer sees the whole sequence; the port places
by hand the gathers XLA's partitioner places:

  * a layer that acts on each index of dim 1 alone (Embed,
    PositionalEmbed at its slot's global positions, LayerNorm and an
    InnerProduct over dims past 1, Eltwise, the elementwise neurons, a
    SoftmaxWithLoss without ignore_label over an axis past 1, whose mean
    over equal shards is the global mean) runs on the slot's rows;
  * Attention (every one, ``ring`` or not: the JAX GSPMD step has no
    ring schedule) projects the slot's rows, all_gathers q, k and v
    over "seq", runs its core (the flash kernels where S divides by
    128) once per (data, model) group on the whole sequence, and each
    slot takes its rows of O;
  * every other layer with a seq-split bottom all_gathers it over "seq"
    along dim 1, runs once per group on the whole sequence, and a top
    that the per-slot net holds split is narrowed to the slot's rows.
"""

import numpy as np
import torch

from ..graph.compiler import CompiledNet
from . import context
from .lockstep import MeshSolver
from .mesh import (DATA_AXIS, MODEL_AXIS, all_gather, make_mesh, psum,
                   slot_rows)

# single-input elementwise layers: an activation split along its last
# dim stays split through them
_ELEMENTWISE = {"ReLU", "TanH", "Sigmoid", "AbsVal", "Power", "ELU", "BNLL",
                "Exp", "Log"}
# layers that act on each index of dim 1 alone whatever their bottoms'
# rank (GSPMDSolver._keeps_seq has the rank-dependent ones)
_PER_INDEX = _ELEMENTWISE | {"Embed", "Eltwise"}


def default_param_rule(axis_size, min_size=2 ** 14):
    """Shard dim 0 (Caffe's num_output dim for conv and IP weights) over
    "model" when divisible and the blob is big enough to be worth it."""
    def rule(layer_name, idx, shape):
        if shape and shape[0] % axis_size == 0 and \
                int(np.prod(shape)) >= min_size:
            return (MODEL_AXIS,)
        return ()
    return rule


def transformer_tp_rule(axis_size, axis=MODEL_AXIS):
    """Megatron-style tensor parallelism for zoo.transformer_lm (and
    transformer_lm_pieces) weight names: column-split (dim 0) attn
    wqkv/bqkv, ffn1, lm_head and the vocab dim of the embedding tables;
    row-split (dim 1) attn wo and ffn2, their biases replicated, as are
    the LayerNorms. A dim that does not divide ``axis_size`` stays
    replicated."""
    def col(shape):
        return bool(shape) and shape[0] % axis_size == 0

    def row(shape):
        return len(shape) == 2 and shape[1] % axis_size == 0

    def rule(layer_name, idx, shape):
        if axis_size <= 1:
            return ()
        base = layer_name.rsplit("/", 1)[-1]
        if base == "attn":
            if idx in (0, 1) and col(shape):
                return (axis,)
            if idx == 2 and row(shape):
                return (None, axis)
            return ()
        if base in ("ffn1", "lm_head") and col(shape):
            return (axis,)
        if base == "ffn2" and idx == 0 and row(shape):
            return (None, axis)
        if base in ("tok_embed", "pos_embed") and idx == 0 and \
                len(shape) == 2 and col(shape):
            return (axis,)
        return ()
    return rule


def _split_dim(spec):
    """The dim a spec splits (None for replicated)."""
    for d, a in enumerate(spec):
        if a is not None:
            return d
    return None


class GSPMDSolver(MeshSolver):
    """Solver over a (data, model[, seq]) slot grid whose split blobs
    live as per-slot shards. ``param_rule``: fn(layer_name, blob_idx,
    shape) -> spec tuple; ``seq_axis``: the mesh axis that dim 1 of the
    batch splits over (None: the sequence stays whole)."""

    def __init__(self, solver_param, mesh=None, param_rule=None,
                 seq_axis=None, **kw):
        mesh = mesh if mesh is not None else \
            make_mesh({DATA_AXIS: -1, MODEL_AXIS: 1})
        if seq_axis is not None and seq_axis not in mesh.shape:
            raise ValueError(f"seq_axis {seq_axis!r} is not an axis of "
                             f"{mesh}")
        if param_rule is not None:
            self.param_rule = param_rule
        elif MODEL_AXIS in mesh.shape:
            self.param_rule = default_param_rule(mesh.shape[MODEL_AXIS])
        else:
            self.param_rule = lambda lname, i, shape: ()
        self.batch_axes = (DATA_AXIS,)
        # read by MeshSolver's per-slot net and batches, which cut dim 1
        self.seq_axis = seq_axis
        super().__init__(solver_param, mesh, **kw)
        self.tp = mesh.shape.get(MODEL_AXIS, 1)
        self.sp = mesh.shape.get(seq_axis, 1) if seq_axis else 1
        self.specs = {ln: [tuple(self.param_rule(ln, i, tuple(b.shape)))
                           for i, b in enumerate(blobs)]
                      for ln, blobs in self.params.items()}
        self._heads = {}
        for lp, impl, _, _ in self.net.layers:
            if lp.type == "Attention" and \
                    _split_dim(self.specs.get(lp.name, [()])[0]) == 0:
                if impl.num_heads % self.tp:
                    raise ValueError(
                        f"{lp.name}: {impl.num_heads} heads do not split "
                        f"over {self.tp} model slots")
                self._heads[lp.name] = impl.num_heads
        self._plans = {}

    def _axes(self):
        axes = {"data": DATA_AXIS, "model": MODEL_AXIS}
        if self.seq_axis:
            axes["seq"] = self.seq_axis
        return axes

    # -- shards ------------------------------------------------------------
    def _shard(self, lname, i, p, m):
        """Model slot ``m``'s shard of blob ``i`` of ``lname`` (a view, or
        for the attention's head split a gather of its head rows)."""
        spec = self.specs[lname][i]
        d = _split_dim(spec)
        if d is None:
            return p
        n = self.tp
        if lname in self._heads and i in (0, 1):
            # rows laid out (3, H, D): slot m owns heads [m*H/n, (m+1)*H/n)
            # of q, k and v alike
            return p.reshape((3, n, -1) + tuple(p.shape[1:]))[:, m] \
                .reshape((-1,) + tuple(p.shape[1:]))
        lo, hi = slot_rows(p.shape[d], n, m)
        return p.narrow(d, lo, hi - lo)

    def _slot_params(self):
        out = []
        for w in range(self.mesh.size):
            m = self.mesh.axis_index(w, MODEL_AXIS)
            out.append({ln: [self._shard(ln, i, p, m)
                             for i, p in enumerate(blobs)]
                        for ln, blobs in self.params.items()})
        return out

    # -- the Megatron layers -----------------------------------------------
    def _overrides(self, net):
        if self.tp <= 1 and self.sp <= 1:
            return None
        if id(net) not in self._plans:
            self._plans[id(net)] = self._plan(net)
        return self._plans[id(net)]

    def _plan(self, net):
        """{layer name: slot fn} for every layer that holds a split blob,
        reads a split activation or must see the whole sequence, walking
        the net once to track which blobs are split along their last dim
        over "model" (``split``) and along dim 1 over "seq" (``seq``)."""
        split, out, whole_net = set(), {}, None
        seq = {n for n, s in net.feed_shapes().items() if len(s) >= 2} \
            if self.sp > 1 else set()
        for lp, impl, bottoms, tops in net.layers:
            if getattr(impl, "is_feed", False):
                continue
            owned = {i: s for i, s in enumerate(self.specs.get(lp.name, []))}
            has_split = any(_split_dim(s) is not None
                            for s in owned.values())
            in_split = [b in split for b in bottoms]
            in_seq = [b in seq for b in bottoms]
            keeps = bool(in_seq) and all(in_seq) and \
                self._keeps_seq(lp, impl, net, bottoms)
            pooled = self._pools_batch(impl, net, tops)
            # the bottoms to all_gather over "seq", and whether the layer
            # sees whole sequences (then it runs once per seq group)
            gather = [False] * len(bottoms) if keeps else in_seq
            whole = self.sp > 1 and not keeps
            ranked = [len(net.blob_shapes[t]) >= 2 for t in tops]
            for t in tops:
                split.discard(t)
                seq.discard(t)
            if not (has_split or any(in_split) or any(gather) or pooled or (
                    whole and lp.type in ("Attention", "PositionalEmbed"))):
                if keeps:
                    seq.update(t for t, r in zip(tops, ranked) if r)
                continue
            top_seq = [keeps and r for r in ranked]
            if lp.type == "Attention":
                fn, top_split = self._attention(lp, impl, owned, in_split[0],
                                                in_seq[0]), False
                top_seq = [in_seq[0]]
            elif lp.type == "InnerProduct" and not any(gather) and \
                    impl.axis == len(net.blob_shapes[bottoms[0]]) - 1:
                fn, top_split = self._inner_product(lp, impl, owned,
                                                    in_split[0])
            elif lp.type in ("Embed", "PositionalEmbed") and \
                    _split_dim(owned.get(0, ())) == 0 and not any(in_split):
                fn, top_split = self._table(lp, impl, owned, keeps), False
            elif lp.type in _ELEMENTWISE and not has_split:
                fn, top_split = None, in_split[0]
            else:
                if any(gather):
                    if whole_net is None:
                        whole_net = self._whole_seq_net(net)
                    impl, top_seq = self._on_whole_seq(lp, tops, net,
                                                       whole_net)
                fn, top_split = self._gathered(lp, impl, owned, in_split,
                                               gather, top_seq, whole,
                                               pooled), False
            if top_split:
                split.update(tops)
            seq.update(t for t, s in zip(tops, top_seq) if s)
            if fn is not None:
                out[lp.name] = fn
        return out

    @staticmethod
    def _keeps_seq(lp, impl, net, bottoms):
        """Whether ``lp`` acts on each index of its bottoms' dim 1 alone, so
        that on a slot's rows of the sequence it gives the slot's rows of
        its tops (a per-token loss: the mean over equal shards' means)."""
        if lp.type in _PER_INDEX:
            return True
        if lp.type in ("LayerNorm", "PositionalEmbed"):
            return len(net.blob_shapes[bottoms[0]]) >= 3
        if lp.type == "InnerProduct":
            return impl.axis >= 2
        if lp.type == "SoftmaxWithLoss":
            return impl.axis >= 2 and impl.ignore_label is None
        return False

    def _pools_batch(self, impl, net, tops):
        """Whether ``impl`` is a loss (or accuracy) over its own count of
        valid labels with more than one data slot: the mean of the data
        slots' means is not the global mean, so it sees the whole batch."""
        return getattr(impl, "ignore_label", None) is not None and \
            self.mesh.shape.get(DATA_AXIS, 1) > 1 and \
            all(len(net.blob_shapes[t]) <= 1 for t in tops)

    def _whole_seq_net(self, net):
        """``net`` with dim 1 of its rank-2+ feeds at the whole sequence:
        the layers and shapes of a (data, model) group's whole sequence."""
        feeds = {n: s[:1] + (s[1] * self.sp,) + s[2:] if len(s) >= 2 else s
                 for n, s in net.feed_shapes().items()}
        return CompiledNet(net.net_param, net.phase, feed_shapes=feeds,
                           device=net.device,
                           compute_dtype=net.compute_dtype)

    def _on_whole_seq(self, lp, tops, net, whole_net):
        """The layer of ``whole_net`` named as ``lp``, and which of its
        tops the per-slot net holds as the slot's rows of dim 1 (the
        others it holds whole)."""
        impl = next(i for l, i, _, _ in whole_net.layers if l.name == lp.name)
        top_seq = []
        for t in tops:
            part, full = net.blob_shapes[t], whole_net.blob_shapes[t]
            if part == full:
                top_seq.append(False)
            elif len(part) >= 2 and part[1] * self.sp == full[1] and \
                    part[:1] + part[2:] == full[:1] + full[2:]:
                top_seq.append(True)
            else:
                raise ValueError(
                    f"{lp.name} ({lp.type}): top {t!r} is {full} on the "
                    f"whole sequence and {part} on a seq slot, not a split "
                    f"of dim 1 over {self.sp} slots")
        return impl, top_seq

    def _gather_act(self, xs):
        return all_gather(xs, self.mesh, MODEL_AXIS, dim=-1)

    def _gather_seq(self, xs, dim=1):
        return all_gather(xs, self.mesh, self.seq_axis, dim=dim)

    def _seq_groups(self, on):
        """The slot lists that share one whole sequence: each (data, model)
        group over "seq" when ``on``, else every slot alone."""
        if on:
            return self.mesh.groups(self.seq_axis)
        return [[w] for w in range(self.mesh.size)]

    def _model_groups(self):
        """The slot lists that share one whole batch: one per model index."""
        out = {}
        for w in range(self.mesh.size):
            out.setdefault(self._model_index(w), []).append(w)
        return list(out.values())

    def _gather_param(self, ps, spec):
        d = _split_dim(spec)
        return ps if d is None else all_gather(ps, self.mesh, MODEL_AXIS,
                                               dim=d)

    def _model_index(self, w):
        return self.mesh.axis_index(w, MODEL_AXIS)

    def _inner_product(self, lp, impl, specs, in_split):
        """y = x W^T + b with W column-split (the output stays split),
        row-split (the partial products psum'd before the bias) or
        replicated."""
        col = _split_dim(specs.get(0, ())) == 0
        row = _split_dim(specs.get(0, ())) == 1
        n = self.tp
        bsplit = impl.bias_term and _split_dim(specs.get(1, ())) is not None

        def fn(params, bottoms, train):
            xs = [b[0] for b in bottoms]
            ws = [p[0] for p in params]
            bs = [p[1] for p in params] if impl.bias_term else None
            if row:
                if not in_split:
                    k = xs[0].shape[-1] // n
                    xs = [x.narrow(-1, self._model_index(w) * k, k)
                          for w, x in enumerate(xs)]
                ys = psum([x @ wt.to(x.dtype).T for x, wt in zip(xs, ws)],
                          self.mesh, MODEL_AXIS)
                if bsplit:
                    bs = self._gather_param(bs, specs[1])
            else:
                if in_split:
                    xs = self._gather_act(xs)
                if not col:
                    ws = self._gather_param(ws, specs.get(0, ()))
                ys = [x @ wt.to(x.dtype).T for x, wt in zip(xs, ws)]
                if bs is not None and col and not bsplit:
                    f = bs[0].shape[0] // n
                    bs = [b.narrow(0, self._model_index(w) * f, f)
                          for w, b in enumerate(bs)]
                elif bsplit and not col:
                    bs = self._gather_param(bs, specs[1])
            if bs is not None:
                ys = [y + b.to(y.dtype) for y, b in zip(ys, bs)]
            return [[y] for y in ys]

        return fn, col

    def _attention(self, lp, impl, specs, in_split, in_seq):
        """Each slot projects its rows for its H/N heads (or, with wqkv
        replicated, all of them). Over a seq axis q, k and v are
        all_gathered along the sequence and the core runs once per (data,
        model) group on the whole of it, the causal mask at global
        positions; each slot keeps its rows of O. Each slot multiplies by
        its part of wo; the partials are psum'd before bo (wo row-split),
        or the heads all_gathered first (wo replicated)."""
        heads = _split_dim(specs.get(0, ())) == 0
        wo_row = _split_dim(specs.get(2, ())) == 1
        bsplit = _split_dim(specs.get(1, ())) is not None
        W, n = self.mesh.size, self.tp
        groups = self._seq_groups(in_seq)

        def fn(params, bottoms, train):
            xs = [b[0] for b in bottoms]
            if in_split:
                xs = self._gather_act(xs)
            bq = [p[1] for p in params]
            if bsplit and not heads:
                bq = self._gather_param(bq, specs[1])
            elif heads and not bsplit:
                bq = [b.reshape(3, n, -1)[:, self._model_index(w)]
                      .reshape(-1) for w, b in enumerate(bq)]
            qkv = [impl.project([params[w][0], bq[w]], xs[w])
                   for w in range(W)]
            q, k, v = ([t[i] for t in qkv] for i in range(3))
            if in_seq:
                q, k, v = (self._gather_seq(t, dim=2) for t in (q, k, v))
            os = [None] * W
            for g in groups:
                o = impl.core(q[g[0]], k[g[0]], v[g[0]])
                for w, ow in zip(g, o.chunk(len(g), dim=2)):
                    b, h, s, d = ow.shape
                    os[w] = ow.transpose(1, 2).reshape(b, s, h * d)
            wos = [p[2] for p in params]
            bos = self._gather_param([p[3] for p in params],
                                     specs.get(3, ()))
            if wo_row:
                if not heads:
                    k = os[0].shape[-1] // n
                    os = [o.narrow(-1, self._model_index(w) * k, k)
                          for w, o in enumerate(os)]
                ys = psum([o @ wo.to(o.dtype).T for o, wo in zip(os, wos)],
                          self.mesh, MODEL_AXIS)
            else:
                if heads:
                    os = self._gather_act(os)
                wos = self._gather_param(wos, specs.get(2, ()))
                ys = [o @ wo.to(o.dtype).T for o, wo in zip(os, wos)]
            return [[y + bo.to(y.dtype)] for y, bo in zip(ys, bos)]

        return fn

    def _table(self, lp, impl, specs, seq_rows):
        """Embed / PositionalEmbed over a row-split table: each slot looks
        up the ids (or positions: with ``seq_rows`` its rows' global ones)
        that fall in its rows, zeros elsewhere, and the lookups are psum'd
        (exact: one slot adds each row)."""
        W = self.mesh.size

        def fn(params, bottoms, train):
            rows = []
            for w in range(W):
                table = params[w][0]
                m, v = self._model_index(w), table.shape[0]
                if lp.type == "Embed":
                    ids = bottoms[w][0].long()
                else:
                    s = bottoms[w][0].shape[1]
                    start = s * self.mesh.axis_index(w, self.seq_axis) \
                        if seq_rows else 0
                    ids = torch.arange(start, start + s, device=table.device)
                local = ids - m * v
                hit = (local >= 0) & (local < v)
                got = table[local.clamp(0, v - 1)]
                rows.append(got * hit[..., None].to(got.dtype))
            rows = psum(rows, self.mesh, MODEL_AXIS)
            outs = []
            for w in range(W):
                if lp.type == "Embed":
                    y = rows[w]
                    if impl.bias_term:
                        y = y + self._gather_param(
                            [p[1] for p in params], specs.get(1, ()))[w]
                    cd = getattr(impl, "compute_dtype", None)
                    outs.append([y.to(cd) if cd is not None else y])
                else:
                    x = bottoms[w][0]
                    outs.append([x + rows[w].to(x.dtype)[None]])
            return outs

        return fn

    def _gathered(self, lp, impl, specs, in_split, gather, top_seq, whole,
                  pooled=False):
        """A layer with no split form: split blobs and model-split bottoms
        all_gathered over "model", the ``gather`` bottoms over "seq" along
        dim 1. With ``whole`` the layer runs once per (data, model) group
        with no "seq" axis published (it sees whole sequences), and each
        slot narrows the ``top_seq`` tops to its rows; with ``pooled`` its
        bottoms are all_gathered over "data" too and it runs once per
        model index; else it runs on every slot as that slot."""
        W = self.mesh.size
        if impl.has_state or impl.needs_rng:
            raise ValueError(f"{lp.name} ({lp.type}): no tensor- or "
                             "sequence-parallel form for a layer with state "
                             "or randomness")
        groups = self._model_groups() if pooled else self._seq_groups(whole)

        def fn(params, bottoms, train):
            ps = [list(p) for p in params]
            for i, s in specs.items():
                full = self._gather_param([p[i] for p in params], s)
                for w in range(W):
                    ps[w][i] = full[w]
            bs = [list(b) for b in bottoms]
            for j, (m_split, s_split) in enumerate(zip(in_split, gather)):
                col = [b[j] for b in bottoms]
                if m_split:
                    col = self._gather_act(col)
                if s_split:
                    col = self._gather_seq(col)
                if pooled and col[0].dim():
                    col = all_gather(col, self.mesh, DATA_AXIS, dim=0)
                for w in range(W):
                    bs[w][j] = col[w]
            outs = [None] * W
            for g in groups:
                scope = context.axis_context(seq=None) if whole or pooled \
                    else context.slot_context(self.mesh, g[0])
                with scope:
                    tops = impl.apply(ps[g[0]], bs[g[0]], train)
                parts = [t.chunk(len(g), dim=1) if s else [t] * len(g)
                         for t, s in zip(tops, top_seq)]
                for i, w in enumerate(g):
                    outs[w] = [p[i] for p in parts]
            return outs

        return fn
