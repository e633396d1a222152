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
files. The JAX solver's optional ``seq_axis`` (annotation-style
sequence sharding, the partitioner placing the attention's collectives)
is not ported; SeqParallelSolver is the port's sequence path.
"""

import numpy as np
import torch

from .lockstep import MeshSolver
from .mesh import (DATA_AXIS, MODEL_AXIS, all_gather, make_mesh, psum,
                   slot_rows)

# single-input elementwise layers: an activation split along its last
# dim stays split through them
_ELEMENTWISE = {"ReLU", "TanH", "Sigmoid", "AbsVal", "Power", "ELU", "BNLL",
                "Exp", "Log"}


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
    """Solver over a (data, model) slot grid whose split blobs live as
    per-slot shards. ``param_rule``: fn(layer_name, blob_idx, shape) ->
    spec tuple."""

    def __init__(self, solver_param, mesh=None, param_rule=None,
                 seq_axis=None, **kw):
        if seq_axis is not None:
            raise ValueError(
                "GSPMDSolver(seq_axis=...): annotation-style sequence "
                "sharding is not ported; use SeqParallelSolver")
        mesh = mesh if mesh is not None else \
            make_mesh({DATA_AXIS: -1, MODEL_AXIS: 1})
        if param_rule is not None:
            self.param_rule = param_rule
        elif MODEL_AXIS in mesh.shape:
            self.param_rule = default_param_rule(mesh.shape[MODEL_AXIS])
        else:
            self.param_rule = lambda lname, i, shape: ()
        self.batch_axes = (DATA_AXIS,)
        super().__init__(solver_param, mesh, **kw)
        self.tp = mesh.shape.get(MODEL_AXIS, 1)
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
        return {"data": DATA_AXIS, "model": MODEL_AXIS}

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
        if self.tp <= 1:
            return None
        if id(net) not in self._plans:
            self._plans[id(net)] = self._plan(net)
        return self._plans[id(net)]

    def _plan(self, net):
        """{layer name: slot fn} for every layer that holds a split blob
        or reads a split activation, walking the net once to track which
        blobs are split along their last dim."""
        split, out = set(), {}
        for lp, impl, bottoms, tops in net.layers:
            owned = {i: s for i, s in enumerate(self.specs.get(lp.name, []))}
            has_split = any(_split_dim(s) is not None
                            for s in owned.values())
            in_split = [b in split for b in bottoms]
            for t in tops:
                split.discard(t)
            if not has_split and not any(in_split):
                continue
            if lp.type == "InnerProduct" and impl.axis == len(
                    net.blob_shapes[bottoms[0]]) - 1:
                fn, top_split = self._inner_product(lp, impl, owned,
                                                    in_split[0])
            elif lp.type == "Attention":
                fn, top_split = self._attention(lp, impl, owned,
                                                in_split[0]), False
            elif lp.type in ("Embed", "PositionalEmbed") and \
                    _split_dim(owned.get(0, ())) == 0 and not any(in_split):
                fn, top_split = self._table(lp, impl, owned), False
            elif lp.type in _ELEMENTWISE and not has_split:
                fn, top_split = None, in_split[0]
            else:
                fn, top_split = self._gathered(lp, impl, owned,
                                               in_split), False
            if top_split:
                split.update(tops)
            if fn is not None:
                out[lp.name] = fn
        return out

    def _gather_act(self, xs):
        return all_gather(xs, self.mesh, MODEL_AXIS, dim=-1)

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

    def _attention(self, lp, impl, specs, in_split):
        """Each slot projects its H/N heads (or, with wqkv replicated,
        all of them), runs the core on them, and multiplies by its part
        of wo; the partials are psum'd before bo (wo row-split), or the
        heads all_gathered first (wo replicated)."""
        heads = _split_dim(specs.get(0, ())) == 0
        wo_row = _split_dim(specs.get(2, ())) == 1
        bsplit = _split_dim(specs.get(1, ())) is not None
        W, n = self.mesh.size, self.tp

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
            os = []
            for w in range(W):
                p = [params[w][0], bq[w]]
                q, k, v = impl.project(p, xs[w])
                o = impl.core(q, k, v)
                b, h, s, d = o.shape
                os.append(o.transpose(1, 2).reshape(b, s, h * d))
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

    def _table(self, lp, impl, specs):
        """Embed / PositionalEmbed over a row-split table: each slot looks
        up the ids (or positions) that fall in its rows, zeros elsewhere,
        and the lookups are psum'd (exact: one slot adds each row)."""
        W = self.mesh.size

        def fn(params, bottoms, train):
            rows = []
            for w in range(W):
                table = params[w][0]
                m, v = self._model_index(w), table.shape[0]
                if lp.type == "Embed":
                    ids = bottoms[w][0].long()
                else:
                    ids = torch.arange(bottoms[w][0].shape[1],
                                       device=table.device)
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

    def _gathered(self, lp, impl, specs, in_split):
        """A layer with no split form: split blobs and split bottoms
        all_gathered, then the layer's own apply on every slot."""
        W = self.mesh.size
        if impl.has_state or impl.needs_rng:
            raise ValueError(f"{lp.name} ({lp.type}): no tensor-parallel "
                             "form for a layer with state or randomness")

        def fn(params, bottoms, train):
            ps = [list(p) for p in params]
            for i, s in specs.items():
                full = self._gather_param([p[i] for p in params], s)
                for w in range(W):
                    ps[w][i] = full[w]
            bs = [list(b) for b in bottoms]
            for j, sp in enumerate(in_split):
                if sp:
                    full = self._gather_act([b[j] for b in bottoms])
                    for w in range(W):
                        bs[w][j] = full[w]
            return [impl.apply(ps[w], bs[w], train) for w in range(W)]

        return fn
