"""The net's layers in lock step over the slots of a mesh, and the solver
base of the port's mesh solvers (sequence, expert and tensor
parallelism).

Under shard_map every device of the JAX package's mesh runs the whole
step, and a layer that needs its peers (ring attention, the MoE
all_to_all, a Megatron psum) issues a collective in the middle of it.
The port's slots share one card and one Python loop, so a step whose
layers exchange data cannot run slot after slot: ``lockstep_apply``
runs the net one layer at a time, and within a layer one slot at a
time, under ``context.slot_context`` (so a layer reads its coordinates
with ``context.axis_index``). A layer that must see every slot at once
— an ``overrides`` entry, or a layer whose ``slot_coupled()`` is true
under the published axes — gets one list per argument instead (params,
bottoms, one entry a slot) and returns one list of tops a slot, built
with parallel/mesh.py's collectives. Everything stays one autograd
graph: the whole step's activations live at once, and one backward
carries every collective's transpose back across the slots.

Remat (``--remat``) wraps each of the net's ``block{i}/`` segments,
taken over all slots together, in one torch.utils.checkpoint, so a
recompute replays the segment's collectives too.

MeshSolver trains on such a mesh: every slot's param tree is a set of
views into the full logical tensors of ``params`` (the same tensor where
a blob is replicated), so snapshots, restores and weight loads keep the
single-device files, and the gradients of all slots meet in the full
tensors' ``.grad``. The step's loss is the mean of the slots' losses,
and its gradient is what the JAX package's per-axis pmeans assemble
(parallel/seq_parallel.py, expert_parallel.py, gspmd.py say why for
each).
"""

import time

import numpy as np
import torch

from ..graph import fission
from ..graph.compiler import (REMAT_POLICIES, TRAIN, _checkpointed,
                              _env_remat)
from ..solver.solver import clear_grads, grads_of, to_device
from ..data.prefetch import wait_staged
from . import context
from .data_parallel import _SlotSolver, _rebatch, slot_mean


def _coupled(impl, lp, overrides):
    fn = (overrides or {}).get(lp.name)
    if fn is not None:
        return fn
    probe = getattr(impl, "slot_coupled", None)
    if probe is not None and probe():
        return impl.apply_slots
    return None


def _run_range(net, mesh, params, states, new_states, blobs, lo, hi,
               batches, train, rngs, overrides, fiss):
    """Layers [lo, hi) of ``net`` over every slot's blob dict (a slot's
    own layers through fission.try_apply when ``fiss``, as each device's
    forward is in the JAX package)."""
    W = mesh.size
    for li in range(lo, hi):
        lp, impl, bottoms, tops = net.layers[li]
        fn = None if getattr(impl, "is_feed", False) else \
            _coupled(impl, lp, overrides)
        if fn is None:
            for w in range(W):
                with context.slot_context(mesh, w):
                    net._apply_range(params[w], states[w], new_states[w],
                                     blobs[w], li, li + 1, batches[w],
                                     train, rngs[w], {}, fiss)
            continue
        lparams = [net.resolve_params(params[w], lp.name) for w in range(W)]
        bvals = [[fission.materialize(blobs[w][b]) for b in bottoms]
                 for w in range(W)]
        out = fn(lparams, bvals, train)
        for w in range(W):
            for t, v in zip(tops, out[w]):
                blobs[w][t] = v


def _run_segment(net, mesh, params, states, new_states, blobs, lo, hi,
                 batches, train, rngs, overrides, pol, fiss):
    """Layers [lo, hi) of every slot under one torch.utils.checkpoint; a
    virtual concat crosses its boundary as its branches (fission.spread),
    as in CompiledNet._apply_segment."""
    W = mesh.size
    in_names = [sorted({b for j in range(lo, hi)
                        for b in net.layers[j][2] if b in blobs[w]})
                for w in range(W)]
    out_names = net._segment_externals(lo, hi)
    gens = [{j: rngs[w][j] for j in range(lo, hi) if j in rngs[w]}
            for w in range(W)]
    gen_states = [{j: g.get_state() for j, g in gs.items()} for gs in gens]
    if any(net.layers[j][1].has_state for j in range(lo, hi)):
        raise ValueError("remat over slots: a segment with net state is "
                         "not supported")
    ins = [fission.spread([blobs[w][n] for n in in_names[w]])
           for w in range(W)]
    out_parts = [None] * W      # set by the forward's run of seg_fn
    # the backward's recompute runs outside the step's contexts: it
    # takes the forward's axes along, so the same layers couple
    axes = context.current_axes()

    def seg_fn(*flat):
        for gs, st in zip(gens, gen_states):
            for j, g in gs.items():
                g.set_state(st[j])
        sblobs, k = [], 0
        for w, (f, parts) in enumerate(ins):
            sblobs.append(dict(zip(in_names[w], fission.gather(
                flat[k:k + len(f)], parts))))
            k += len(f)
        scratch = [{} for _ in range(W)]
        with context.axis_context(**axes), context.mesh_context(mesh):
            _run_range(net, mesh, params, states, scratch, sblobs, lo, hi,
                       batches, train, rngs, overrides, fiss)
        outs = []
        for w in range(W):
            f, out_parts[w] = fission.spread([sblobs[w][n]
                                              for n in out_names])
            outs.extend(f)
        return tuple(outs)

    outs = _checkpointed(seg_fn, pol, *[t for f, _ in ins for t in f])
    produced = {t for j in range(lo, hi) for t in net.layers[j][3]}
    k = 0
    for w in range(W):
        for n in produced.difference(out_names):
            blobs[w].pop(n, None)
        m = sum(max(c, 1) for c in out_parts[w])
        for n, v in zip(out_names, fission.gather(outs[k:k + m],
                                                  out_parts[w])):
            blobs[w][n] = v
        k += m


def _run_layers(net, mesh, params, states, new_states, blobs, lo, hi,
                batches, train, rngs, overrides, groups, pol, fiss):
    """Layers [lo, hi): each remat segment (``groups``) under one
    checkpoint, every other layer alone."""
    li = lo
    while li < hi:
        end = groups.get(li)
        if end is None:
            _run_range(net, mesh, params, states, new_states, blobs, li,
                       li + 1, batches, train, rngs, overrides, fiss)
            li += 1
        else:
            _run_segment(net, mesh, params, states, new_states, blobs, li,
                         end, batches, train, rngs, overrides, pol, fiss)
            li = end


def lockstep_apply(net, mesh, params, states, batches, train=None,
                   generators=None, overrides=None):
    """The forward of ``net`` on every slot of ``mesh``: ``params``,
    ``states``, ``batches`` and ``generators`` are one entry a slot;
    returns one (blobs, new_state) a slot. ``overrides``: {layer name:
    fn(params a slot, bottoms a slot, train) -> tops a slot}. The net's
    remat, fission and scan policies apply as in CompiledNet.apply: a
    scan run's layers take neither fission nor the epilogue, and leave
    its internal blobs absent (CompiledNet._apply_scan)."""
    W = mesh.size
    if train is None:
        train = net.phase == TRAIN
    pol = (net.remat if net.remat is not None else _env_remat()) \
        if train else "none"
    if pol not in REMAT_POLICIES:
        raise ValueError(f"remat={pol!r}: want none|dots|full")
    groups = net._remat_groups() if pol != "none" else {}
    runs = net._scan_runs() if net._scan_enabled() else []
    fiss = fission.enabled()
    gens = generators or [None] * W
    rngs = [net._layer_generators(g) if train else {} for g in gens]
    blobs = [{n: net._feed(b[n]) for n in net.net_inputs} for b in batches]
    new_states = [dict(s) for s in states]
    step = (net, mesh, params, states, new_states, blobs)
    rest = (batches, train, rngs, overrides, groups, pol)
    with context.mesh_context(mesh):
        li = 0
        for run in runs:
            _run_layers(*step, li, run["lo"], *rest, fiss)
            for b in blobs:
                b[run["entry"]] = fission.materialize(b[run["entry"]])
            _run_layers(*step, run["lo"], run["hi"], *rest, False)
            for b in blobs:
                for n in net.scan_dropped(run):
                    b.pop(n, None)
            li = run["hi"]
        _run_layers(*step, li, len(net.layers), *rest, fiss)
    return list(zip(map(fission.LazyBlobs, blobs), new_states))


class MeshSolver(_SlotSolver):
    """A Solver whose step runs the net in lock step over the slots of a
    SlotMesh. Subclasses set the mesh, which axes split the batch
    (``batch_axes``) and the sequence (``seq_axis``), the logical axes
    the layers see (``_axes``), the per-slot param views
    (``_slot_params``) and layer overrides (``_overrides``)."""

    batch_axes = ()
    seq_axis = None

    def __init__(self, solver_param, mesh, **kw):
        if int(solver_param.iter_size) > 1:
            raise ValueError(f"{type(self).__name__} does not support "
                             "iter_size > 1")
        self.mesh = mesh
        self.mesh_shape = dict(mesh.shape)
        super().__init__(solver_param, workers=mesh.size, **kw)
        n_batch = 1
        for a in self.batch_axes:
            n_batch *= mesh.shape.get(a, 1)
        seq = mesh.shape.get(self.seq_axis, 1) if self.seq_axis else 1
        self.local_net = _rebatch(self.net, n_batch, seq=seq)
        self.local_test_net = _rebatch(self.test_net, n_batch, seq=seq) \
            if self.test_net is not None else None

    def _axes(self):
        return {}

    def _slot_params(self):
        return [self.params] * self.mesh.size

    def _overrides(self, net):
        return None

    def _slot_batches(self, batch, net):
        """Each slot's rows (and sequence columns) of the global batch."""
        mesh, out = self.mesh, []
        shapes = net.feed_shapes()
        for w in range(mesh.size):
            c = mesh.coords(w)
            bi = 0
            for a in self.batch_axes:
                bi = bi * mesh.shape.get(a, 1) + c.get(a, 0)
            si = c.get(self.seq_axis, 0) if self.seq_axis else 0
            slot = {}
            for k, v in batch.items():
                s = shapes.get(k)
                if not s or np.ndim(v) == 0:
                    slot[k] = v
                    continue
                b = s[0]
                v = v[bi * b:(bi + 1) * b]
                if self.seq_axis and len(s) >= 2 and np.ndim(v) >= 2:
                    sl = s[1]
                    v = v[:, si * sl:(si + 1) * sl]
                slot[k] = v
            out.append(slot)
        return out

    def _forward(self, net, batch, train):
        """Every slot's (blobs, new_state) for one global batch."""
        with context.axis_context(**self._axes()):
            return lockstep_apply(
                net, self.mesh, self._slot_params(),
                [self.state] * self.mesh.size,
                self._slot_batches(batch, net), train=train,
                generators=self.slot_generators if train else None,
                overrides=self._overrides(net))

    def train_step(self, batch):
        """One step on the global batch: the lock-step forward of every
        slot, the mean of their losses, one backward, one update."""
        self.check_batch(batch)
        fed = batch
        self._obs_begin()
        t0 = time.perf_counter()
        batch = self._transform(to_device(wait_staged(batch), self.device),
                                self.input_transform)
        clear_grads(self.params)
        outs = self._forward(self.local_net, batch, True)
        losses = torch.stack([self.local_net.total_loss(b)
                              for b, _ in outs])
        loss = losses.mean()
        loss.backward()
        if self.state:
            self.state = {n: [slot_mean(torch.stack(
                [s[n][i].detach() for _, s in outs]))
                for i in range(len(blobs))]
                for n, blobs in self.state.items()}
        self.updater(self.params, grads_of(self.params), self.history,
                     self.lr_fn(self.iter), self.iter)
        self.iter += 1
        self._obs_step(time.perf_counter() - t0, loss.detach(), fed)
        return self._chaos_loss(loss.detach())

    def _test_outputs(self, batch):
        outs = self._forward(self.local_test_net, batch, False)
        return {b: slot_mean(torch.stack([blobs[b].float()
                                          for blobs, _ in outs]))
                for b in self.local_test_net.output_blobs}
