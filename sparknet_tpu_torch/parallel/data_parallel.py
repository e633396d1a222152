"""Distributed solvers over W worker slots stacked on one device:
per-step data parallelism and tau-step local SGD (the port of
sparknet_tpu/parallel/data_parallel.py).

The JAX package runs each worker on one device of a "data" mesh axis
under shard_map, and its collective is a pmean over that axis. The port
trains on one card, so the W workers are slots on it (W stands in for
the data axis size, and snapshots are stamped ``mesh: {"data": W}``),
and a step or round is a loop over the slots:

  DataParallelSolver  each slot takes its shard's gradient through a
                      per-shard twin of the net at batch B/W; the
                      gradients are averaged over the slots (pmean, not
                      psum: the effective lr of single-device training
                      on the global batch), then one update.
  LocalSGDSolver      the SparkNet algorithm (CifarApp.scala:92-135):
                      each slot takes tau solver steps on its own rows of
                      the round's batches, then the params and the net
                      state are averaged over the slots; the history
                      stays per slot unless ``average_history``.

A loop over slots rather than ``torch.func.vmap``: the port's CUDA
kernels are autograd Functions launched through ctypes and have no vmap
rule, and the loop keeps activation memory at one worker's.

Not ported (ROADMAP A6), refused with a ValueError: the hierarchical
``host_axis`` mode, bounded staleness, elastic membership masks, the
heartbeat and its cross-host relay. Also left out: run()'s signal,
recovery and quorum handling, and the observability hooks (divergence,
comms accounting).
"""

import numpy as np
import torch

from ..data.prefetch import wait_staged
from ..graph.compiler import CompiledNet
from ..solver.solver import Solver, clear_grads, grads_of, to_device

DATA_AXIS = "data"


def slot_mean(stacked):
    """The average over the slot axis (dim 0): the port's pmean."""
    return stacked.mean(0)


def _not_ported(feature):
    return ValueError(f"{feature} is not ported (ROADMAP A6): the port runs "
                      "the plain synchronous round with every worker valid")


def _rebatch(net, n):
    """A per-shard twin of ``net``: the same layers, device and
    precision, feed blobs with their leading (batch) dim divided by
    ``n``."""
    local = {}
    for name, s in net.feed_shapes().items():
        if not s:
            local[name] = s
            continue
        if s[0] % n:
            raise ValueError(
                f"feed blob {name!r} batch {s[0]} not divisible by mesh "
                f"axis size {n}")
        local[name] = (s[0] // n,) + tuple(s[1:])
    return CompiledNet(net.net_param, net.phase, feed_shapes=local,
                       device=net.device, compute_dtype=net.compute_dtype)


def _rows(v, w, b, dim):
    """Slot ``w``'s rows [w*b, (w+1)*b) of ``v`` along ``dim`` (0 or
    1); a scalar blob is every slot's."""
    if np.ndim(v) <= dim:
        return v
    return v[w * b:(w + 1) * b] if dim == 0 else v[:, w * b:(w + 1) * b]


def _average_states(states):
    """Each slot's net state -> their average (BN-style running stats
    must stay replicated)."""
    return {name: [slot_mean(torch.stack([s[name][i] for s in states]))
                   for i in range(len(blobs))]
            for name, blobs in states[0].items()}


class _SlotSolver(Solver):
    """A Solver over ``workers`` slots, each with its own randomness: a
    CPU torch.Generator per slot drawn from the solver's seed and the
    slot index (the counterpart of jax.random.fold_in(rng, w))."""

    def __init__(self, solver_param, workers=1, **kw):
        self.workers = int(workers)
        if self.workers < 1:
            raise ValueError(f"workers must be at least 1, got {workers}")
        self.mesh_shape = {DATA_AXIS: self.workers}
        super().__init__(solver_param, **kw)
        base = int(torch.randint(0, 2 ** 62, (), generator=self.generator))
        self.slot_generators = [
            torch.Generator().manual_seed(
                (base ^ ((w + 1) * 0x9E3779B97F4A7C15)) % 2 ** 63)
            for w in range(self.workers)]

    def arm_elastic(self, *args, **kwargs):
        raise _not_ported("elastic membership (validity-masked consensus)")

    def arm_heartbeat(self, *args, **kwargs):
        raise _not_ported("the heartbeat and its cross-host relay")

    def arm_staleness(self, *args, **kwargs):
        raise _not_ported("bounded staleness")


class DataParallelSolver(_SlotSolver):
    """Solver whose train step runs each of ``workers`` slots on its
    shard of the global batch and averages their gradients.

    pmean (not psum) keeps the effective lr identical to single-device
    training on the same *global* batch, matching Caffe's semantics where
    the loss is already normalized by the full batch size. Test scores
    are the mean over shards."""

    def __init__(self, solver_param, workers=1, staleness=None, **kw):
        if staleness is not None:
            raise _not_ported("staleness (bounded-staleness async steps)")
        super().__init__(solver_param, workers=workers, **kw)
        # the per-shard nets: same params, feed blobs at batch/W (the
        # user-facing self.net keeps the global shapes)
        self.local_net = _rebatch(self.net, self.workers)
        self.local_test_net = _rebatch(self.test_net, self.workers) \
            if self.test_net is not None else None

    def _shards(self, batch, net, dim):
        b = {k: s[0] for k, s in net.feed_shapes().items() if s}
        return [{k: _rows(v, w, b.get(k, 0), dim) for k, v in batch.items()}
                for w in range(self.workers)]

    def train_step(self, batch):
        """One step on the global batch; returns the mean of the slots'
        losses as a 0-d tensor on the device. With iter_size > 1 the
        arrays carry a leading micro-batch axis and the shards split
        dim 1."""
        iter_size = int(self.param.iter_size)
        self.check_batch(batch, leading=(iter_size,) if iter_size > 1
                         else ())
        batch = self._transform(to_device(wait_staged(batch), self.device),
                                self.input_transform, iter_size)
        clear_grads(self.params)
        losses, states = [], []
        shards = self._shards(batch, self.local_net, int(iter_size > 1))
        for shard, gen in zip(shards, self.slot_generators):
            micros = [shard] if iter_size == 1 else \
                [{k: v[i] for k, v in shard.items()}
                 for i in range(iter_size)]
            state, slot = self.state, []
            for micro in micros:
                loss, (_, state) = self.local_net.loss_fn(
                    self.params, state, micro, gen)
                loss.backward()       # .grad sums the slots' gradients
                slot.append(loss.detach())
            losses.append(torch.stack(slot).mean())
            states.append(state)
        grads = {name: [g / self.workers for g in gs]
                 for name, gs in grads_of(self.params).items()}
        self.state = _average_states(states)
        self.updater(self.params, grads, self.history,
                     self.lr_fn(self.iter), self.iter)
        self.iter += 1
        return torch.stack(losses).mean()

    def _test_outputs(self, batch):
        outs = []
        for shard in self._shards(batch, self.local_test_net, 0):
            blobs, _ = self.local_test_net.apply(self.params, self.state,
                                                 shard, train=False)
            outs.append({b: blobs[b].float()
                         for b in self.local_test_net.output_blobs})
        # test scores are batch means: the mean over equal shards
        return {b: slot_mean(torch.stack([o[b] for o in outs]))
                for b in outs[0]}


class LocalSGDSolver(_SlotSolver):
    """tau-step local SGD with periodic weight averaging, the SparkNet
    outer loop. Each slot w runs tau sequential solver steps on its rows
    of the round's batches, with its own lr schedule positions (the
    global iter advances tau per round, as each reference worker's
    native solver advances its own iter counter); then the params (and
    the net state) are averaged over the slots.

    The slots live stacked: every param and history blob is one (W,
    ...) tensor, slot w works on the views ``[w]``, and the average is
    one mean over dim 0 per blob. ``params`` and ``history`` are slot
    0's views: after a round every slot's params equal the consensus,
    and the history a snapshot writes is slot 0's, the copy the JAX
    package's snapshot fetches (its round hands the per-device history
    back under a replicated out_spec, and a host read takes the first
    device's). A restore gives every slot the snapshot's history.

    average_history=True also averages the optimizer state each round;
    the reference does NOT (each Caffe worker keeps its own momentum,
    only weights are collected and broadcast — Net.scala:134-154), so
    default False.
    """

    def __init__(self, solver_param, workers=1, tau=10,
                 average_history=False, host_axis=None, staleness=None,
                 **kw):
        if host_axis is not None:
            raise _not_ported(
                "host_axis (hierarchical local SGD over host fault domains)")
        if staleness is not None:
            raise _not_ported("staleness (bounded-staleness async rounds)")
        self.tau = int(tau)
        if self.tau < 1:
            raise ValueError(f"tau must be at least 1, got {tau}")
        self.average_history = bool(average_history)
        super().__init__(solver_param, workers=workers, **kw)
        self._stack()

    @torch.no_grad()
    def _stack(self):
        """Slot storage from ``params`` and ``history``: each blob
        repeated into a (W, ...) tensor, and the per-slot views."""
        W = self.workers
        self.slot_params = {n: [torch.stack([p.detach()] * W) for p in ps]
                            for n, ps in self.params.items()}
        self.slot_history = {
            n: [[torch.stack([h.detach()] * W) for h in hs] for hs in hss]
            for n, hss in self.history.items()}
        self._param_views = [
            {n: [P[w].requires_grad_(True) for P in ps]
             for n, ps in self.slot_params.items()} for w in range(W)]
        self._history_views = [
            {n: [[H[w] for H in hs] for hs in hss]
             for n, hss in self.slot_history.items()} for w in range(W)]
        self.params = self._param_views[0]
        self.history = self._history_views[0]

    def load_weights(self, caffemodel_path):
        """Caffe CopyTrainedLayersFrom into every slot (the JAX package
        places the loaded params replicated)."""
        super().load_weights(caffemodel_path)
        with torch.no_grad():
            for name, ps in self.slot_params.items():
                for P, p in zip(ps, self.params[name]):
                    # a layer the file lacks keeps its slot-0 view: clone
                    # so that the source never aliases the stack
                    P.copy_(p.detach().clone().unsqueeze(0).expand_as(P))
        self.params = self._param_views[0]

    def restore(self, state_path):
        """Resume from a .solverstate: every slot takes its weights and
        its history (the JAX package places both replicated)."""
        super().restore(state_path)
        with torch.no_grad():
            for hss in self.slot_history.values():
                for hs in hss:
                    for H in hs:
                        H[1:].copy_(H[0].unsqueeze(0).expand_as(H[1:]))

    @torch.no_grad()
    def average_slots(self, states=None):
        """The round's collect & average (CifarApp.scala:131-133): one
        mean over the slot axis per param blob (and per history blob
        with average_history), which every slot then takes; ``states``,
        each slot's net state, average into ``state``."""
        groups = [P for ps in self.slot_params.values() for P in ps]
        if self.average_history:
            groups += [H for hss in self.slot_history.values()
                       for hs in hss for H in hs]
        for P in groups:
            P.copy_(slot_mean(P).unsqueeze(0).expand_as(P))
        if states:
            self.state = _average_states(states)

    def train_round(self, batches):
        """One outer round. ``batches``: {blob: (tau, W*B, ...)} — tau
        steps, slot w taking rows [w*B, (w+1)*B) of dim 1 (as the JAX
        package's shard_batch(..., batch_dim=1) slices them). Returns
        the mean over slots of each slot's mean loss over its tau steps,
        a 0-d tensor on the device. Under an input transform the batches
        are the raw feed, each step's rows transformed on the device."""
        shapes = self.input_shapes()
        self.check_batch(batches, shapes={
            n: (self.tau, self.workers * s[0]) + tuple(s[1:])
            for n, s in shapes.items() if s})
        batches = to_device(wait_staged(batches), self.device)
        b = {k: s[0] for k, s in shapes.items() if s}
        it0 = self.iter
        slot_losses, states = [], []
        for w in range(self.workers):
            params, history = self._param_views[w], self._history_views[w]
            gen, state, losses = self.slot_generators[w], self.state, []
            for i in range(self.tau):
                batch = self._transform(
                    {k: _rows(v[i], w, b.get(k, 0), 0)
                     for k, v in batches.items()}, self.input_transform)
                clear_grads(params)
                loss, (_, state) = self.net.loss_fn(params, state, batch,
                                                    gen)
                loss.backward()
                self.updater(params, grads_of(params), history,
                             self.lr_fn(it0 + i), it0 + i)
                losses.append(loss.detach())
            clear_grads(params)
            slot_losses.append(torch.stack(losses).mean())
            states.append(state)
        self.average_slots(states)
        self.iter += self.tau
        return torch.stack(slot_losses).mean()

    def run(self, num_rounds, batch_fn, test_data_fn=None, test_every=10,
            snapshot_prefix=None, snapshot_every=0, resume=None):
        """The reference training loop (CifarApp.scala:92-135): for each
        round, test every ``test_every`` rounds (:98), then train tau
        steps per slot. ``batch_fn(tau)`` -> batches as train_round
        takes them. resume="auto" restores the newest valid snapshot
        under the prefix first (a path restores that snapshot);
        ``snapshot_every`` N snapshots every N completed rounds. Returns
        the last round's loss."""
        from ..resilience import checkpoint
        prefix = snapshot_prefix or (self.param.snapshot_prefix
                                     if self.param.has("snapshot_prefix")
                                     else None)
        if resume == "auto":
            if prefix:
                checkpoint.resume_auto(self, prefix, log_fn=self.log)
            else:
                self.log("resume auto: no snapshot prefix; starting fresh")
        elif resume:
            self.restore(resume)
        loss = None
        for r in range(num_rounds):
            if test_data_fn is not None and r % test_every == 0 \
                    and self.test_net is not None:
                for k, v in self.test(test_data_fn()).items():
                    self.log(f"round {r}: test {k} = {v}")
            loss = float(self.train_round(batch_fn(self.tau)))
            self.log(f"round {r}: mean local loss = {loss:.6g}")
            if prefix and snapshot_every and (r + 1) % snapshot_every == 0:
                self.snapshot(prefix=prefix)
        return loss
