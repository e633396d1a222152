"""Distributed solvers over W worker slots stacked on one device:
per-step data parallelism and tau-step local SGD (the port of
sparknet_tpu/parallel/data_parallel.py).

The JAX package runs each worker on one device of a "data" mesh axis
under shard_map, and its collective is a masked pmean over that axis.
The port trains on one card, so the W workers are slots on it (W stands
in for the data axis size, and snapshots are stamped ``mesh: {"data":
W}``), and a step or round is a loop over the slots:

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

The consensus is resilience/elastic.py's masked average over the
stacked slots (dim 0): bit for bit the plain mean when every slot is
valid. ``arm_elastic`` masks out evicted and non-finite slots (the mask
is a tensor on the card, so membership changes rebuild nothing),
``arm_staleness`` weights them by their version lag, and the slots
still all compute, as the JAX round computes every device and masks the
dead ones.

LocalSGDSolver(host_axis="host", hosts=H) is the two-tier round over an
(H, W/H) grid of slots: the W/H slots of a host are one synchronous DP
group (their gradients averaged every step, one replica a host), the
hosts diverge for tau steps and the round's average is the masked
consensus over the host rows, with membership at host granularity. One
slot a host is the single-tier round bit for bit; one host is tau steps
of DataParallelSolver bit for bit. With the heartbeat armed
(``arm_heartbeat``) every round first passes the rendezvous gate, and
in a world of several processes the cross-host average goes through the
rendezvous directory (heartbeat.FileConsensus, the relay): the port has
no collective across processes (parallel/multihost.py).

A loop over slots rather than ``torch.func.vmap``: the port's CUDA
kernels are autograd Functions launched through ctypes and have no vmap
rule, and the loop keeps activation memory at one worker's.

With metrics on, each solver registers the bytes its JAX twin's
collective moves (obs/comms.py), and measures the slots' drift from
their consensus on the card (the divergence aux of
elastic.masked_consensus_stats): per-step gradient drift for
DataParallelSolver on its sampled steps, per-round weight drift for
LocalSGDSolver every round; the health detectors read both.
LocalSGDSolver.run polls signals, beats an armed watchdog, lets an armed
RecoveryPolicy redo a bad round, and on a lost quorum snapshots,
barriers with the surviving processes on the manifest and raises
QuorumLost (exit 4).
"""

import hashlib
import math
import time

import numpy as np
import torch

from ..data.prefetch import wait_staged
from ..graph.compiler import CompiledNet
from ..obs.comms import (broadcast_collect_bytes, ring_allreduce_bytes,
                         tree_bytes)
from ..obs.divergence import tree_sq_dist
from ..resilience.elastic import (masked_consensus, masked_consensus_stats,
                                  masked_scalar_mean, slots_finite,
                                  staleness_discount, weighted_consensus,
                                  weighted_consensus_stats)
from ..solver.solver import Solver, clear_grads, grads_of, to_device
from .overlap import (bucket_sizes, bucketed_consensus, overlap_enabled,
                      plan_buckets)

DATA_AXIS = "data"
HOST_AXIS = "host"


def slot_mean(stacked):
    """The average over the slot axis (dim 0): the port's pmean."""
    return stacked.mean(0)


def _rebatch(net, n, seq=1):
    """A per-slot twin of ``net``: feed blobs with their leading (batch)
    dim divided by ``n`` and, for ``seq`` > 1, dim 1 divided by ``seq``
    (rank-1 blobs keep dim 1: they hold no sequence)."""
    local = {}
    for name, s in net.feed_shapes().items():
        if not s:
            local[name] = s
            continue
        if s[0] % n:
            raise ValueError(
                f"feed blob {name!r} batch {s[0]} not divisible by mesh "
                f"axis size {n}")
        out = [s[0] // n] + list(s[1:])
        if seq > 1 and len(s) >= 2:
            if s[1] % seq:
                raise ValueError(
                    f"feed blob {name!r} seq dim {s[1]} not divisible "
                    f"by seq axis size {seq}")
            out[1] = s[1] // seq
        local[name] = tuple(out)
    return CompiledNet(net.net_param, net.phase, feed_shapes=local,
                       device=net.device, compute_dtype=net.compute_dtype)


def check_seq_shardable_losses(net, solver_name):
    """Sequence-sharded exactness (the mean of the shards' means is the
    global mean) needs every shard to normalize by the same token count;
    a loss with ignore_label normalizes by its local valid count, so
    shards with more padding would weigh their tokens more. Refused."""
    for lp, impl, _, _ in net.layers:
        if getattr(impl, "ignore_label", None) is not None and \
                net.loss_weights.get(lp.name) and \
                any(net.loss_weights[lp.name]):
            raise ValueError(
                f"layer {lp.name!r}: ignore_label losses normalize by "
                f"the per-shard valid-token count, which breaks "
                f"{solver_name}'s equal-shard loss/grad exactness "
                "(shards with more padding would be over-weighted). "
                "Drop ignore_label or mask labels on the host instead.")


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


def _stack_states(states):
    """Each unit's net state -> {name: [(U, ...) stacked blobs]}."""
    return {name: [torch.stack([s[name][i] for s in states])
                   for i in range(len(blobs))]
            for name, blobs in states[0].items()}


def _flat_leaves(tree):
    """{layer: [blobs]} (or {layer: [[slots]]}) -> its leaves in the
    order jax.tree_util.tree_flatten gives them: dict keys sorted, lists
    in order. The relay's payload order, so a JAX host and a port host
    exchange the same leaves."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flat_leaves(v)]
    return [tree]


class _SlotSolver(Solver):
    """A Solver over ``workers`` slots, each with its own randomness: a
    CPU torch.Generator per slot drawn from the solver's seed and the
    slot index (the counterpart of jax.random.fold_in(rng, w))."""

    def __init__(self, solver_param, workers=1, **kw):
        self.workers = int(workers)
        if self.workers < 1:
            raise ValueError(f"workers must be at least 1, got {workers}")
        if not hasattr(self, "mesh_shape"):
            self.mesh_shape = {DATA_AXIS: self.workers}
        super().__init__(solver_param, **kw)
        base = int(torch.randint(0, 2 ** 62, (), generator=self.generator))
        self.slot_generators = [
            torch.Generator().manual_seed(
                (base ^ ((w + 1) * 0x9E3779B97F4A7C15)) % 2 ** 63)
            for w in range(self.workers)]

    def rng_state(self):
        return super().rng_state() + [g.get_state()
                                      for g in self.slot_generators]

    def set_rng_state(self, states):
        super().set_rng_state(states[:1])
        for g, st in zip(self.slot_generators, states[1:]):
            g.set_state(st)

    def _membership_size(self):
        return self.workers


class DataParallelSolver(_SlotSolver):
    """Solver whose train step runs each of ``workers`` slots on its
    shard of the global batch and averages their gradients.

    pmean (not psum) keeps the effective lr identical to single-device
    training on the same *global* batch, matching Caffe's semantics where
    the loss is already normalized by the full batch size. Test scores
    are the mean over shards. With elastic membership armed the average
    is the masked consensus of the slots' gradients (each slot's
    gradient taken apart), and with staleness armed the weighted one;
    unarmed, the slots' gradients sum in ``.grad`` and are divided by
    W."""

    def __init__(self, solver_param, workers=1, staleness=None,
                 s_decay=0.5, mesh=None, **kw):
        if mesh is not None:
            # a mesh ({axis: size} or a SlotMesh; -1 is the card's one
            # device): only its "data" axis splits the batch, the other
            # axes replicate, and snapshots are stamped with all of it
            shape = dict(getattr(mesh, "shape", mesh))
            self.mesh_shape = {k: 1 if int(v) == -1 else int(v)
                               for k, v in shape.items()}
            workers = self.mesh_shape.get(DATA_AXIS, 1)
        super().__init__(solver_param, workers=workers, **kw)
        # the per-shard nets: same params, feed blobs at batch/W (the
        # user-facing self.net keeps the global shapes)
        self.local_net = _rebatch(self.net, self.workers)
        self.local_test_net = _rebatch(self.test_net, self.workers) \
            if self.test_net is not None else None
        if staleness is not None:
            # async bounded staleness at step granularity (the LocalSGD
            # round-granularity twin)
            self.arm_staleness(staleness, decay=s_decay)

    def _shards(self, batch, net, dim):
        b = {k: s[0] for k, s in net.feed_shapes().items() if s}
        return [{k: _rows(v, w, b.get(k, 0), dim) for k, v in batch.items()}
                for w in range(self.workers)]

    def train_step(self, batch):
        """One step on the global batch; returns the mean of the slots'
        losses (the masked mean, with elasticity armed) as a 0-d tensor
        on the device. With iter_size > 1 the arrays carry a leading
        micro-batch axis and the shards split dim 1."""
        iter_size = int(self.param.iter_size)
        self.check_batch(batch, leading=(iter_size,) if iter_size > 1
                         else ())
        fed = batch
        elastic_on = self.elastic is not None
        # on a sampled step with metrics on, each slot's own gradient is
        # kept for the divergence
        stats = self._obs_sampled_next() and self.divergence is not None
        self._obs_begin()
        t0 = time.perf_counter()
        batch = self._transform(to_device(wait_staged(batch), self.device),
                                self.input_transform, iter_size)
        clear_grads(self.params)
        losses, states, sums, slot_grads = [], [], [], []
        shards = self._shards(batch, self.local_net, int(iter_size > 1))
        for shard, gen in zip(shards, self.slot_generators):
            micros = [shard] if iter_size == 1 else \
                [{k: v[i] for k, v in shard.items()}
                 for i in range(iter_size)]
            if elastic_on:
                clear_grads(self.params)    # each slot's gradient apart
            state, slot = self.state, []
            for micro in micros:
                loss, (_, state) = self.local_net.loss_fn(
                    self.params, state, micro, gen)
                loss.backward()       # .grad sums the slots' gradients
                slot.append(loss.detach())
            losses.append(torch.stack(slot).mean())
            states.append(state)
            if elastic_on:
                slot_grads.append(grads_of(self.params))
            elif stats:
                sums.append({n: [g.detach().clone() for g in gs]
                             for n, gs in grads_of(self.params).items()})
        losses = torch.stack(losses)
        aux = None
        if elastic_on:
            grads, loss, aux, state = self._elastic_consensus(
                slot_grads, losses, states, stats)
            self.state = state
        else:
            grads = {name: [g / self.workers for g in gs]
                     for name, gs in grads_of(self.params).items()}
            if stats:
                stacked = {n: [torch.stack([sums[0][n][i]] + [
                    sums[w][n][i] - sums[w - 1][n][i]
                    for w in range(1, self.workers)])
                    for i in range(len(gs))] for n, gs in grads.items()}
                _, aux = masked_consensus_stats(
                    stacked, torch.ones(self.workers, device=self.device))
                aux["ref_sq"] = sum(g.float().square().sum()
                                    for gs in grads.values() for g in gs)
                aux["worker_loss"] = losses
            self.state = _average_states(states)
            loss = losses.mean()
        self.updater(self.params, grads, self.history,
                     self.lr_fn(self.iter), self.iter)
        self.iter += 1
        host_s = time.perf_counter() - t0
        if self.staleness is not None and elastic_on:
            # step-granularity version clocks: the DP twin of the
            # LocalSGD round bookkeeping
            it = self.iter - 1
            slow = self.chaos.slow_worker_spec(it) \
                if self.chaos is not None else None
            self.elastic.advance_versions(it, host_s, slow=slow)
            self.elastic.observe_staleness(it)
        if elastic_on:
            # membership every step (a (W,) fetch), whether or not the
            # step is sampled: the JAX solver with metrics on observes it
            # at its sampled steps only, and misses evictions between
            # them (ROADMAP C17)
            from ..obs.divergence import to_host
            self._observe_membership(to_host(
                {"valid": aux["valid"], "worker_loss": aux["worker_loss"]}))
            aux["membership_seen"] = True
        self._obs_step(host_s, loss, fed,
                       aux=dict(aux, kind="grads") if aux else None)
        return self._chaos_loss(loss)

    def _elastic_consensus(self, slot_grads, losses, states, stats):
        """The masked (or staleness-weighted) consensus of the slots'
        gradients and states: (grads, loss, aux, state)."""
        W = self.workers
        names = list(slot_grads[0])
        stacked = {n: [torch.stack([slot_grads[w][n][i] for w in range(W)])
                       for i in range(len(slot_grads[0][n]))]
                   for n in names}
        finite = slots_finite(stacked) & torch.isfinite(losses)
        valid = self._alive_mask() * finite.float()
        async_on = self.staleness is not None
        if async_on:
            sweight = valid * staleness_discount(
                self._staleness_lag(), self.staleness, self.s_decay)
            inc = (sweight > 0).float()
        else:
            sweight = inc = valid
        if stats:
            if async_on:
                grads, aux = weighted_consensus_stats(stacked, valid,
                                                      sweight)
            else:
                grads, aux = masked_consensus_stats(stacked, valid)
            aux["ref_sq"] = sum(g.float().square().sum()
                                for gs in grads.values() for g in gs)
        else:
            # reverse-order buckets under SPARKNET_OVERLAP (the default),
            # bit for bit the whole-tree consensus (parallel/overlap.py)
            fn, weight = (weighted_consensus, sweight) if async_on \
                else (masked_consensus, valid)
            grads, n_live = bucketed_consensus(fn, stacked, weight) \
                if overlap_enabled() else fn(stacked, weight)
            if async_on:
                n_live = inc.sum()
            aux = {"valid": valid, "n_live": n_live}
            if async_on:
                aux["weight"] = sweight
        aux["worker_loss"] = losses
        st = _stack_states(states) if states[0] else {}
        state = (weighted_consensus(st, sweight)[0] if async_on else
                 masked_consensus(st, valid)[0]) if st else states[0]
        return grads, masked_scalar_mean(losses, inc), aux, state

    def _register_comms(self, cm):
        """Per-step DP sync: the pmean of the gradients and the net state
        over the W slots, costed as the JAX package's allreduce over a
        W-device data axis: per reverse-order bucket under
        SPARKNET_OVERLAP (the default; every bucket but the last-issued
        one overlappable), else one whole-tree allreduce."""
        super()._register_comms(cm)
        n = self.workers
        gb, sb = tree_bytes(self.params), tree_bytes(self.state)
        cm.set_topology(axes=dict(self.mesh_shape))
        if not overlap_enabled():
            cm.register(
                "allreduce_grads", ring_allreduce_bytes(gb + sb, n),
                axis=DATA_AXIS,
                note="pmean(grads)+pmean(state) per step, ring model per "
                     "chip",
                paper_broadcast_collect_bytes=broadcast_collect_bytes(gb, n))
            return
        sizes = bucket_sizes(plan_buckets(self.params))
        for bi, nb in enumerate(sizes):
            extra = {}
            if bi == len(sizes) - 1:
                extra["paper_broadcast_collect_bytes"] = \
                    broadcast_collect_bytes(gb, n)
            cm.register(
                "allreduce_grads_bucket", ring_allreduce_bytes(nb, n),
                axis=DATA_AXIS, bucket=bi,
                overlappable=bi < len(sizes) - 1,
                note="bucketed pmean(grads), issued as backward drains; "
                     "ring model per chip", **extra)
        cm.register(
            "allreduce_state", ring_allreduce_bytes(sb, n), axis=DATA_AXIS,
            note="pmean(state) per step, ring model per chip")

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
    outer loop. Each consensus unit — a slot, or in two-tier mode a host
    of W/H slots — runs tau sequential solver steps on its rows of the
    round's batches, with its own lr schedule positions (the global iter
    advances tau per round, as each reference worker's native solver
    advances its own iter counter); then the params (and the net state)
    are averaged over the units.

    The units live stacked: every param and history blob is one (U,
    ...) tensor, unit u works on the views ``[u]``, and the average is
    one masked mean over dim 0 per blob. ``params`` and ``history`` are
    unit 0's views: after a round every unit's params equal the
    consensus, and the history a snapshot writes is unit 0's, the copy
    the JAX package's snapshot fetches. A restore gives every unit the
    snapshot's history.

    average_history=True also averages the optimizer state each round;
    the reference does NOT (each Caffe worker keeps its own momentum,
    only weights are collected and broadcast — Net.scala:134-154), so
    default False.

    host_axis="host" (with ``hosts`` H, or a multihost.SlotGrid as
    ``mesh``) arms the two-tier round: the W/H slots of a host average
    their gradients every step (one synchronous DP group, one replica),
    and membership — eviction, readmission, quorum — is per host.
    staleness=s arms the bounded-staleness async mode (arm_staleness).
    """

    def __init__(self, solver_param, workers=1, tau=10,
                 average_history=False, host_axis=None, hosts=None,
                 staleness=None, s_decay=0.5, mesh=None, **kw):
        if mesh is not None:
            hosts, workers = mesh.hosts, mesh.slots
            host_axis = host_axis or HOST_AXIS
        if host_axis is not None and host_axis != HOST_AXIS:
            raise ValueError(f"host_axis {host_axis!r}: the port's host "
                             f"axis is {HOST_AXIS!r}")
        self.host_axis = host_axis
        self.tau = int(tau)
        if self.tau < 1:
            raise ValueError(f"tau must be at least 1, got {tau}")
        self.average_history = bool(average_history)
        workers = int(workers)
        if host_axis is not None:
            self.hosts = int(hosts or 1)
            if self.hosts < 1 or workers % self.hosts:
                raise ValueError(f"{workers} workers not divisible by "
                                 f"{hosts} hosts")
            self.per_host = workers // self.hosts
            self.mesh_shape = {HOST_AXIS: self.hosts,
                               DATA_AXIS: self.per_host}
        elif hosts not in (None, 0, 1):
            raise ValueError("hosts needs host_axis='host'")
        # membership granularity: hosts in two-tier mode, slots otherwise
        self.elastic_axis = HOST_AXIS if host_axis is not None \
            else DATA_AXIS
        self.elastic_unit = "host" if host_axis is not None else "worker"
        # the cross-host transport of the tau-consensus: None = in
        # process; a heartbeat.FileConsensus when arm_heartbeat armed the
        # relay
        self._relay = None
        self._grow_pending = False
        super().__init__(solver_param, workers=workers, **kw)
        self._round_idx = 0
        self._stack()
        if staleness is not None:
            self.arm_staleness(staleness, decay=s_decay)

    @property
    def units(self):
        """Consensus units: hosts in two-tier mode, slots otherwise."""
        return self.hosts if self.host_axis is not None else self.workers

    @property
    def per_unit(self):
        return self.per_host if self.host_axis is not None else 1

    def _membership_size(self):
        return self.units

    @torch.no_grad()
    def _stack(self):
        """Unit storage from ``params`` and ``history``: each blob
        repeated into a (U, ...) tensor, and the per-unit views."""
        U = self.units
        self.slot_params = {n: [torch.stack([p.detach()] * U) for p in ps]
                            for n, ps in self.params.items()}
        self.slot_history = {
            n: [[torch.stack([h.detach()] * U) for h in hs] for hs in hss]
            for n, hss in self.history.items()}
        self._views()

    def _views(self):
        U = self.units
        self._param_views = [
            {n: [P[u].requires_grad_(True) for P in ps]
             for n, ps in self.slot_params.items()} for u in range(U)]
        self._history_views = [
            {n: [[H[u] for H in hs] for hs in hss]
             for n, hss in self.slot_history.items()} for u in range(U)]
        self.params = self._param_views[0]
        self.history = self._history_views[0]

    def training_tensors(self):
        """The stacked units of params and history, and the net state."""
        out = [P for ps in self.slot_params.values() for P in ps]
        out += [t for blobs in self.state.values() for t in blobs]
        out += [H for hss in self.slot_history.values() for hs in hss
                for H in hs]
        return out

    def _register_comms(self, cm):
        """The SparkNet tradeoff: ONE param-sized averaging pmean per
        tau-step round (against DP's per-step gradient allreduce), costed
        as the JAX package's over the consensus axis; in two-tier mode
        also the per-step gradient pmean inside each host."""
        super()._register_comms(cm)
        n = self.units
        pb = tree_bytes(self.params) + tree_bytes(self.state)
        if self.average_history:
            pb += tree_bytes(self.history)
        cm.set_topology(axes=dict(self.mesh_shape), tau=self.tau)
        cm.register(
            "param_average", ring_allreduce_bytes(pb, n),
            axis=self.elastic_axis, steps_per_round=self.tau,
            note="one weight-averaging pmean per tau-step round "
                 "(the paper's broadcast+collect)"
                 + (" across hosts" if self.host_axis is not None else ""),
            paper_broadcast_collect_bytes=broadcast_collect_bytes(pb, n))
        if self.host_axis is not None and self.per_host > 1:
            cm.register(
                "intra_host_grad_pmean",
                ring_allreduce_bytes(tree_bytes(self.params),
                                     self.per_host),
                axis=DATA_AXIS, steps_per_round=1,
                note="per-step gradient pmean inside each fault domain "
                     "(tier 1 of hierarchical local SGD)")

    def _round_latencies(self, round_s):
        """One round's time for every unit: the units run in turn on one
        card and the round ends when the last one has. A chaos stall or
        slow worker (slow host, in two-tier mode) with an attribution
        lands its seconds on that unit alone; in the async mode a slow
        worker's seconds are attributed virtually (they never blocked
        the loop)."""
        n = self.units
        if n <= 1 or round_s is None:
            return None
        lat = [float(round_s)] * n
        if self.chaos is not None:
            if self.staleness is not None:
                spec = self.chaos.slow_worker_spec(self._round_idx)
                if spec is not None and 0 <= spec[0] < n:
                    lat[spec[0]] = float(round_s) + float(spec[1])
                return lat
            rep = self.chaos.pop_stall()
            rep = self.chaos.pop_slow_worker() or rep
            if self.host_axis is not None:
                rep = self.chaos.pop_slow_host() or rep
            if rep and rep[0] is not None and 0 <= rep[0] < n:
                w, sec = rep
                base = max(0.0, float(round_s) - float(sec))
                lat = [base] * n
                lat[w] = float(round_s)
        return lat

    def load_weights(self, caffemodel_path):
        """Caffe CopyTrainedLayersFrom into every unit (the JAX package
        places the loaded params replicated)."""
        super().load_weights(caffemodel_path)
        with torch.no_grad():
            for name, ps in self.slot_params.items():
                for P, p in zip(ps, self.params[name]):
                    # a layer the file lacks keeps its unit-0 view: clone
                    # so that the source never aliases the stack
                    P.copy_(p.detach().clone().unsqueeze(0).expand_as(P))
        self.params = self._param_views[0]

    def restore(self, state_path, reshard="strict"):
        """Resume from a .solverstate: every unit takes its weights and
        its history (the JAX package places both replicated)."""
        super().restore(state_path, reshard=reshard)
        with torch.no_grad():
            for hss in self.slot_history.values():
                for hs in hss:
                    for H in hs:
                        H[1:].copy_(H[0].unsqueeze(0).expand_as(H[1:]))

    @torch.no_grad()
    def average_slots(self, states=None):
        """The round's collect & average with every unit valid (the plain
        mean over dim 0; CifarApp.scala:131-133), which every unit then
        takes; ``states``, each unit's net state, average into
        ``state``."""
        valid = torch.ones(self.units, device=self.device)
        self._adopt(masked_consensus(self.slot_params, valid)[0])
        if self.average_history:
            self._adopt_history(
                masked_consensus(self.slot_history, valid)[0])
        if states:
            self.state = _average_states(states)

    @torch.no_grad()
    def _adopt(self, consensus):
        for name, ps in self.slot_params.items():
            for P, c in zip(ps, consensus[name]):
                P.copy_(c.unsqueeze(0).expand_as(P))

    @torch.no_grad()
    def _adopt_history(self, consensus):
        for name, hss in self.slot_history.items():
            for hs, cs in zip(hss, consensus[name]):
                for H, c in zip(hs, cs):
                    H.copy_(c.unsqueeze(0).expand_as(H))

    def _local_round(self, batches):
        """Every unit's tau steps: (unit_losses (U,), step_losses (U,
        tau), unit states). A unit of several slots (two-tier mode)
        averages its slots' gradients every step, as DataParallelSolver
        does, and its slots' states once at the end of the round, as the
        JAX round folds them within the host."""
        shapes = self.input_shapes()
        b = {k: s[0] for k, s in shapes.items() if s}
        it0, P = self.iter, self.per_unit
        unit_losses, all_steps, states = [], [], []
        for u in range(self.units):
            params, history = self._param_views[u], self._history_views[u]
            slots = range(u * P, (u + 1) * P)
            st = [self.state] * P
            steps = []
            for i in range(self.tau):
                clear_grads(params)
                slot_losses = []
                for d, w in enumerate(slots):
                    batch = self._transform(
                        {k: _rows(v[i], w, b.get(k, 0), 0)
                         for k, v in batches.items()}, self.input_transform)
                    loss, (_, st[d]) = self.net.loss_fn(
                        params, st[d], batch, self.slot_generators[w])
                    loss.backward()
                    slot_losses.append(loss.detach())
                if P == 1:
                    grads, step_loss = grads_of(params), slot_losses[0]
                else:
                    grads = {n: [g / P for g in gs]
                             for n, gs in grads_of(params).items()}
                    step_loss = torch.stack(slot_losses).mean()
                self.updater(params, grads, history, self.lr_fn(it0 + i),
                             it0 + i)
                steps.append(step_loss)
            clear_grads(params)
            steps = torch.stack(steps)
            all_steps.append(steps)
            unit_losses.append(steps.mean())
            states.append(st[0] if P == 1 else _average_states(st))
        return torch.stack(unit_losses), torch.stack(all_steps), states

    def _check_round(self, batches):
        shapes = self.input_shapes()
        self.check_batch(batches, shapes={
            n: (self.tau, self.workers * s[0]) + tuple(s[1:])
            for n, s in shapes.items() if s})

    def train_round(self, batches):
        """One outer round. ``batches``: {blob: (tau, W*B, ...)} — tau
        steps, slot w taking rows [w*B, (w+1)*B) of dim 1 (slot-major
        over (host, data) in two-tier mode, as the JAX package's
        shard_batch(..., batch_dim=1) slices them). Returns the masked
        mean over the included units of each unit's mean loss over its
        tau steps, a 0-d tensor on the device. Under an input transform
        the batches are the raw feed, each step's rows transformed on
        the device."""
        async_on = self.staleness is not None
        if self.heartbeat is not None:
            # the round gate: never start a cross-host average until every
            # supposedly-live peer host has arrived (or its lease expired
            # and it was evicted); the async mode never waits
            self._heartbeat_gate(timeout=0.0 if async_on else None)
        if self._relay is not None:
            return self._train_round_relay(batches)
        self._check_round(batches)
        fed = batches
        self._obs_begin(self.tau)
        t0 = time.perf_counter()
        batches = to_device(wait_staged(batches), self.device)
        stats = self.divergence is not None
        if stats:   # the round's input: the consensus of the last round
            params_in = {n: [p.detach().clone() for p in ps]
                         for n, ps in self.params.items()}
        unit_losses, steps, states = self._local_round(batches)
        elastic_on = self.elastic is not None
        async_on = async_on and elastic_on
        alive = self._alive_mask()
        with torch.no_grad():
            if elastic_on:
                # the alive bit AND the on-device finite check: a unit
                # whose replica went non-finite mid-round cannot poison
                # the consensus even before the host evicts it
                finite = slots_finite(self.slot_params) & \
                    torch.isfinite(steps).all(1)
                valid = alive * finite.float()
            else:
                valid = alive
            if async_on:
                sweight = valid * staleness_discount(
                    self._staleness_lag(), self.staleness, self.s_decay)
                inc = (sweight > 0).float()
            else:
                sweight = inc = valid
            if stats:
                if async_on:
                    consensus, aux = weighted_consensus_stats(
                        self.slot_params, valid, sweight)
                else:
                    consensus, aux = masked_consensus_stats(
                        self.slot_params, valid)
                aux["ref_sq"] = tree_sq_dist(consensus, params_in)[1]
                aux["worker_loss"] = unit_losses
            elif elastic_on:
                if async_on:
                    consensus, _ = weighted_consensus(self.slot_params,
                                                      sweight)
                    n_live = inc.sum()
                else:
                    consensus, n_live = masked_consensus(self.slot_params,
                                                         valid)
                aux = {"valid": valid, "n_live": n_live,
                       "worker_loss": unit_losses}
                if async_on:
                    aux["weight"] = sweight
            else:
                consensus, _ = masked_consensus(self.slot_params, valid)
                aux = {}
            combine = (lambda t: weighted_consensus(t, sweight)[0]) \
                if async_on else (lambda t: masked_consensus(t, valid)[0])
            if states[0]:
                self.state = combine(_stack_states(states))
            if self.average_history:
                self._adopt_history(combine(self.slot_history))
            self._adopt(consensus)
            loss = masked_scalar_mean(unit_losses, inc)
        self.iter += self.tau
        self._obs_step(time.perf_counter() - t0, loss, fed, steps=self.tau)
        loss = self._chaos_loss(loss)   # may stall (the injected straggler)
        if self.chaos is not None and not async_on:
            # a chaos slow_worker under the SYNCHRONOUS barrier is a real
            # per-round stall: the average waits for the straggler
            self.chaos.maybe_slow_worker(self._round_idx)
        aux = dict(aux, kind="params") if aux else None
        if async_on:
            aux = self._observe_staleness_round(
                aux, time.perf_counter() - t0)
        if aux:
            # once per round: membership, the divergence event and the
            # detectors
            self._observe_sync_round(aux, round_s=time.perf_counter() - t0,
                                     round_idx=self._round_idx)
        self._round_idx += 1
        return loss

    def _observe_staleness_round(self, aux, round_s):
        """Async-mode bookkeeping a round: advance the per-unit version
        clocks (a chaos slow_worker pays its seconds on ITS clock, never
        the loop's), run the park/unpark controller, attach the lag and
        park state to the aux, and emit the ``staleness`` event.
        QuorumLost (a chronically parked unit evicted below quorum)
        propagates."""
        el = self.elastic
        slow = self.chaos.slow_worker_spec(self._round_idx) \
            if self.chaos is not None else None
        lag_used = el.lag()             # the lag the round's weights saw
        el.advance_versions(self._round_idx, round_s, slow=slow)
        el.observe_staleness(self._round_idx)
        aux = dict(aux) if aux else {"kind": "params"}
        aux["lag"] = [int(x) for x in lag_used]
        aux["parked"] = [int(w) for w in np.nonzero(el.parked)[0]]
        if self.metrics is not None:
            self.metrics.log(
                "staleness", round=self._round_idx, s=el.staleness,
                version=[int(v) for v in el.version],
                lag=[int(x) for x in el.lag()],
                parked=aux["parked"],
                park_rounds=[int(r) for r in el.park_rounds],
                weight=[round(float(x), 4)
                        for x in el.consensus_weights()])
        return aux

    # -- the cross-host tier over the rendezvous directory -----------------
    def _relay_trees(self):
        """The trees the relay exchanges, in payload order: params, net
        state, and with average_history the history (unit 0's: after the
        local round every unit holds the local consensus)."""
        trees = [self.params, self.state]
        if self.average_history:
            trees.append(self.history)
        return trees

    def _train_round_relay(self, batches):
        """The cross-host tier through the rendezvous directory
        (heartbeat.FileConsensus): run the LOCAL round (this process's
        units, the local average), then post the result and adopt the
        masked cross-host average. The same math as the in-process
        masked consensus, on the transport the paper itself used (a
        driver-mediated collect and broadcast every tau steps)."""
        t0 = time.perf_counter()
        self._check_round(batches)
        fed = batches
        self._obs_begin(self.tau)
        batches = to_device(wait_staged(batches), self.device)
        unit_losses, _, states = self._local_round(batches)
        with torch.no_grad():
            ones = torch.ones(self.units, device=self.device)
            self._adopt(masked_consensus(self.slot_params, ones)[0])
            if states[0]:
                self.state = masked_consensus(_stack_states(states),
                                              ones)[0]
            if self.average_history:
                self._adopt_history(
                    masked_consensus(self.slot_history, ones)[0])
            local_loss = float(unit_losses.mean())
        self.iter += self.tau
        trees = self._relay_trees()
        leaves = [_flat_leaves(t) for t in trees]
        payload = [x.detach().cpu().numpy() for lv in leaves for x in lv]
        valid = math.isfinite(local_loss) and \
            all(np.all(np.isfinite(x)) for x in payload)
        alive = self.elastic.live() if self.elastic is not None \
            else list(range(self.heartbeat.n))
        xt0 = time.perf_counter()
        consensus, aux = self._relay.exchange(
            self._round_idx, payload, valid, local_loss, alive)
        if self.metrics is not None:
            # the cross-host IO tier, timed on its own
            self.metrics.log(
                "relay_io", round=self._round_idx,
                host=self.heartbeat.host,
                seconds=round(time.perf_counter() - xt0, 4),
                bytes=int(sum(x.nbytes for x in payload)),
                mono=self.heartbeat.clock.monotonic())
        with torch.no_grad():
            at = 0
            for lv in leaves:
                for x in lv:
                    x.copy_(torch.as_tensor(
                        np.asarray(consensus[at]), dtype=x.dtype))
                    at += 1
            # unit 0's views took the consensus: every unit takes it
            self._adopt({n: [p.detach().clone() for p in ps]
                         for n, ps in self.params.items()})
            if self.average_history:
                self._adopt_history({n: [[h.clone() for h in hs]
                                         for hs in hss]
                                     for n, hss in self.history.items()})
        tm = getattr(self._relay, "timing", {})
        digest = hashlib.sha256(b"".join(
            np.ascontiguousarray(c).tobytes() for c in consensus))
        self.log(f"relay: round {self._round_idx} consensus of hosts "
                 f"{[int(h) for h in np.nonzero(aux['valid'])[0]]}, "
                 f"sha256 {digest.hexdigest()[:16]}"
                 + ("; post {:.2f} ms, mask {:.2f} ms, average {:.2f} ms"
                    .format(1e3 * tm["post_s"], 1e3 * tm["mask_s"],
                            1e3 * tm["average_s"]) if tm else ""))
        wl = np.asarray(aux["worker_loss"], np.float64)
        vv = np.asarray(aux["valid"], np.float64) > 0
        round_loss = float(np.nanmean(wl[vv])) if vv.any() else local_loss
        host_s = time.perf_counter() - t0
        self._obs_step(host_s, round_loss, fed, steps=self.tau)
        out = self._chaos_loss(torch.tensor(round_loss,
                                            dtype=torch.float32))
        self._observe_sync_round(
            dict(aux, kind="params"),
            round_s=time.perf_counter() - t0, round_idx=self._round_idx)
        self._round_idx += 1
        return out

    def _heartbeat_gate(self, timeout=None):
        """The no-hang contract: arrive at this round's rendezvous and
        wait until every live peer host arrived or its lease expired.
        Lease-dead hosts are evicted at host granularity (nothing is
        rebuilt: the alive mask is an input). QuorumLost propagates to
        run(), which drives the coordinated restart. The async mode
        passes ``timeout=0``: arrival is announced and lease-expired
        peers are evicted, but the round never waits for stragglers."""
        from ..resilience.elastic import QuorumLost
        hb = self.heartbeat
        if self._grow_pending:
            # late joiner (--grow): fast-forward to the running world's
            # front before the first gate — incumbents' gates accept any
            # arrival at round >= theirs
            self._grow_pending = False
            front = hb.peer_round_max()
            if front >= 0:
                self.log(f"grow: fast-forwarding from round "
                         f"{self._round_idx} to the running world's "
                         f"front (round {front + 1})")
                self._round_idx = front + 1
        if self._relay is not None and self.elastic is not None:
            # grow mid-run: a fresh out-of-world lease is a --grow
            # process asking in; admission is host-side bookkeeping
            for j in hb.poll_joiners():
                if hb.admit_host(j):
                    self.elastic.admit(j, self._round_idx, via="grow")
        if self.elastic is not None and self.elastic.n == hb.n:
            expect = set(self.elastic.live())
        else:
            expect = set(range(hb.n))
        res = hb.gate(self._round_idx, expect=expect, timeout=timeout)
        if self.health is not None:
            alive_now, ages = hb.view()
            self.health.observe_hosts(self._round_idx, alive=alive_now,
                                      lease_age_s=ages, lease_s=hb.lease_s,
                                      wait_s=res.wait_s)
        quorum_err = None
        for h in res.dead:
            if self.elastic is None or not (0 <= h < self.elastic.n):
                continue
            try:
                self.elastic.evict(h, self._round_idx, "lease_expired")
            except QuorumLost as e:
                quorum_err = e          # survivors still snapshot first
        if quorum_err is not None:
            raise quorum_err

    def shrink_to_survivors(self):
        """Drop the evicted units' storage — the path for a PERSISTENT
        eviction (ElasticPolicy shrink_after), so dead slots stop
        burning compute. The live units keep their params and history;
        membership resets to the new world (readmission is over).
        Callers size later round batches off the NEW world
        (``mesh_shape``). Returns True when the world changed."""
        if self.elastic is None:
            raise ValueError("shrink_to_survivors needs arm_elastic()")
        live = self.elastic.live()
        old = self.units
        if len(live) == old:
            return False
        idx = torch.as_tensor(live, device=self.device)
        with torch.no_grad():
            self.slot_params = {n: [P.index_select(0, idx).clone()
                                    for P in ps]
                                for n, ps in self.slot_params.items()}
            self.slot_history = {
                n: [[H.index_select(0, idx).clone() for H in hs]
                    for hs in hss]
                for n, hss in self.slot_history.items()}
        P = self.per_unit
        self.slot_generators = [self.slot_generators[u * P + d]
                                for u in live for d in range(P)]
        self.workers = len(live) * P
        if self.host_axis is not None:
            self.hosts = len(live)
            self.mesh_shape = {HOST_AXIS: self.hosts,
                               DATA_AXIS: self.per_host}
        else:
            self.mesh_shape = {DATA_AXIS: self.workers}
        self._views()
        self._comms_registered = False      # re-register with the new n
        self.elastic.reset_world(len(live))
        if self.metrics is not None:
            self.metrics.log("membership", kind="mesh_shrunk",
                             from_world=old, to_world=len(live),
                             unit=self.elastic_unit)
        self.log(f"elastic: mesh shrunk {old} -> {len(live)} "
                 f"{self.elastic_unit}s; the next round runs at the new "
                 "world size")
        return True

    def run(self, num_rounds, batch_fn, test_data_fn=None, test_every=10,
            snapshot_prefix=None, snapshot_every=0, resume=None,
            reshard="strict", sigint="stop", sighup="snapshot",
            sigterm="snapshot_stop"):
        """The reference training loop (CifarApp.scala:92-135): for each
        round, test every ``test_every`` rounds (:98), then train tau
        steps per unit. ``batch_fn(tau)`` -> batches as train_round
        takes them.

        Fault tolerance: resume="auto" restores the newest valid
        snapshot under the prefix first (a path restores that snapshot),
        and reshard="auto" also takes one stamped by another world;
        signals are polled between rounds (SIGHUP snapshots, SIGINT
        stops, SIGTERM snapshots then stops); ``snapshot_every`` N
        snapshots every N completed rounds; an armed watchdog is beaten
        with each round's loss, and an armed RecoveryPolicy rolls a bad
        round back and redoes it; an armed ElasticPolicy makes every
        round quorum-based, and QuorumLost (exit 4) ends the loop after
        a snapshot and the coordinated restart barrier. With
        shrink_after set, persistent evictions shrink the world —
        batch_fn must then size batches off ``mesh_shape``. Returns the
        last round's loss."""
        from ..resilience import checkpoint
        from ..resilience.elastic import QuorumLost
        from ..utils.signals import SignalPolicy
        prefix = snapshot_prefix or (self.param.snapshot_prefix
                                     if self.param.has("snapshot_prefix")
                                     else None)
        if resume == "auto":
            if prefix:
                checkpoint.resume_auto(self, prefix, log_fn=self.log,
                                       reshard=reshard)
            else:
                self.log("resume auto: no snapshot prefix; starting fresh")
        elif resume:
            self.restore(resume, reshard=reshard)
        loss, r = None, 0
        with SignalPolicy(sigint=sigint, sighup=sighup,
                          sigterm=sigterm) as policy:
            while r < num_rounds:
                if test_data_fn is not None and r % test_every == 0 \
                        and self.test_net is not None:
                    for k, v in self.test(test_data_fn()).items():
                        self.log(f"round {r}: test {k} = {v}")
                try:
                    loss = float(self.train_round(batch_fn(self.tau)))
                except QuorumLost:
                    # the consensus up to here is good: the writer
                    # commits it, every survivor barriers on the
                    # manifest's sha256, and all exit 4 holding it
                    if prefix:
                        self.snapshot(prefix=prefix)
                        self.coordinated_restart(prefix)
                    raise
                if self.elastic is not None and self.elastic.should_shrink():
                    self.shrink_to_survivors()
                if self.watchdog is not None:
                    self.watchdog.beat(loss)
                if self._maybe_recover(loss):
                    self.log(f"round {r}: rolled back to iter {self.iter}; "
                             "redoing the round")
                    continue
                self.log(f"round {r}: mean local loss = {loss:.6g}")
                r += 1
                if self.chaos is not None:
                    self.chaos.maybe_sigterm(r)
                action = policy.pending()
                if prefix and (action in ("snapshot", "snapshot_stop") or
                               (snapshot_every and
                                r % snapshot_every == 0)):
                    self.snapshot(prefix=prefix)
                if action in ("stop", "snapshot_stop"):
                    self.log(f"stopping on signal after round {r}")
                    break
        return loss
