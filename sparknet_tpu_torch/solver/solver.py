"""Solver: training orchestration around one eager train step.

The port of sparknet_tpu/solver/solver.py (Caffe Solver::Step,
solver.cpp:193-253) for one device: each step runs iter_size TRAIN-phase
forwards with ``backward()`` (autograd sums the micro-batch gradients
into each param's f32 ``.grad``), then the Updater changes params and
history in place. Evaluation averages the TEST net's output blobs over
test_iter batches (solver.cpp TestAndStoreResult :414-444). Snapshots
are Caffe's .caffemodel + .solverstate pair, binaryproto or (with
``snapshot_format: HDF5``) the .h5 pair of solver/hdf5_io.py, under the
crash-safe manifest of resilience/checkpoint.py, readable by the JAX
package and back.

With ``metrics`` (a utils/metrics.py MetricsLogger, or a path) it writes
the JAX Solver's events: "train" and "test" at display and test points,
the ``test`` and ``snapshot`` spans of its Tracer, and through the obs
package step accounting, comms, memory, and for the slot solvers worker
divergence and health. ``arm_watchdog``, ``arm_recovery`` and
``arm_health`` install the run-safety hooks the step loop drives;
``snapshot_keep`` is keep-N retention; ``set_remat`` the remat policy,
``set_scan`` the scan-over-layers mode.
``set_input_transform`` installs a transform that runs on the device
before the forward (the raw-record feed of data/device_transform.py).
The multi-host machinery is the JAX Solver's: ``arm_elastic`` (quorum
membership over the slot solvers' consensus), ``arm_staleness``
(bounded-staleness async rounds), ``arm_heartbeat`` (leased host
liveness, the round gate and the file relay of resilience/heartbeat.py),
``coordinated_restart`` on quorum loss, the writer election of
multi-process snapshots, ``restore(reshard="auto")``, and the chaos
injectors armed process-wide (``self.chaos``), and debug_info's
per-blob dump at display points (``_print_debug_info``).
"""

import collections
import os
import time

import numpy as np
import torch

from ..data.prefetch import wait_staged
from ..device import resolve_device
from ..graph.compiler import CompiledNet, TRAIN, TEST, array_to_blob, \
    blob_to_array
from ..graph.upgrade import solver_needs_type_upgrade, upgrade_solver
from ..proto import Message, text_format, wire
from . import hdf5_io
from .lr_policy import make_lr_fn
from .updates import Updater


def resolve_nets(sp, base_dir="", net_param=None):
    """Resolve train/test NetParameters from a SolverParameter, honoring the
    field precedence of Caffe solver.cpp InitTrainNet/InitTestNets:
    train_net_param > train_net > net_param > net."""
    def load(path):
        return text_format.load(os.path.join(base_dir, path), "NetParameter")

    train = test = None
    if net_param is not None:
        train = test = net_param
    elif sp.has("train_net_param"):
        train = sp.train_net_param
    elif sp.has("train_net"):
        train = load(sp.train_net)
    elif sp.has("net_param"):
        train = test = sp.net_param
    elif sp.has("net"):
        train = test = load(sp.net)
    if train is None:
        raise ValueError("solver specifies no train net")
    if sp.test_net_param:
        test = sp.test_net_param[0]
    elif sp.test_net:
        test = load(sp.test_net[0])
    return train, test


def clear_grads(params):
    for blobs in params.values():
        for p in blobs:
            p.grad = None


def grads_of(params):
    """{layer: [each param's accumulated .grad, zeros where it has
    none]}: the gradients an Updater takes."""
    return {name: [p.grad if p.grad is not None else torch.zeros_like(p)
                   for p in blobs]
            for name, blobs in params.items()}


def to_device(batch, device):
    """{blob: array or tensor} -> {blob: tensor on ``device``}."""
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                               else v, device=device)
            for k, v in batch.items()}


def sp_test_scheduled(sp):
    """Does the solver schedule testing (test_iter/test_interval set)?"""
    return bool(sp.test_iter) or int(sp.test_interval) > 0


class Solver:
    """Drives training of one net on one device per the SolverParameter
    schedule. Data iterators yield batch dicts {blob_name: array}; see
    CompiledNet.feed_blobs() for the keys. ``device`` defaults to the
    card and raises when there is none; pass ``device="cpu"`` to train
    on the CPU (the kernels' plain versions). On the card it trains in
    float32 (resolve_device turns TF32 off) unless ``compute_dtype``
    (torch.bfloat16) asks for mixed precision: f32 master params, bf16
    activations from the embedding on."""

    def __init__(self, solver_param, net_param=None, feed_shapes=None,
                 test_feed_shapes=None, base_dir="", device="cuda",
                 log_fn=print, metrics=None, compute_dtype=None,
                 tracer=None):
        if solver_needs_type_upgrade(solver_param):
            solver_param = upgrade_solver(solver_param)
        self.param = solver_param
        self.log = log_fn or (lambda *a: None)
        self.device = resolve_device(device)
        # observability (sparknet_tpu_torch.obs): a JSONL MetricsLogger
        # (or its path, then owned and closed by close()), a span Tracer
        # over it, and with metrics on the step, comms, divergence,
        # health and memory meters
        self._own_metrics = isinstance(metrics, str)
        if self._own_metrics:
            from ..utils.metrics import MetricsLogger
            metrics = MetricsLogger(metrics)
        self.metrics = metrics
        from ..obs import Tracer
        self.tracer = tracer if tracer is not None else Tracer(self.metrics)
        self.stepstats = self.comms = None
        self._comms_registered = False
        self.divergence = self.health = self.memstats = None
        self.last_divergence = None
        if self.metrics is not None:
            from ..obs import (CommsMeter, DivergenceMeter, HealthMonitor,
                               MemoryMonitor, StepAccounting)
            self.stepstats = StepAccounting(self.metrics)
            self.comms = CommsMeter(self.metrics)
            self.divergence = DivergenceMeter(self.metrics)
            self.health = HealthMonitor(self.metrics, log_fn=self.log,
                                        solver=self)
            self.memstats = MemoryMonitor(self.metrics, device=self.device)
        # run safety: the watchdog step() beats, keep-N snapshot
        # retention (None: keep all) and the divergence RecoveryPolicy
        self.watchdog = None
        self.snapshot_keep = None
        self.recovery = None
        # multi-host resilience (sparknet_tpu_torch.resilience): the
        # elastic membership controller (arm_elastic), the bounded-
        # staleness bound and decay (arm_staleness; None = synchronous),
        # host-level fault domains (arm_heartbeat) and the process-wide
        # chaos injector (None unless --chaos / SPARKNET_CHAOS armed one)
        self.elastic = None
        self.staleness = None
        self.s_decay = 0.5
        self.heartbeat = None
        self._reshard_plan = None
        from ..resilience.chaos import active_chaos
        self.chaos = active_chaos()
        train_np, test_np = resolve_nets(solver_param, base_dir, net_param)
        # NetState from the solver (Caffe solver.cpp InitTrainNet /
        # InitTestNets): train_state / test_state[0] join the filter state
        ts = solver_param.train_state \
            if solver_param.has("train_state") else None
        self.net = CompiledNet(train_np, TRAIN, feed_shapes=feed_shapes,
                               level=int(ts.level) if ts else 0,
                               stages=tuple(ts.stage) if ts else (),
                               device=self.device,
                               compute_dtype=compute_dtype)
        self.test_net = None
        if test_np is not None:
            es = solver_param.test_state[0] \
                if solver_param.test_state else None
            try:
                self.test_net = CompiledNet(
                    test_np, TEST,
                    feed_shapes=test_feed_shapes or feed_shapes,
                    level=int(es.level) if es else 0,
                    stages=tuple(es.stage) if es else (),
                    device=self.device, compute_dtype=compute_dtype)
            except ValueError:
                # a shared `net` whose data layer is TRAIN-only has no
                # TEST-phase graph; without a test schedule Caffe never
                # instantiates test nets (solver.cpp InitTestNets)
                if sp_test_scheduled(solver_param):
                    raise
                self.log("No TEST-phase net; training without a test net")

        seed = int(solver_param.random_seed)
        if seed < 0:
            seed = time.time_ns() % (2 ** 31)
        self.params, self.state = self.net.init(
            torch.Generator().manual_seed(seed))
        # one CPU generator drives every step's per-layer randomness
        self.generator = torch.Generator().manual_seed(seed + 1)
        self._arm_grads()
        mults = {}
        for lname, refs in self.net.param_refs.items():
            owned = [k for k in refs if k[0] == lname]
            if owned:
                mults[lname] = [
                    (self.net.param_meta[k][2], self.net.param_meta[k][3])
                    for k in owned]
        self.updater = Updater(solver_param, mults)
        self.history = self.updater.init(self.params)
        self.lr_fn = make_lr_fn(solver_param)
        self.iter = 0
        self._smoothed = collections.deque(
            maxlen=max(1, int(solver_param.average_loss)))
        self.input_transform = None
        self.test_input_transform = None
        self._raw_feed_shapes = None
        # a loss reaches the host at display points, and every
        # _sync_stride steps when display is off (the JAX solver's
        # cadence): the watchdog and recovery see losses no more often
        self._sync_stride = max(1, int(os.environ.get(
            "SPARKNET_SYNC_STRIDE", "100")))

    def _arm_grads(self):
        for blobs in self.params.values():
            for p in blobs:
                p.requires_grad_(True)

    def smoothed_loss(self):
        """Mean of the average_loss-window losses (one device fetch), or
        None before any step: the value the display line prints."""
        if not self._smoothed:
            return None
        return float(torch.stack(list(self._smoothed)).mean())

    # -- knobs and run safety ----------------------------------------------
    def set_remat(self, policy):
        """Set the remat policy (the --remat knob) on every net this
        solver owns: "none", "dots" (save matmul and convolution outputs,
        recompute the rest) or "full". Overrides SPARKNET_REMAT."""
        from ..graph.compiler import REMAT_POLICIES
        if policy not in REMAT_POLICIES:
            raise ValueError(
                f"remat policy {policy!r}: want one of {REMAT_POLICIES}")
        self._set_net_knob("remat", policy)

    def set_scan(self, mode):
        """Set the scan-over-layers mode (the --scan knob) on every net
        this solver owns: "auto" (a TPU-only scan in the JAX package, so
        off here), "on" or "off". Overrides SPARKNET_SCAN."""
        if mode not in ("auto", "on", "off"):
            raise ValueError(f"scan mode {mode!r}: want auto|on|off")
        self._set_net_knob("scan", mode)

    def _set_net_knob(self, attr, value):
        for name in ("net", "test_net", "local_net", "local_test_net"):
            n = getattr(self, name, None)
            if n is not None:
                setattr(n, attr, value)

    def scale_lr(self, factor):
        """Scale the lr schedule by ``factor`` from now on."""
        base, factor = self.lr_fn, float(factor)
        self.lr_fn = lambda it: base(it) * factor

    def training_tensors(self):
        """Every tensor that defines where training stands (params, net
        state, optimizer history), in a fixed order: what a
        RecoveryPolicy copies and rolls back in place."""
        out = [p for blobs in self.params.values() for p in blobs]
        out += [t for blobs in self.state.values() for t in blobs]
        out += [h for hss in self.history.values() for hs in hss
                for h in hs]
        return out

    def rng_state(self):
        return [self.generator.get_state()]

    def set_rng_state(self, states):
        self.generator.set_state(states[0])

    def arm_watchdog(self, stall_seconds=300.0, **kw):
        """Start a stall/NaN watchdog that step() beats each iteration.
        With kill_on_stall and a snapshot prefix, the exit path takes an
        emergency snapshot first."""
        from ..utils.watchdog import Watchdog
        kw.setdefault("metrics", self.metrics)
        if kw.get("kill_on_stall") and "emergency_snapshot" not in kw \
                and self.param.has("snapshot_prefix"):
            kw["emergency_snapshot"] = self.snapshot
        self.watchdog = Watchdog(stall_seconds=stall_seconds, **kw).start()
        return self.watchdog

    def arm_recovery(self, policy=None, **kw):
        """Install a divergence RecoveryPolicy (NaN or exploding loss ->
        rollback to the last known-good state). The state at arm time is
        the first known-good point."""
        if policy is None:
            from ..resilience.recovery import RecoveryPolicy
            kw.setdefault("metrics", self.metrics)
            kw.setdefault("log_fn", self.log)
            policy = RecoveryPolicy(**kw)
        self.recovery = policy
        policy.note_good(self)
        return policy

    # -- multi-host resilience (resilience/elastic.py, heartbeat.py) -------
    def _membership_size(self):
        """The count of membership units of this solver's consensus:
        1 for the single-device solver (overridden by the slot
        solvers)."""
        return 1

    def arm_elastic(self, policy=None, **kw):
        """Install an elastic membership controller (resilience/
        elastic.py): the sync consensus becomes a validity-masked quorum
        average, sick workers (hosts, in two-tier mode) are evicted and
        readmitted, and dropping below ``quorum`` raises QuorumLost
        (exit 4). With the heartbeat relay armed the world spans the
        processes rather than the local slots."""
        n = self._membership_size()
        if getattr(self, "_relay", None) is not None:
            n = self.heartbeat.n
        if policy is None:
            from ..resilience.elastic import ElasticPolicy
            kw.setdefault("metrics", self.metrics)
            kw.setdefault("log_fn", self.log)
            kw.setdefault("chaos", self.chaos)
            kw.setdefault("unit", getattr(self, "elastic_unit", "worker"))
            kw.setdefault("staleness", self.staleness)
            kw.setdefault("s_decay", self.s_decay)
            policy = ElasticPolicy(n_workers=n, **kw)
        self.elastic = policy
        return policy

    def arm_staleness(self, s, decay=0.5, unpark_after=1,
                      evict_parked_after=0):
        """Arm the asynchronous bounded-staleness mode (``--staleness``
        next to ``--tau``): the consensus becomes a staleness-weighted
        average — a worker ``lag`` rounds behind the fastest live peer
        is discounted by ``decay ** lag``, parked once ``lag > s``,
        resynced after ``unpark_after`` rounds and evicted after
        ``evict_parked_after`` chronic parks (0 = never). s=0 is bit for
        bit the synchronous masked round. Arms elastic membership (quorum
        1) when none is armed; a synchronous file relay is upgraded in
        place to the async one."""
        self.staleness = max(0, int(s))
        self.s_decay = float(decay)
        if self.elastic is None:
            self.arm_elastic(quorum=1, unpark_after=unpark_after,
                             evict_parked_after=evict_parked_after)
        else:
            el = self.elastic
            el.staleness = self.staleness
            el.s_decay = self.s_decay
            el.unpark_after = max(1, int(unpark_after))
            el.evict_parked_after = max(0, int(evict_parked_after))
        if getattr(self, "_relay", None) is not None:
            from ..resilience.heartbeat import (AsyncFileConsensus,
                                                FileConsensus)
            if type(self._relay) is FileConsensus:
                self._relay = AsyncFileConsensus(
                    self._relay.coord, s=self.staleness,
                    decay=self.s_decay)
                self.log("staleness: upgraded the cross-host relay to "
                         "the versioned barrier-free delta exchange")
            elif isinstance(self._relay, AsyncFileConsensus):
                self._relay.s = self.staleness
                self._relay.decay = self.s_decay
        self.log(f"staleness: async bounded-staleness armed (s="
                 f"{self.staleness}, decay={self.s_decay})")
        return self.elastic

    def arm_heartbeat(self, directory, interval_s=0.5, lease_s=3.0,
                      relay="auto", grow=False, **kw):
        """Arm host-level fault domains (resilience/heartbeat.py): this
        process leases its liveness into ``directory`` (storage every
        host reaches), a monitor thread marks peer hosts dead on lease
        expiry, and the slot solvers gate every cross-host round on the
        rendezvous, so a dead peer costs an eviction, never a hang.

        relay: "auto" routes the tau-interval cross-host average through
        the directory (heartbeat.FileConsensus) whenever more than one
        process runs (parallel.multihost.needs_host_relay); True/False
        force it. Arm BEFORE arm_elastic, so the membership world sizes
        to the process count.

        grow: this is a LATE JOINER (``--grow``): a standalone process
        that scans the fresh leases, takes host id max(existing) + 1,
        forces the relay on, and fast-forwards its round counter to the
        running world's front at its first gate; the incumbents' gates
        see the new lease and admit it, with nothing rebuilt."""
        from ..parallel.multihost import (needs_host_relay, process_count,
                                          process_index)
        from ..resilience.heartbeat import (FileConsensus,
                                            HeartbeatCoordinator,
                                            fresh_leases)
        host = process_index()
        n = process_count()
        self._grow_pending = False
        if grow:
            if n > 1:
                self.log("heartbeat: WARNING — --grow ignored inside a "
                         f"{n}-process world (its membership is fixed at "
                         "launch); launch the joiner as a standalone "
                         "single process")
            else:
                existing = fresh_leases(directory, lease_s)
                if existing:
                    host = max(existing) + 1
                    n = host + 1
                    relay = True if relay == "auto" else relay
                    self._grow_pending = True
                    self.log(f"heartbeat: joining a running world of "
                             f"{len(existing)} host(s) "
                             f"{sorted(existing)} as host {host}")
                else:
                    self.log("heartbeat: --grow found no fresh leases "
                             f"under {directory}; starting a new world")
        kw.setdefault("metrics", self.metrics)
        kw.setdefault("log_fn", self.log)
        kw.setdefault("chaos", self.chaos)
        coord = HeartbeatCoordinator(directory, host=host, n_hosts=n,
                                     interval_s=interval_s,
                                     lease_s=lease_s, **kw).start()
        self.heartbeat = coord
        if relay == "auto":
            relay = needs_host_relay()
        if relay and hasattr(self, "_train_round_relay"):
            if self.staleness is not None:
                from ..resilience.heartbeat import AsyncFileConsensus
                self._relay = AsyncFileConsensus(coord, s=self.staleness,
                                                 decay=self.s_decay)
                self.log(f"heartbeat: ASYNC relay consensus armed ({n} "
                         "hosts, versioned barrier-free delta exchange)")
            else:
                self._relay = FileConsensus(coord)
                self.log(f"heartbeat: relay consensus armed ({n} hosts "
                         "through the rendezvous directory)")
        if self.elastic is not None and self.elastic.n != n and \
                getattr(self, "_relay", None) is not None:
            self.log(f"heartbeat: WARNING — elastic world {self.elastic.n}"
                     f" != {n} processes; arm_heartbeat before "
                     "arm_elastic in relay mode")
        return coord

    def coordinated_restart(self, prefix, timeout=30.0):
        """Quorum loss in a multi-host world: barrier with every
        surviving process on the sha256 of the snapshot manifest under
        ``prefix`` before exiting 4, so a supervisor restart resumes ONE
        consistent world (resilience/heartbeat.restart_barrier). A
        heartbeat-less run, or a world of one process and one host: a
        no-op True."""
        from ..parallel.multihost import process_count
        if self.heartbeat is None or \
                (process_count() <= 1 and self.heartbeat.n <= 1):
            return True
        from ..resilience.heartbeat import manifest_sha, restart_barrier
        sha = manifest_sha(prefix)
        t0 = time.perf_counter()
        agreed, _ = restart_barrier(self.heartbeat, sha, timeout=timeout)
        self.log(f"coordinated restart: barrier {time.perf_counter() - t0:.3f}"
                 f" s, agreed {agreed}")
        return agreed

    def _alive_mask(self):
        """The (n,) f32 alive mask the round consumes, on the solver's
        device: all ones without elastic membership (the masked average
        is then bit for bit the plain mean). Under the relay the policy
        world spans PROCESSES, so the local round sees all ones and
        membership is applied at the exchange."""
        n = self._membership_size()
        if self.elastic is not None and self.elastic.n == n:
            return torch.as_tensor(self.elastic.alive_f32(),
                                   device=self.device)
        return torch.ones(n, device=self.device)

    def _staleness_lag(self):
        """The (n,) f32 per-unit version lag next to the alive mask: all
        zeros while the async mode is off (the staleness weights are
        then exactly 1.0) or when the policy world spans processes."""
        n = self._membership_size()
        if self.staleness is not None and self.elastic is not None \
                and self.elastic.n == n:
            return torch.as_tensor(np.asarray(self.elastic.lag(),
                                              np.float32),
                                   device=self.device)
        return torch.zeros(n, device=self.device)

    def _observe_membership(self, aux, round_idx=None):
        """Feed the elastic membership controller one round's fetched
        validity and loss vectors. QuorumLost propagates (the run must
        stop); nothing else may end training."""
        if self.elastic is None or not aux:
            return
        from ..resilience.elastic import QuorumLost
        try:
            self.elastic.observe_round(
                round_idx if round_idx is not None else self.iter - 1,
                valid=aux.get("valid"),
                worker_loss=aux.get("worker_loss"))
        except QuorumLost:
            raise
        except Exception as e:
            self.log(f"elastic membership observation failed: {e!r}")

    def _chaos_loss(self, loss):
        """Apply the armed per-step chaos injectors (stall, loss
        poisoning) to the step that just ran; no-op when chaos is off."""
        if self.chaos is None:
            return loss
        self.chaos.maybe_stall(self.iter - 1)
        if self.chaos.poison_loss(self.iter - 1):
            return torch.tensor(float("nan"), device=self.device)
        return loss

    def arm_health(self, **kw):
        """(Re)configure the health detectors (the --health-* flags),
        keeping the metrics sink; enabled=False disarms them."""
        if not kw.pop("enabled", True):
            self.health = None
            return None
        from ..obs import HealthMonitor
        kw.setdefault("log_fn", self.log)
        self.health = HealthMonitor(self.metrics, solver=self, **kw)
        return self.health

    def _maybe_recover(self, loss):
        """Feed a host loss to the recovery policy; True when the solver
        was rolled back (the caller redoes the work)."""
        if self.recovery is None or loss is None:
            return False
        return self.recovery.observe(self, float(loss))

    # -- observability (sparknet_tpu_torch.obs) ----------------------------
    def _register_comms(self, cm):
        """Declare this solver's collective volume with the CommsMeter:
        the single-device solver only has its host-to-device feed."""
        from ..obs.comms import tree_bytes
        cm.set_topology(strategy=type(self).__name__,
                        n_devices=torch.cuda.device_count()
                        if self.device.type == "cuda" else 1,
                        param_bytes=tree_bytes(self.params))

    def _obs_begin(self, steps=1):
        """Before a step (or a round of ``steps`` iterations): the step
        accounting's start event."""
        if self.stepstats is not None:
            self.stepstats.begin(self.iter + steps - 1, self.device)

    def _obs_sampled_next(self):
        """Will the coming step be sampled (so its sync-round aux is
        worth computing)?"""
        return self.stepstats is not None and \
            self.stepstats.will_sample(self.iter)

    def _obs_step(self, host_s, result, batch, aux=None, steps=1):
        """After each step (or round of ``steps`` iterations): feed
        bytes, comms, step accounting, and on sampled steps memory and
        the sync round's aux. One attribute test when metrics is off."""
        if self.stepstats is None:
            return
        from ..obs.comms import tree_bytes
        if not self._comms_registered:
            self._comms_registered = True
            try:
                self._register_comms(self.comms)
            except Exception as e:      # accounting must never end a run
                self.log(f"comms registration failed: {e!r}")
        it = self.iter - 1
        self.comms.add_h2d(tree_bytes(batch))
        self.comms.tick(it)
        if self.stepstats.observe(it, host_s, result=result, steps=steps):
            if self.memstats is not None:
                try:
                    self.memstats.sample(it)
                except Exception as e:
                    self.log(f"memstats sampling failed: {e!r}")
            if aux:
                self._observe_sync_round(aux)

    def _round_latencies(self, round_s):
        """Per-worker latencies of the finished round, or None (one
        worker)."""
        return None

    def _observe_sync_round(self, aux, round_s=None, round_idx=None):
        """Fetch one sync round's aux (a few scalars from the card), feed
        the elastic membership controller, emit the ``divergence`` event
        and feed the health detectors. Only QuorumLost escapes."""
        if not aux:
            return None
        from ..obs.divergence import to_host
        try:
            aux = to_host(aux)
        except Exception as e:          # monitoring must never end a run
            self.log(f"sync-round aux fetch failed: {e!r}")
            return None
        # membership first: eviction (and the QuorumLost abort) must not
        # depend on the metrics stream; the detectors judge the round
        # against the membership in force while it ran
        alive_during_round = self.elastic.alive.copy() \
            if self.elastic is not None else None
        if not aux.get("membership_seen"):
            self._observe_membership(aux, round_idx)
        if self.divergence is None:
            return None
        try:
            d = self.divergence.observe(
                self.iter - 1, aux, kind=aux.get("kind", "params"),
                tau=getattr(self, "tau", None), round_idx=round_idx)
            self.last_divergence = d
            if self.health is not None:
                self.health.observe_round(
                    self.iter - 1, round_idx=round_idx,
                    worker_losses=aux.get("worker_loss"),
                    latencies=self._round_latencies(round_s)
                    if round_s is not None else None,
                    divergence=d, valid=aux.get("valid"),
                    alive=alive_during_round, lag=aux.get("lag"),
                    parked=aux.get("parked"), staleness=self.staleness)
            return d
        except Exception as e:          # monitoring must never end a run
            self.log(f"divergence observation failed: {e!r}")
            return None

    def close(self):
        """Stop the watchdog thread, write the health, step and comms
        summaries, and close a metrics stream this solver opened.
        Idempotent; training cannot go on with metrics afterwards."""
        if self.watchdog is not None:
            self.watchdog.stop()
            self.watchdog = None
        if self.heartbeat is not None:
            try:
                self.heartbeat.stop()   # the leaser thread must not
            finally:                    # outlive the run
                self.heartbeat = None
                if getattr(self, "_relay", None) is not None:
                    self._relay = None
        if self.health is not None:
            try:
                if self.health.alarms and self.metrics is not None:
                    self.metrics.log("health_summary",
                                     **self.health.summary())
            finally:
                self.health = None
        if self.elastic is not None:
            try:
                if self.metrics is not None and \
                        (self.elastic.evictions or
                         self.elastic.readmissions):
                    self.metrics.log("membership", kind="summary",
                                     **self.elastic.summary())
            finally:
                self.elastic = None
        self.divergence = self.memstats = None
        if self.stepstats is not None:
            try:
                self.stepstats.flush(self.iter)
            finally:
                self.stepstats = None
        if self.comms is not None:
            try:
                self.comms.flush(self.iter - 1)
            finally:
                self.comms = None
        if self._own_metrics and self.metrics is not None:
            self.metrics.close()
            self.metrics = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- public API --------------------------------------------------------
    def set_input_transform(self, fn, raw_overrides=None, test_fn=None):
        """Install transforms that run on the device before the forward.
        fn/test_fn: fn(batch dict of tensors on the device) -> the net's
        feed dict, for training and for testing; raw_overrides: {blob:
        raw shape} check_batch overrides for the pre-transform feed (the
        uint8 source extent and the '#y'/'#x'/'#flip' aux arrays; None
        for a blob the transform makes itself)."""
        self.input_transform = fn
        self.test_input_transform = test_fn
        self._raw_feed_shapes = dict(raw_overrides) if raw_overrides \
            else None

    def input_shapes(self):
        """{blob: shape} a training batch carries: the train net's feed
        shapes, with the raw feed's in their place under an input
        transform."""
        shapes = dict(self.net.feed_shapes())
        if self._raw_feed_shapes:
            shapes.update(self._raw_feed_shapes)
        # None: a blob the transform makes on the device (the device
        # cache's data and labels), not host-fed
        return {k: v for k, v in shapes.items() if v is not None}

    def _transform(self, batch, fn, iter_size=1):
        """``batch`` through ``fn`` on the device (each micro-batch of a
        leading iter_size axis apart); as it is without ``fn``."""
        if fn is None:
            return batch
        batch = to_device(batch, self.device)
        if iter_size == 1:
            return fn(batch)
        micros = [fn({k: v[i] for k, v in batch.items()})
                  for i in range(iter_size)]
        return {k: torch.stack([m[k] for m in micros]) for k in micros[0]}

    def check_batch(self, batch, leading=(), shapes=None):
        """Fail fast with blob names when a feed array has the wrong shape
        (otherwise the error is a cryptic reshape deep inside a layer).
        ``shapes`` defaults to input_shapes()."""
        shapes = self.input_shapes() if shapes is None else shapes
        for name, want in shapes.items():
            if name not in batch:
                raise ValueError(f"batch missing feed blob {name!r} "
                                 f"(needs {sorted(shapes)})")
            got = tuple(np.shape(batch[name]))
            expect = tuple(leading) + tuple(want)
            if got != expect:
                raise ValueError(f"feed blob {name!r}: got shape {got}, net "
                                 f"was compiled for {expect}")

    def train_step(self, batch):
        """One optimization step; returns the (unsmoothed) loss as a 0-d
        tensor on the device. With iter_size > 1 the batch arrays carry
        a leading micro-batch axis."""
        iter_size = int(self.param.iter_size)
        self.check_batch(batch, leading=(iter_size,) if iter_size > 1
                         else ())
        fed = batch
        self._obs_begin()
        t0 = time.perf_counter()
        batch = self._transform(wait_staged(batch), self.input_transform,
                                iter_size)
        clear_grads(self.params)
        micros = [batch] if iter_size == 1 else \
            [{k: v[i] for k, v in batch.items()} for i in range(iter_size)]
        losses = []
        for micro in micros:
            loss, (_, self.state) = self.net.loss_fn(
                self.params, self.state, micro, self.generator)
            loss.backward()
            losses.append(loss.detach())
        loss = losses[0] if iter_size == 1 else torch.stack(losses).mean()
        self.updater(self.params, grads_of(self.params), self.history,
                     self.lr_fn(self.iter), self.iter)
        self.iter += 1
        self._obs_step(time.perf_counter() - t0, loss, fed)
        return self._chaos_loss(loss)

    def step(self, num_iters, data_iter, test_data_fn=None):
        """Run ``num_iters`` steps: pull batches from ``data_iter``,
        display the smoothed loss, run scheduled tests (test_data_fn() ->
        a fresh test batch iterator) and snapshot on the cadence. A loss
        reaches the host at display points (the smoothed one) and every
        _sync_stride steps between them: there the watchdog gets it and
        an armed RecoveryPolicy may roll the solver back, after which
        the loop goes on from the restored iteration."""
        sp = self.param
        iter_size = int(sp.iter_size)
        t_last, it_last = time.time(), self.iter
        for _ in range(num_iters):
            if sp.test_interval and self.iter % sp.test_interval == 0 and \
                    (self.iter > 0 or sp.test_initialization) and \
                    self.test_net is not None and test_data_fn is not None:
                scores = self.test(test_data_fn())
                for k, v in scores.items():
                    self.log(f"    Test net output: {k} = {v}")
                if self.metrics:
                    self.metrics.log("test", iter=self.iter,
                                     **{k: float(np.mean(v))
                                        for k, v in scores.items()})
                t_last, it_last = time.time(), self.iter
            if iter_size == 1:
                batch = next(data_iter)
            else:
                micros = [next(data_iter) for _ in range(iter_size)]
                batch = {k: np.stack([m[k] for m in micros])
                         for k in micros[0]}
            # debug_info dumps run on the pre-update params (the state
            # that produces this iteration's loss), like the reference's
            # mid-step prints
            if int(sp.debug_info) and sp.display \
                    and self.iter % sp.display == 0:
                micro = batch if iter_size == 1 \
                    else {k: v[0] for k, v in batch.items()}
                self._print_debug_info(micro)
            loss = self.train_step(batch)
            self._smoothed.append(loss)
            disp = sp.display and (self.iter - 1) % sp.display == 0
            if not disp:
                if self.iter % self._sync_stride == 0:
                    v = float(loss)
                    if self.watchdog is not None:
                        self.watchdog.beat(v)
                    if self._maybe_recover(v):
                        t_last, it_last = time.time(), self.iter
                        continue        # rolled back; redo from there
                elif self.watchdog is not None:
                    self.watchdog.beat()
            else:
                sm = self.smoothed_loss()
                if self.watchdog is not None:
                    self.watchdog.beat(sm)
                if self._maybe_recover(sm):
                    # the iteration counter went back: restart the
                    # throughput window too
                    t_last, it_last = time.time(), self.iter
                    continue
                lr = self.lr_fn(self.iter - 1)
                self.log(f"Iteration {self.iter - 1}, loss = {sm:.6g}, "
                         f"lr = {lr:.6g}")
                if self.metrics:
                    dt = time.time() - t_last
                    bsz = next(iter(self.net.feed_shapes().values()), (0,))
                    self.metrics.log(
                        "train", iter=self.iter - 1, loss=sm, lr=lr,
                        images_per_sec=round((self.iter - it_last)
                                             * iter_size * bsz[0] / dt, 2)
                        if dt > 0 and bsz else None)
                    t_last, it_last = time.time(), self.iter
            if sp.snapshot and self.iter % sp.snapshot == 0 and \
                    sp.has("snapshot_prefix"):
                self.snapshot()

    def _print_debug_info(self, batch):
        """SolverParameter.debug_info: the per-blob and per-param mean |x|
        dump in the reference's format (net.cpp ForwardDebugInfo :658 and
        the param diffs of BackwardDebugInfo), the JAX Solver's. It runs
        at display points only, before the displayed iteration's update,
        so the data and diff norms describe the params that produced the
        displayed loss; one forward and backward on copies of the params,
        with a copy of the solver's generator (the step's draws, and the
        step's generator untouched). Labels carry the layer's param slot
        (shared or owned), as the reference prints them."""
        from ..parallel.multihost import process_count
        if process_count() > 1:
            if not getattr(self, "_dbg_warned", False):
                self._dbg_warned = True
                self.log("debug_info dump is single-process only; "
                         "skipping (per-host batch slices cannot feed "
                         "the global-shape debug pass)")
            return
        net = self.net
        batch = self._transform(wait_staged(batch), self.input_transform)
        ps = {k: [p.detach().clone().requires_grad_(True) for p in v]
              for k, v in self.params.items()}
        gen = torch.Generator()
        gen.set_state(self.generator.get_state())
        loss, (blobs, _) = net.loss_fn(ps, self.state, batch, gen)
        loss.backward()

        def mabs(x):
            if x is None:
                return 0.0
            return float(x.detach().float().abs().mean())
        for lp, _, _, tops in net.layers:
            for t in tops:
                v = mabs(blobs[t]) if t in blobs else 0.0
                self.log(f"    [Forward] Layer {lp.name}, top blob {t} "
                         f"data: {v:.6g}")
        slots = []              # (layer, slot, owner, owner's position)
        for lp, _, _, _ in net.layers:
            for slot, key in enumerate(net.param_refs[lp.name]):
                owner = key[0]
                owned = [k for k in net.param_refs.get(owner, [])
                         if k[0] == owner]
                if key in owned:
                    slots.append((lp.name, slot, owner, owned.index(key)))
        for lname, slot, owner, pos in slots:
            self.log(f"    [Forward] Layer {lname}, param blob {slot} "
                     f"data: {mabs(ps[owner][pos]):.6g}")
        for lname, slot, owner, pos in slots:
            self.log(f"    [Backward] Layer {lname}, param blob {slot} "
                     f"diff: {mabs(ps[owner][pos].grad):.6g}")

    def test(self, data_iter, num_iters=None):
        """Average the TEST net's output blobs over test_iter batches
        (Caffe solver.cpp TestAndStoreResult :414-444)."""
        with self.tracer.span("test", iter=self.iter):
            return self._test(data_iter, num_iters)

    def _test(self, data_iter, num_iters=None):
        if self.test_net is None:
            raise ValueError("this solver has no TEST-phase net")
        n = num_iters or (int(self.param.test_iter[0])
                          if self.param.test_iter else 1)
        sums = None
        try:
            with torch.inference_mode():
                for _ in range(n):
                    out = self._test_outputs(self._transform(
                        wait_staged(next(data_iter)),
                        self.test_input_transform))
                    sums = out if sums is None else \
                        {k: sums[k] + out[k] for k in sums}
        finally:
            if hasattr(data_iter, "close"):
                data_iter.close()
        return {k: v.cpu().numpy().astype(np.float64) / n
                for k, v in sums.items()}

    def _test_outputs(self, batch):
        """{output blob: f32 tensor} of the TEST net on one batch."""
        blobs, _ = self.test_net.apply(self.params, self.state, batch,
                                       train=False)
        return {b: blobs[b].float() for b in self.test_net.output_blobs}

    # -- checkpointing (Caffe solver.cpp Snapshot :447-521) ----------------
    def snapshot(self, prefix=None):
        """Write weights + solver state through the crash-safe manifest,
        in the SolverParameter's snapshot_format (BINARYPROTO, the
        default, or HDF5); returns (model_path, state_path). In a
        multi-process world only the designated writer commits; the
        others barrier on the manifest it wrote."""
        from ..resilience import checkpoint
        prefix = prefix or self.param.snapshot_prefix
        if not self._snapshot_writer():
            entry = checkpoint.wait_for_manifest(prefix, min_iter=self.iter)
            if entry is None:
                self.log(f"snapshot: writer never committed iter "
                         f"{self.iter} under {prefix!r} (timed out); "
                         "continuing without a local copy")
                return None, None
            d = os.path.dirname(prefix)
            self.log(f"snapshot: committed by the writer process "
                     f"(iter {entry.get('iter')})")
            return (os.path.join(d, entry.get("model", "")),
                    os.path.join(d, entry.get("state", "")))
        with self.tracer.span("snapshot", iter=self.iter):
            model_path, state_path = checkpoint.save_snapshot(
                self, prefix, keep=self.snapshot_keep,
                metrics=self.metrics)
        self.log(f"Snapshotting to {model_path}")
        return model_path, state_path

    def _snapshot_writer(self):
        """Which process commits snapshots in a multi-process world: the
        lowest-indexed LIVE host (process 0 while healthy). Params, state
        and history are replicated after a round, so N processes writing
        the same files would race each other's renames."""
        from ..parallel.multihost import process_count, process_index
        if process_count() <= 1:
            return True
        me = process_index()
        hb = self.heartbeat
        if hb is not None:
            try:
                return me == min(hb.live_processes() + [me])
            except Exception:
                pass
        return me == 0

    def _snapshot_paths(self, prefix=None):
        """-> (model_path, state_path, format) for a snapshot at the
        current iter (Caffe Snapshot naming, solver.cpp:466-470)."""
        prefix = prefix or self.param.snapshot_prefix
        format = "hdf5" if int(self.param.snapshot_format) == 0 \
            else "binaryproto"
        ext = ".h5" if format == "hdf5" else ""
        return (f"{prefix}_iter_{self.iter}.caffemodel{ext}",
                f"{prefix}_iter_{self.iter}.solverstate{ext}", format)

    def _write_snapshot_files(self, model_path, state_path, format,
                              learned_net=None):
        """Write the two snapshot files to the given (possibly temporary)
        paths; ``learned_net`` is the model path the state file names."""
        learned = learned_net or model_path
        if format == "hdf5":
            hdf5_io.save_net_hdf5(model_path, self.net, self.params)
            hdf5_io.save_state_hdf5(state_path, self.iter, learned,
                                    self.net, self.history)
            return
        wire.dump(self.net.params_to_netproto(self.params, self.state),
                  model_path)
        ss = Message("SolverState", iter=self.iter, learned_net=learned,
                     current_step=0)
        # Caffe's history_ order: slot-major over net-ordered params
        for lname, i, s in hdf5_io.history_order(self.net, self.history):
            ss.history.append(array_to_blob(
                self.history[lname][i][s].detach().cpu().numpy()))
        wire.dump(ss, state_path)

    def restore(self, state_path, reshard="strict"):
        """Resume from a .solverstate (binaryproto) or .solverstate.h5
        and the weights it names (learned_net). A snapshot its manifest
        marks partial or corrupt is refused with the reason; one stamped
        by another world raises WorldMismatch under ``reshard="strict"``,
        while ``reshard="auto"`` re-partitions it for this world: params
        and history are replicated after a round, so the blobs restore
        unchanged and only data ownership re-spreads (the
        reshard_for_world plan, logged as a ``reshard`` event)."""
        from ..resilience import checkpoint
        world = checkpoint.world_signature(self)
        entry = checkpoint.check_restorable(state_path, world,
                                            reshard=reshard)
        self._reshard_plan = None
        if reshard == "auto" and isinstance(entry, dict):
            plan = checkpoint.reshard_for_world(entry.get("world"), world)
            if plan is not None:
                self._reshard_plan = plan
                self.log(
                    f"reshard: snapshot {state_path} written for world "
                    f"{plan['from_world']} ({plan['n_from']} slots); "
                    f"re-partitioning for this world {plan['to_world']} "
                    f"({plan['n_to']} slots, {plan['direction']})")
                if self.metrics is not None:
                    self.metrics.log(
                        "reshard", iter=int(entry.get("iter", 0)),
                        state=state_path, from_world=plan["from_world"],
                        to_world=plan["to_world"], n_from=plan["n_from"],
                        n_to=plan["n_to"], direction=plan["direction"],
                        owners=plan["owners"])
        if state_path.endswith(".h5"):
            it, learned = hdf5_io.load_state_hdf5(state_path, self.net,
                                                  self.history)
            if learned and os.path.exists(learned):
                self.load_weights(learned)
            self.iter = it
            return
        ss = wire.load(state_path, "SolverState")
        order = list(hdf5_io.history_order(self.net, self.history))
        blobs = list(ss.history)
        if len(blobs) != len(order):
            # Caffe SGDSolver::RestoreSolverStateFromBinaryProto
            # CHECK_EQ(state.history_size(), history_.size())
            raise ValueError(
                f"{state_path}: solver state has {len(blobs)} history "
                f"blobs, this solver expects {len(order)} — it was written "
                f"by a different solver type")
        if ss.has("learned_net") and os.path.exists(ss.learned_net):
            self.load_weights(ss.learned_net)
        with torch.no_grad():
            for n, (lname, i, s) in enumerate(order):
                ref = self.history[lname][i][s]
                arr = blob_to_array(blobs[n]).reshape(tuple(ref.shape))
                ref.copy_(torch.tensor(arr))
        self.iter = int(ss.iter)

    def load_weights(self, caffemodel_path):
        """Caffe CopyTrainedLayersFrom: a binaryproto .caffemodel or a
        .caffemodel.h5, layers matched by name."""
        if caffemodel_path.endswith(".h5"):
            hdf5_io.load_net_hdf5(caffemodel_path, self.params)
            return
        net_proto = wire.load(caffemodel_path, "NetParameter")
        self.params, self.state = self.net.load_netproto(
            net_proto, self.params, self.state)
        self._arm_grads()
