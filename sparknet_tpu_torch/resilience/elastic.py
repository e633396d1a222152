"""Elastic membership: quorum-based sync rounds that survive worker loss
(the port of sparknet_tpu/resilience/elastic.py, both halves).

device half (torch, on the solver's device): the JAX functions run
inside shard_map and reduce over a named mesh axis; the port's workers
are slots stacked on one card, so each function here takes a tree of
STACKED blobs (every leaf a (W, ...) tensor, slot w at ``[w]``) and
reduces over dim 0 — the W slots of the single-tier solvers, or the host
rows of the two-tier solver's (host, data) slot grid. The validity mask
and the staleness lag are (W,) tensors on the card, so a change of
membership changes an input and rebuilds nothing.

  masked_consensus        validity-masked average over the slots: a slot
                          contributes iff its host-declared alive bit
                          AND its on-device finite check hold; weights
                          renormalize over the live count. BIT FOR BIT
                          the plain ``mean(0)`` when every slot is valid
                          (``torch.where`` keeps dead slots' NaNs out of
                          the sum — ``NaN * 0`` would still be NaN — and
                          the scale n / n_live is exactly 1.0).
  masked_consensus_stats  the same average plus the divergence aux of
                          obs/divergence.py, dead slots excluded from
                          the drift statistics.
  masked_scalar_mean      the masked mean of a (W,) vector (round loss).
  tree_finite / slots_finite
                          "all leaves finite", for one replica or for
                          every slot of a stacked tree at once.
  staleness_discount      the bounded-staleness weight of a lag: 1.0 at
                          lag 0, decay**lag up to the bound s, 0 past it.
  weighted_consensus(_stats)
                          masked_consensus with a [0, 1] weight a slot.

host half:

  ElasticPolicy   per-round membership controller: consumes each round's
                  membership (per-member validity, losses) plus the
                  chaos ``kill_worker``/``kill_host``/``dead_p``
                  injectors, evicts a member after ``evict_after``
                  consecutive invalid rounds (per-member ``eviction``
                  records in the metrics stream), readmits it after a
                  ``readmit_after``-round cooldown (the consensus every
                  slot leaves the round holding is the re-broadcast),
                  and raises QuorumLost when the live count would drop
                  below ``quorum`` — the CLI maps that to exit code
                  EXIT_QUORUM_LOST (4). The serving fleet's router
                  (serve/fleet.py) drives it at replica granularity.
  expand_to_slots re-partition helper: lay batches drawn for the LIVE
                  workers back onto the full slot grid (dead slots get
                  a survivor's copy, which the device mask discards).

Bounded staleness (the async local-SGD mode) generalizes the 0/1
validity bit to a [0, 1] per-worker weight; its host-side bookkeeping
(versions on virtual clocks, parking, resync) is in ElasticPolicy as in
the JAX module.
"""

import numpy as np

from ..utils.exit_codes import EXIT_QUORUM_LOST  # noqa: F401  (re-export)


class QuorumLost(RuntimeError):
    """Live worker count fell below the quorum — the run cannot make a
    trustworthy consensus anymore. The CLI exits EXIT_QUORUM_LOST (4);
    see the JAX package's DEPLOY.md supervisor runbook."""


# -- device half (stacked slots, dim 0) ------------------------------------

def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _slot_mask(mask, x):
    """A (W,) mask shaped to broadcast over a (W, ...) blob."""
    return mask.reshape((-1,) + (1,) * (x.dim() - 1))


def tree_finite(tree):
    """0-d bool tensor: every leaf of ``tree`` (one replica) is finite
    everywhere."""
    import torch
    ok = None
    for leaf in _leaves(tree):
        f = torch.isfinite(leaf.float()).all()
        ok = f if ok is None else ok & f
    return ok if ok is not None else torch.tensor(True)


def slots_finite(stacked):
    """(W,) bool tensor: slot w's leaves of a stacked tree are all
    finite — tree_finite of every slot at once."""
    ok = None
    for leaf in _leaves(stacked):
        f = leaf.float().isfinite().reshape(leaf.shape[0], -1).all(1)
        ok = f if ok is None else ok & f
    return ok


def _live_scale(valid):
    """(n_live, scale) for a masked average over W slots: scale =
    W / max(n_live, 1), EXACTLY 1.0 when every slot is valid (W/W with
    small ints is exact in f32), so ``mean * scale`` is bit for bit the
    plain mean in the all-valid case."""
    import torch
    valid = valid.float()
    n_live = valid.sum()
    scale = torch.tensor(float(valid.shape[0]), device=valid.device) \
        / torch.clamp(n_live, min=1.0)
    return n_live, scale


def masked_consensus(stacked, valid):
    """Validity-masked average of a stacked tree over its slots.
    ``valid``: (W,) f32 0/1 tensor. Returns (consensus, n_live), the
    consensus a tree of unstacked blobs. All-valid: bit for bit
    ``x.mean(0)`` — ``where(True, x, 0)`` is ``x`` and the scale is
    exactly 1.0."""
    import torch
    n_live, scale = _live_scale(valid)
    keep = valid > 0

    def one(x):
        m = torch.where(_slot_mask(keep, x), x, torch.zeros_like(x)).mean(0)
        return m * scale.to(m.dtype)

    return _tree_map(one, stacked), n_live


def masked_scalar_mean(x, valid):
    """Masked mean of a (W,) vector (e.g. the slots' round losses): dead
    slots' NaNs stay out of the value; the all-valid case is bit for
    bit ``x.mean()``."""
    import torch
    x = x.float()
    _, scale = _live_scale(valid)
    return torch.where(valid > 0, x, torch.zeros_like(x)).mean() * scale


def _per_slot_sq(stacked, consensus):
    """({top-level key: (W,) squared distance of each slot to the
    consensus}, (W,) total), in f32 — obs/divergence.tree_sq_dist of
    every slot at once."""
    def sq(B, m):
        return (B.float() - m.float().unsqueeze(0)).square().reshape(
            B.shape[0], -1).sum(1)
    if isinstance(stacked, dict):
        per = {}
        for k, v in stacked.items():
            pairs = list(zip(_leaves(v), _leaves(consensus[k])))
            if pairs:
                per[k] = sum(sq(B, m) for B, m in pairs)
    else:
        per = {"": sum(sq(B, m) for B, m in
                       zip(_leaves(stacked), _leaves(consensus)))}
    total = None
    for v in per.values():
        total = v if total is None else total + v
    return per, total


def masked_consensus_stats(stacked, valid, consensus=None):
    """masked_consensus + the divergence aux of obs/divergence.py, dead
    slots excluded from the drift statistics (their distance to the
    consensus is garbage). The aux:

      div_mean_sq, div_max_sq, div_worker_sq (W,), layer_div_sq
      valid    (W,) each slot's effective validity
      n_live   the live count the average renormalized over

    ``consensus``: an optional precomputed (consensus, n_live) pair."""
    import torch
    consensus, n_live = masked_consensus(stacked, valid) \
        if consensus is None else consensus
    per_layer, local_sq = _per_slot_sq(stacked, consensus)
    keep = valid > 0
    local_sq = torch.where(keep, local_sq, torch.zeros_like(local_sq))
    aux = {"div_mean_sq": masked_scalar_mean(local_sq, valid),
           "div_max_sq": local_sq.max(),
           "div_worker_sq": local_sq,
           "layer_div_sq": {k: masked_scalar_mean(v, valid)
                            for k, v in per_layer.items()},
           "valid": valid.float(), "n_live": n_live}
    return consensus, aux


def staleness_discount(lag, s, decay=0.5):
    """Per-slot staleness weight in [0, 1] of a (W,) f32 lag tensor:
    EXACTLY 1.0 at lag 0 (an s=0 async round is the synchronous masked
    round bit for bit), ``decay ** lag`` while 0 < lag <= s, and 0 past
    the bound (over-stale is dead to the consensus: the same where-mask
    excludes both)."""
    import torch
    lag = torch.as_tensor(lag, dtype=torch.float32)
    one = torch.ones_like(lag)
    w = torch.where(lag <= 0, one,
                    torch.tensor(float(decay), dtype=torch.float32,
                                 device=lag.device) ** lag)
    return torch.where(lag > float(s), torch.zeros_like(lag), w)


def weighted_consensus(stacked, weight):
    """masked_consensus generalized from a 0/1 bit to a [0, 1] weight a
    slot: sum_w weight_w x_w / sum_w weight_w, zero-weight slots
    excluded by ``torch.where``. Returns (consensus, weight_sum). With
    every weight exactly 1.0 it is masked_consensus's all-valid path bit
    for bit (``x * 1.0`` is ``x``, the scale is exactly 1.0)."""
    import torch
    weight = weight.float()
    n = weight.shape[0]
    wsum = weight.sum()
    # the 1e-6 floor only matters when every weight is zero
    scale = torch.tensor(float(n), device=weight.device) \
        / torch.clamp(wsum, min=1e-6)
    keep = weight > 0

    def one(x):
        w = _slot_mask(weight, x).to(x.dtype)
        xw = torch.where(_slot_mask(keep, x), x * w, torch.zeros_like(x))
        m = xw.mean(0)
        return m * scale.to(m.dtype)

    return _tree_map(one, stacked), wsum


def weighted_consensus_stats(stacked, valid, weight, consensus=None):
    """weighted_consensus + the aux of masked_consensus_stats over the
    INCLUDED slots (weight > 0); ``valid`` is the membership bit (what
    ElasticPolicy's eviction streaks read: a parked but healthy slot
    stays valid), and the aux also carries ``weight``."""
    import torch
    consensus, _ = weighted_consensus(stacked, weight) \
        if consensus is None else consensus
    inc = (weight.float() > 0).float()
    per_layer, local_sq = _per_slot_sq(stacked, consensus)
    local_sq = torch.where(inc > 0, local_sq, torch.zeros_like(local_sq))
    aux = {"div_mean_sq": masked_scalar_mean(local_sq, inc),
           "div_max_sq": local_sq.max(),
           "div_worker_sq": local_sq,
           "layer_div_sq": {k: masked_scalar_mean(v, inc)
                            for k, v in per_layer.items()},
           "valid": valid.float(), "weight": weight.float(),
           "n_live": inc.sum()}
    return consensus, aux


# -- host half ---------------------------------------------------------------

def expand_to_slots(shards, owners):
    """Re-partition helper: ``shards`` is a list/array of per-LIVE-worker
    batch shards (worker-major); ``owners[slot]`` indexes into it for
    every slot (identity-ish for live slots, a survivor for dead ones —
    see ElasticPolicy.shard_owners). Returns the full-slot-grid array
    the round expects; dead slots' copies are discarded by the device
    mask, so only live shards carry fresh data."""
    shards = [np.asarray(s) for s in shards]
    return np.stack([shards[o] for o in owners])


class ElasticPolicy:
    """Membership controller for one sharded solver.

    observe_round(round_idx, valid=..., worker_loss=...) once per
    materialized sync round:

      * chaos ``kill_worker``/``dead_p`` injections evict immediately
        (the simulated crash — reason "chaos_kill")
      * an alive worker whose device validity bit was 0 (non-finite
        replica) for ``evict_after`` consecutive observed rounds is
        evicted (reason "nonfinite")
      * an evicted worker is readmitted after ``readmit_after`` rounds
        (0 disables readmission); the consensus weights every slot
        already holds are its restart state
      * if the live count would drop below ``quorum``, QuorumLost is
        raised (after logging a ``membership`` quorum_lost event)

    Every eviction/readmission logs a per-worker ``eviction`` /
    ``readmission`` metrics event, so the ``report`` and ``monitor``
    verbs can render the membership history.
    """

    def __init__(self, n_workers, quorum=1, evict_after=2, readmit_after=5,
                 shrink_after=0, metrics=None, log_fn=print, chaos=None,
                 unit="worker", staleness=None, s_decay=0.5,
                 unpark_after=1, evict_parked_after=0):
        self.n = int(n_workers)
        # membership granularity: "worker" (a mesh slot on the data
        # axis) or "host" (a whole fault domain on the host axis
        # of the hierarchical runtime). Only labeling and which chaos
        # injector feeds evictions differ; the masked-consensus math is
        # identical at either granularity.
        self.unit = str(unit)
        if self.n < 1:
            raise ValueError(f"elastic membership needs >= 1 {self.unit}")
        self.quorum = max(1, int(quorum))
        if self.quorum > self.n:
            raise ValueError(f"quorum {self.quorum} exceeds world size "
                             f"{self.n}")
        self.evict_after = max(1, int(evict_after))
        self.readmit_after = max(0, int(readmit_after))
        # >0: after this many consecutive rounds with ANY eviction in
        # force, suggest shrinking the mesh (the solver acts on it)
        self.shrink_after = max(0, int(shrink_after))
        # bounded staleness (the async local-SGD mode): None = the
        # synchronous policy; an int s >= 0 arms per-worker round-version
        # tracking on virtual clocks — a worker more than s rounds
        # behind the fastest live peer is PARKED (consensus weight 0,
        # still a member), resynced onto the replicated consensus after
        # ``unpark_after`` rounds, and (optionally) evicted after
        # ``evict_parked_after`` parks without a sustained in-bound
        # stretch in between (reason "staleness").
        self.staleness = None if staleness is None else max(0, int(staleness))
        self.s_decay = float(s_decay)
        if not (0.0 < self.s_decay <= 1.0):
            raise ValueError(f"s_decay {self.s_decay} must be in (0, 1]")
        self.unpark_after = max(1, int(unpark_after))
        self.evict_parked_after = max(0, int(evict_parked_after))
        self.metrics = metrics
        self.log = log_fn or (lambda *a: None)
        self.chaos = chaos
        self.alive = np.ones(self.n, bool)
        self.evictions = []             # [{worker, round, reason}, ...]
        self.readmissions = []          # [{worker, round}, ...]
        self.admissions = []            # [{worker, round, via}, ...]
        self._bad_streak = np.zeros(self.n, np.int64)
        self._evicted_at = {}           # worker -> eviction round
        self._admitted_at = {}          # worker -> admission round
        self._degraded_rounds = 0       # consecutive rounds not at full n
        self.quorum_lost = False
        # async version accounting (all no-ops while staleness is None)
        self.parked = np.zeros(self.n, bool)
        self.version = np.zeros(self.n, np.int64)
        self.park_rounds = np.zeros(self.n, np.int64)  # total parked time
        self.parks = []                 # [{worker, round, lag}, ...]
        self.unparks = []               # [{worker, round, parked_rounds}]
        self._parked_at = {}            # worker -> park round
        self._park_streak = np.zeros(self.n, np.int64)
        self._inbound_streak = np.zeros(self.n, np.int64)
        self._done_at = np.zeros(self.n, np.float64)   # virtual clocks
        self._wall = 0.0

    # -- views -------------------------------------------------------------
    def live(self):
        """Sorted indices of live workers."""
        return [int(w) for w in np.nonzero(self.alive)[0]]

    def live_count(self):
        return int(self.alive.sum())

    def alive_f32(self):
        """The (n,) host alive mask the compiled round consumes."""
        return self.alive.astype(np.float32)

    def shard_owners(self):
        """For every mesh slot, the index (into the LIVE-ordered shard
        list) of the shard that fills it: live slots own their shard in
        live order; dead slots borrow a survivor's round-robin — see
        data/sampler.partition_owners and expand_to_slots."""
        from ..data.sampler import partition_owners
        owner_worker = partition_owners(self.n, self.alive)
        live = self.live()
        rank = {w: i for i, w in enumerate(live)}
        return [rank[int(w)] for w in owner_worker]

    def lag(self):
        """(n,) rounds each worker trails the fastest LIVE peer (0 with
        the synchronous policy). Parked and evicted workers' versions
        stop advancing, so their lag keeps growing until resync."""
        if self.staleness is None:
            return np.zeros(self.n, np.float64)
        fastest = self.version[self.alive].max() if self.alive.any() else 0
        return np.maximum(0, fastest - self.version).astype(np.float64)

    def consensus_weights(self):
        """(n,) f32 staleness-discounted consensus weight per worker —
        the host-side twin of the device staleness_discount path, for
        transports that average on the host (the async file relay).
        All ones with the synchronous policy."""
        w = self.alive_f32()
        if self.staleness is None:
            return w
        lag = self.lag()
        disc = np.where(lag <= 0, np.float32(1),
                        np.float32(self.s_decay) ** lag.astype(np.float32))
        disc = np.where(lag > self.staleness, np.float32(0), disc)
        return (w * disc).astype(np.float32)

    def summary(self):
        out = {"world": self.n, "live": self.live_count(),
               "quorum": self.quorum, "unit": self.unit,
               "evictions": list(self.evictions),
               "readmissions": list(self.readmissions),
               "admissions": list(self.admissions),
               "quorum_lost": self.quorum_lost}
        if self.staleness is not None:
            out.update(staleness=self.staleness,
                       parks=len(self.parks), unparks=len(self.unparks),
                       parked=[int(w) for w in np.nonzero(self.parked)[0]],
                       park_rounds_by_worker={
                           str(w): int(r) for w, r in
                           enumerate(self.park_rounds) if r},
                       max_lag=int(self.lag().max()))
        return out

    # -- membership transitions --------------------------------------------
    def evict(self, worker, round_idx, reason):
        w = int(worker)
        if not (0 <= w < self.n) or not self.alive[w]:
            return False
        if self.live_count() - 1 < self.quorum:
            self._quorum_lost(round_idx, would_evict=w, reason=reason)
        self.alive[w] = False
        self._bad_streak[w] = 0
        self._evicted_at[w] = round_idx
        if self.parked[w]:              # an evicted worker is no longer
            self.parked[w] = False      # "parked" — dead outranks stale
            r0 = self._parked_at.pop(w, round_idx)
            self.park_rounds[w] += max(0, round_idx - r0)
        rec = {"worker": w, "round": round_idx, "reason": reason,
               "live": self.live_count(), "unit": self.unit}
        self.evictions.append(rec)
        self.log(f"elastic: EVICTED {self.unit} {w} at round {round_idx} "
                 f"({reason}); {self.live_count()}/{self.n} live, "
                 f"shard re-spread over survivors")
        if self.metrics is not None:
            self.metrics.log("eviction", **rec)
            if self.unit == "host":
                # the per-host liveness stream (resilience/heartbeat.py
                # satellite): monitor/report render host evictions
                # without reparsing the generic eviction records
                self.metrics.log("host_evicted", host=w, round=round_idx,
                                 reason=reason, live=self.live_count())
        return True

    def readmit(self, worker, round_idx):
        w = int(worker)
        if not (0 <= w < self.n) or self.alive[w]:
            return False
        self.alive[w] = True
        self._bad_streak[w] = 0
        self._evicted_at.pop(w, None)
        if self.staleness is not None:
            # the replicated consensus IS the readmission re-broadcast:
            # the worker rejoins at the front, lag 0
            self.version[w] = self.version[self.alive].max()
            self._done_at[w] = self._wall
            self._park_streak[w] = 0
        rec = {"worker": w, "round": round_idx, "live": self.live_count(),
               "unit": self.unit}
        self.readmissions.append(rec)
        self.log(f"elastic: readmitted {self.unit} {w} at round {round_idx} "
                 f"from the consensus weights; "
                 f"{self.live_count()}/{self.n} live")
        if self.metrics is not None:
            self.metrics.log("readmission", **rec)
        return True

    def admit(self, worker, round_idx, via="grow"):
        """Admit ``worker`` into the world mid-run — the grow twin of
        evict/readmit (ROADMAP item 4: cluster size as a runtime knob).
        A known evicted slot is a readmission (a preempted host
        rejoining through the rendezvous); a slot index at or beyond
        the current world GROWS every per-worker array by append — the
        same masked-collective trick that makes eviction free makes
        admission free, because membership is host-side state and the
        compiled round never sees the world size change (zero
        recompiles). Either way the newcomer bootstraps from the
        replicated consensus weights, exactly like a readmission.
        Emits a ``membership`` admission record plus ``host_joined``
        (host unit) so report/monitor render joins beside evictions."""
        w = int(worker)
        if w < 0:
            return False
        if w < self.n:
            if self.alive[w] or not self.readmit(w, round_idx):
                return False
            self._record_admission(w, round_idx, via)
            return True
        front = int(self.version[self.alive].max()) if self.alive.any() \
            else 0
        grow = w + 1 - self.n
        self.alive = np.append(self.alive, np.ones(grow, bool))
        self._bad_streak = np.append(self._bad_streak,
                                     np.zeros(grow, np.int64))
        self.parked = np.append(self.parked, np.zeros(grow, bool))
        # the newcomer joins at the front of the version clocks: the
        # consensus it bootstraps from IS the freshest state
        self.version = np.append(self.version,
                                 np.full(grow, front, np.int64))
        self.park_rounds = np.append(self.park_rounds,
                                     np.zeros(grow, np.int64))
        self._park_streak = np.append(self._park_streak,
                                      np.zeros(grow, np.int64))
        self._inbound_streak = np.append(self._inbound_streak,
                                         np.zeros(grow, np.int64))
        self._done_at = np.append(self._done_at,
                                  np.full(grow, self._wall, np.float64))
        self.n = w + 1
        self._record_admission(w, round_idx, via)
        return True

    def _record_admission(self, w, round_idx, via):
        # the round that just materialized ran with this slot masked
        # out, so its validity bit is stale for the newcomer — exempt
        # it from this round's bad-streak accounting or evict_after=1
        # would re-evict every admission as "nonfinite" on arrival
        self._admitted_at[w] = round_idx
        rec = {"worker": w, "round": round_idx, "live": self.live_count(),
               "unit": self.unit, "via": via, "world": self.n}
        self.admissions.append(rec)
        self.log(f"elastic: ADMITTED {self.unit} {w} at round {round_idx} "
                 f"({via}); {self.live_count()}/{self.n} live, newcomer "
                 "bootstraps from the consensus weights")
        if self.metrics is not None:
            self.metrics.log("membership", kind="admission", **rec)
            if self.unit == "host":
                self.metrics.log("host_joined", host=w, round=round_idx,
                                 live=self.live_count(), via=via,
                                 world=self.n)

    # -- bounded staleness: park / unpark / version clocks -------------------
    def park(self, worker, round_idx, lag=None):
        """Park a worker whose staleness bound was hit: consensus weight
        0 (the same exclusion machinery as a dead worker) but it stays a
        MEMBER — no quorum impact, and the unpark below is its
        readmission. A ``parked`` metrics event records the transition;
        ``evict_parked_after`` consecutive parks without a sustained
        in-bound stretch escalate to a real eviction (reason
        "staleness"), which CAN raise QuorumLost."""
        w = int(worker)
        if not (0 <= w < self.n) or not self.alive[w] or self.parked[w]:
            return False
        self.parked[w] = True
        self._parked_at[w] = round_idx
        self._park_streak[w] += 1
        self._inbound_streak[w] = 0
        rec = {"worker": w, "round": round_idx, "unit": self.unit,
               "lag": None if lag is None else int(lag),
               "streak": int(self._park_streak[w])}
        self.parks.append(rec)
        self.log(f"elastic: PARKED {self.unit} {w} at round {round_idx} "
                 f"(lag {lag} > staleness bound {self.staleness}); "
                 f"excluded from the consensus until resync")
        if self.metrics is not None:
            self.metrics.log("parked", **rec)
        if self.evict_parked_after and \
                self._park_streak[w] >= self.evict_parked_after:
            return self.evict(w, round_idx, "staleness")
        return True

    def unpark(self, worker, round_idx):
        """Readmit a parked worker: it adopts the replicated consensus
        (every slot already holds it — the free re-broadcast) and
        rejoins at the front with lag 0. Emits an ``unparked`` event
        carrying the park duration (the park-time metric)."""
        w = int(worker)
        if not (0 <= w < self.n) or not self.parked[w]:
            return False
        self.parked[w] = False
        r0 = self._parked_at.pop(w, round_idx)
        dur = max(0, round_idx - r0)
        self.park_rounds[w] += dur
        self.version[w] = self.version[self.alive].max() \
            if self.alive.any() else self.version[w]
        self._done_at[w] = self._wall
        rec = {"worker": w, "round": round_idx, "unit": self.unit,
               "parked_rounds": int(dur),
               "park_rounds_total": int(self.park_rounds[w])}
        self.unparks.append(rec)
        self.log(f"elastic: unparked {self.unit} {w} at round {round_idx} "
                 f"after {dur} round(s), resynced from the consensus")
        if self.metrics is not None:
            self.metrics.log("unparked", **rec)
        return True

    def advance_versions(self, round_idx, round_s, slow=None):
        """Advance the per-worker virtual clocks by one wall round of
        ``round_s`` seconds. A healthy worker completes exactly one
        local round per wall round; a straggler (``slow``: the chaos
        ``slow_worker`` spec ``(worker, extra_s)``) pays ``extra_s``
        more per local round, so it completes them at rate
        round_s / (round_s + extra_s) and its version lag grows — the
        consensus does NOT wait for it (that is the whole point), it
        just discounts or excludes its contributions."""
        if self.staleness is None:
            return
        dt = max(float(round_s), 1e-6)
        self._wall += dt
        extra = np.zeros(self.n, np.float64)
        if slow is not None and slow[0] is not None \
                and 0 <= int(slow[0]) < self.n:
            extra[int(slow[0])] = max(0.0, float(slow[1]))
        for w in range(self.n):
            if not self.alive[w] or self.parked[w]:
                # parked/dead workers aren't racing; they rejoin fresh
                self._done_at[w] = self._wall
                continue
            cost = dt + extra[w]
            while self._done_at[w] + cost <= self._wall + 1e-9:
                self._done_at[w] += cost
                self.version[w] += 1

    def observe_staleness(self, round_idx):
        """The per-round staleness controller (async mode only): unpark
        workers whose cooldown elapsed (resync = readmission), then park
        any live worker whose lag crossed the bound. Returns True when
        park state changed (the next round's weights differ)."""
        if self.staleness is None:
            return False
        changed = False
        for w, r0 in sorted(self._parked_at.items()):
            if round_idx - r0 >= self.unpark_after:
                changed |= self.unpark(w, round_idx)
        lag = self.lag()
        for w in range(self.n):
            if not self.alive[w] or self.parked[w]:
                continue
            if lag[w] > self.staleness:
                changed |= self.park(w, round_idx, lag=lag[w])
            else:
                # a sustained in-bound stretch clears the park streak
                # (the worker genuinely recovered, it isn't cycling)
                self._inbound_streak[w] += 1
                if self._inbound_streak[w] > self.unpark_after + 1:
                    self._park_streak[w] = 0
        return changed

    def _quorum_lost(self, round_idx, **fields):
        self.quorum_lost = True
        if self.metrics is not None:
            self.metrics.log("membership", kind="quorum_lost",
                             round=round_idx, live=self.live_count(),
                             quorum=self.quorum, **fields)
        self.log(f"elastic: QUORUM LOST at round {round_idx}: "
                 f"{self.live_count()} live, need {self.quorum}")
        raise QuorumLost(
            f"live {self.unit}s would drop below quorum {self.quorum} "
            f"at round {round_idx} (exit {EXIT_QUORUM_LOST})")

    # -- the per-round controller ------------------------------------------
    def observe_round(self, round_idx, valid=None, worker_loss=None):
        """Feed one materialized round's membership signals. ``valid``:
        the (n,) effective validity vector fetched from the compiled
        round (host mask AND device finite bit). Raises QuorumLost when
        an eviction (or a chaos kill) would break the quorum. Returns
        True when membership changed (the caller may want to re-spread
        data or shrink)."""
        changed = False
        injector = "dead_hosts" if self.unit == "host" else "dead_workers"
        if self.chaos is not None and hasattr(self.chaos, injector):
            for w in getattr(self.chaos, injector)(round_idx, self.n):
                changed |= self.evict(w, round_idx, "chaos_kill")
        if self.chaos is not None and \
                hasattr(self.chaos, "rejoining_hosts") and \
                self.unit == "host":
            # preempt_host=H,rejoin_after=R (virtual hosts): the
            # preempted host comes back through the rendezvous R rounds
            # after its lease-drop, as an admission rather than the
            # readmit cooldown below
            for w in self.chaos.rejoining_hosts(round_idx):
                changed |= self.admit(w, round_idx, via="rejoin")
        if valid is not None:
            v = np.asarray(valid, np.float64).ravel()[:self.n]
            for w in range(len(v)):
                if not self.alive[w]:
                    continue
                if self._admitted_at.get(w) == round_idx:
                    continue    # admitted after this round ran: the
                                # validity bit predates its membership
                if v[w] > 0:
                    self._bad_streak[w] = 0
                    continue
                self._bad_streak[w] += 1
                if self._bad_streak[w] >= self.evict_after:
                    reason = "nonfinite"
                    if worker_loss is not None:
                        wl = np.asarray(worker_loss, np.float64).ravel()
                        if w < len(wl) and not np.isfinite(wl[w]):
                            reason = f"nonfinite loss ({wl[w]})"
                    changed |= self.evict(w, round_idx, reason)
        if self.readmit_after:
            for w, r0 in sorted(self._evicted_at.items()):
                if round_idx - r0 >= self.readmit_after:
                    changed |= self.readmit(w, round_idx)
        self._degraded_rounds = self._degraded_rounds + 1 \
            if self.live_count() < self.n else 0
        return changed

    def should_shrink(self):
        """True when evictions have been in force long enough that the
        solver should rebuild its mesh over the survivors (shrink_after
        rounds; 0 disables)."""
        return bool(self.shrink_after) and \
            self._degraded_rounds >= self.shrink_after and \
            self.live_count() < self.n

    def reset_world(self, n_workers):
        """After a mesh shrink: the survivors ARE the new world."""
        self.n = int(n_workers)
        self.quorum = min(self.quorum, self.n)
        self.alive = np.ones(self.n, bool)
        self._bad_streak = np.zeros(self.n, np.int64)
        self._evicted_at = {}
        self._admitted_at = {}
        self._degraded_rounds = 0
        self.parked = np.zeros(self.n, bool)
        self.version = np.zeros(self.n, np.int64)
        self.park_rounds = np.zeros(self.n, np.int64)
        self._parked_at = {}
        self._park_streak = np.zeros(self.n, np.int64)
        self._inbound_streak = np.zeros(self.n, np.int64)
        self._done_at = np.zeros(self.n, np.float64)
        self._wall = 0.0
        if self.metrics is not None:
            self.metrics.log("membership", kind="world_reset",
                             live=self.n)
