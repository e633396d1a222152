"""Worker divergence: the paper's tau knob, measured (the port of
sparknet_tpu/obs/divergence.py).

SparkNet's central tradeoff is the sync interval tau: more local steps
a round cut communication but let the workers' replicas drift apart
before the average (Stich's local-SGD analysis bounds exactly this drift
term). Two halves:

  slot_divergence   on the card: the port's W worker slots are stacked
      on one device ((W, ...) per blob), so the consensus is a mean over
      the slot axis and each slot's squared L2 distance to it is one
      elementwise pass per blob, summed per layer — a handful of scalars
      and a (W,) vector, never a host copy of weights. The aux keys are
      those of the JAX package's masked_consensus_stats with every worker
      valid.
  DivergenceMeter   host side (a copy of the JAX class): takes the aux
      dict, fetched to the host once per sampled round, emits a
      ``divergence`` JSONL event (mean/max/per-worker distance, the top
      layers, the update norm, a gradient-noise-scale proxy) and returns
      the summary for the health detectors (obs/health.py).

The gradient-noise-scale proxy follows McCandlish et al.'s B_simple
estimator shape: with N workers' updates u_w around consensus u,
``gns_proxy = N/(N-1) * E||u_w - u||^2 / ||u||^2``.
"""

import math

import numpy as np


def _sq(t):
    return t.float().square().sum()


def slot_divergence(stacked, ref_sq=None, worker_loss=None):
    """``stacked``: {layer: [(W, ...) tensors]}, slot w's copy of each
    blob at ``[w]``. Returns (consensus, aux): consensus {layer: [mean
    over the slots]} and the aux of tensors on the card:

      div_mean_sq    E_w ||x_w - consensus||^2
      div_max_sq     max_w ...
      div_worker_sq  (W,) each slot's squared distance
      layer_div_sq   {layer: E_w of its per-layer squared distance}
      valid, n_live  every slot valid (the port has no elastic mask)
      ref_sq, worker_loss   as given (the update's squared norm, the
                     (W,) per-slot losses)
    """
    import torch
    consensus, per_layer, local = {}, {}, None
    for name, blobs in stacked.items():
        if not blobs:
            continue
        means = [B.mean(0) for B in blobs]
        consensus[name] = means
        sq = sum((B.float() - m.float().unsqueeze(0)).square()
                 .reshape(B.shape[0], -1).sum(1)
                 for B, m in zip(blobs, means))
        per_layer[name] = sq.mean()
        local = sq if local is None else local + sq
    W = next(iter(stacked.values()))[0].shape[0] if stacked else 1
    if local is None:
        local = torch.zeros(W)
    aux = {"div_mean_sq": local.mean(), "div_max_sq": local.max(),
           "div_worker_sq": local, "layer_div_sq": per_layer,
           "valid": torch.ones(W), "n_live": W}
    if ref_sq is not None:
        aux["ref_sq"] = ref_sq
    if worker_loss is not None:
        aux["worker_loss"] = worker_loss
    return consensus, aux


def tree_sq_dist(a, b):
    """Squared L2 distance between two {layer: [tensors]} trees ->
    ({layer: sq}, total), on their device, in f32."""
    per, total = {}, None
    for k in a:
        if not a[k]:
            continue
        s = sum(_sq(x - y) for x, y in zip(a[k], b[k]))
        per[k] = s
        total = s if total is None else total + s
    return per, total


def to_host(aux):
    """The aux dict with every tensor fetched to numpy (one sync)."""
    import torch
    if isinstance(aux, dict):
        return {k: to_host(v) for k, v in aux.items()}
    if isinstance(aux, (list, tuple)):
        return type(aux)(to_host(v) for v in aux)
    if isinstance(aux, torch.Tensor):
        return aux.detach().float().cpu().numpy()
    return aux


class DivergenceMeter:
    """Host side: turn one sync round's fetched aux dict into a
    ``divergence`` event + a plain-float summary for the detectors.

    kind: what the distances are over — "params" (local SGD: tau-step
    weight drift) or "grads" (per-step DP: gradient noise across the
    batch shards). ``ref_sq`` in the aux is the squared norm of the
    consensus update (local SGD) or mean gradient (DP) — the
    denominator of the relative drift and the GNS proxy.
    """

    def __init__(self, sink, topk=3):
        self.sink = sink
        self.topk = max(1, int(topk))
        self.last = None
        self.samples = 0

    @staticmethod
    def _f(v):
        try:
            return float(np.asarray(v))
        except Exception:
            return None

    def observe(self, it, aux, kind="params", tau=None, round_idx=None,
                emit=True):
        """aux: host-fetched dict from consensus_stats (plus optional
        ref_sq / worker_loss). Returns the summary dict (floats), or
        None when aux carries no divergence fields."""
        if not aux or "div_mean_sq" not in aux:
            return None
        mean_sq = self._f(aux["div_mean_sq"]) or 0.0
        max_sq = self._f(aux.get("div_max_sq")) or 0.0
        ev = {"iter": it, "kind": kind,
              "mean": round(math.sqrt(max(mean_sq, 0.0)), 8),
              "max": round(math.sqrt(max(max_sq, 0.0)), 8)}
        if tau is not None:
            ev["tau"] = int(tau)
        if round_idx is not None:
            ev["round"] = int(round_idx)
        workers = aux.get("div_worker_sq")
        if workers is not None:
            w = np.sqrt(np.maximum(
                np.asarray(workers, np.float64).ravel(), 0.0))
            ev["per_worker"] = [round(float(x), 8) for x in w]
        layers = aux.get("layer_div_sq") or {}
        ranked = sorted(((k, self._f(v) or 0.0) for k, v in layers.items()),
                        key=lambda kv: -kv[1])
        if ranked:
            ev["top_layers"] = [
                [k, round(math.sqrt(max(v, 0.0)), 8)]
                for k, v in ranked[:self.topk] if v > 0.0] or \
                [[ranked[0][0], 0.0]]
        ref_sq = self._f(aux.get("ref_sq"))
        if ref_sq is not None:
            ev["update_norm"] = round(math.sqrt(max(ref_sq, 0.0)), 8)
            denom = max(ref_sq, 1e-20)
            ev["rel"] = round(math.sqrt(max(mean_sq, 0.0) / denom), 6)
            n = len(ev.get("per_worker", ())) or 0
            if n > 1:
                ev["gns_proxy"] = round(
                    n / (n - 1) * mean_sq / denom, 6)
        wl = aux.get("worker_loss")
        if wl is not None:
            wl = np.asarray(wl, np.float64).ravel()
            ev["worker_loss"] = [round(float(x), 6) for x in wl]
        # elastic membership (resilience/elastic.py): how many workers
        # the masked consensus actually averaged over this round
        nl = self._f(aux.get("n_live"))
        if nl is not None:
            ev["live"] = int(nl)
            n = len(ev.get("per_worker", ()))
            if n and nl < n:
                v = aux.get("valid")
                if v is not None:
                    ev["valid"] = [int(x > 0) for x in
                                   np.asarray(v, np.float64).ravel()]
        # bounded staleness (async mode): the per-worker version lag and
        # park state ride along, and the drift is ATTRIBUTED — how much
        # of this round's worker divergence sits on stale workers vs on
        # membership holes vs plain tau drift. The attribution is what
        # lets an operator tell "s is too loose" from "tau is too big".
        lag = aux.get("lag")
        if lag is not None:
            lag = [int(x) for x in np.asarray(lag, np.float64).ravel()]
            ev["lag"] = lag
            if aux.get("parked") is not None:
                ev["parked"] = [int(w) for w in aux["parked"]]
            w = aux.get("weight")
            if w is not None:
                ev["weight"] = [round(float(x), 4) for x in
                                np.asarray(w, np.float64).ravel()]
            workers = aux.get("div_worker_sq")
            if workers is not None:
                sq = np.asarray(workers, np.float64).ravel()
                total = float(sq.sum())
                stale = float(sum(s for s, l in zip(sq, lag) if l > 0))
                if total > 0:
                    ev["drift_stale_frac"] = round(stale / total, 4)
            valid = aux.get("valid")
            invalid_holes = valid is not None and \
                bool((np.asarray(valid, np.float64).ravel() <= 0).any())
            ev["drift_cause"] = (
                "staleness" if any(l > 0 for l in lag)
                and ev.get("drift_stale_frac", 0) >= 0.5
                else "membership" if invalid_holes or aux.get("parked")
                else "tau")
        self.samples += 1
        self.last = ev
        if emit and self.sink is not None:
            self.sink.log("divergence", **ev)
        return ev
