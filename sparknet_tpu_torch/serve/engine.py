"""Weights-only serving engine over resilient checkpoints, on the card.

The training side writes sha256-stamped atomic manifests
(resilience/checkpoint.py); the engine consumes them through
load_model_only — the optimizer-state file is never read.

Every request batch is padded up to the nearest power-of-two bucket (up
to --max_batch) and runs through that bucket's TEST-phase CompiledNet,
eagerly under ``torch.inference_mode()``; outputs are sliced back to the
real rows. One net per bucket keeps the set of shapes the card sees
bounded whatever batch sizes arrive.

Hot reload: poll_reload() re-reads ``<prefix>.latest.json`` between
batches; when the manifest names a newer model blob that verifies, the
new weights are loaded off the serving path and swapped in under the
status lock as one reference assignment — in-flight batches keep the
params they captured, and a torn or corrupt manifest/blob keeps the old
weights serving.
"""

import threading
import time

import numpy as np
import torch

from ..device import resolve_device


def bucket_sizes(max_batch):
    """Powers-of-two padding buckets, max_batch always included last."""
    sizes, b = [], 1
    while b < int(max_batch):
        sizes.append(b)
        b *= 2
    sizes.append(int(max_batch))
    return sizes


def bucket_for(n, sizes):
    """Smallest bucket >= n, or None when n exceeds the largest."""
    for b in sizes:
        if n <= b:
            return b
    return None


def _feed_dtype(name, shape):
    if len(shape) <= 1 or "label" in name:
        return np.int32
    return np.float32


_FEED_TYPES = ("JavaData", "Data", "DummyData", "Input", "MemoryData",
               "HDF5Data", "ImageData", "WindowData")


def deploy_net_param(net_param):
    """Train prototxt -> deploy net: drop loss/accuracy layers (their
    logit bottoms become net outputs — the blobs /predict returns) and
    feed layers nothing consumes afterwards (the label feed). A net
    that is already deploy-shaped passes through unchanged."""
    np_ = net_param.copy()
    kept = [lp for lp in np_.layer
            if "loss" not in lp.type.lower()
            and "accuracy" not in lp.type.lower()]
    used = set()
    for lp in kept:
        used.update(str(b) for b in lp.bottom)
    kept = [lp for lp in kept
            if lp.type not in _FEED_TYPES or not len(lp.top)
            or any(str(t) in used for t in lp.top)]
    np_.layer.clear()
    for lp in kept:
        np_.layer.append(lp)
    return np_


class ServeEngine:
    """Serve ``<prefix>``'s newest servable snapshot on ``device``.

    ``device`` defaults to the card; with no card it raises unless the
    caller passes ``device="cpu"``. Serving computes in float32, the JAX
    package's default precision: resolve_device turns TF32 off on the
    card. With ``metrics`` (a MetricsLogger) every hot reload is a
    ``serve_reload`` event."""

    def __init__(self, prefix, net_param=None, max_batch=8, device="cuda",
                 metrics=None, log_fn=print):
        self.prefix = prefix
        self.device = resolve_device(device)
        self.metrics = metrics
        self.max_batch = int(max_batch)
        self.buckets = bucket_sizes(self.max_batch)
        self.log = log_fn or (lambda *a: None)
        self._net_param = net_param       # template; None -> from checkpoint
        self._lock = threading.Lock()
        self._params = None               # spk: guarded-by=_lock
        self._state = None                # spk: guarded-by=_lock
        self._loaded = None               # spk: guarded-by=_lock
        self._reloads = 0                 # spk: guarded-by=_lock
        self._nets = {}                   # bucket -> CompiledNet (serve thread)
        self._base = None                 # probe net: shapes + weight loading
        self._base_shapes = None          # feed blob -> full-batch shape

    # -- loading -----------------------------------------------------------

    def load(self):
        """Initial weights-only load; raises ValueError (naming the
        manifest) when no servable model blob exists."""
        from ..resilience import checkpoint
        model_path, entry = checkpoint.load_model_only(
            self.prefix, log_fn=self.log)
        params, state = self._load_params(model_path)
        with self._lock:
            self._params, self._state = params, state
            self._loaded = entry
        self.log(f"serve: loaded iter {entry.get('iter')} "
                 f"from {model_path}")
        return entry

    def _load_params(self, model_path):
        """(params, state) on the engine's device from one binaryproto
        model blob — a full NetParameter, so no --model prototxt is
        needed."""
        from ..proto import wire
        from ..graph.compiler import CompiledNet, TEST
        if model_path.endswith(".h5"):
            raise ValueError(
                f"checkpoint {model_path} is HDF5; the PyTorch port serves "
                "binaryproto snapshots (HDF5 waits for a later slice)")
        net_proto = wire.load(model_path, "NetParameter")
        if self._net_param is None:
            self._net_param = net_proto.copy()
        if self._base is None:
            self._net_param = deploy_net_param(self._net_param)
            self._base = CompiledNet(self._net_param.copy(), TEST,
                                     device=self.device)
            self._base_shapes = {
                n: tuple(s) for n, s in self._base.feed_shapes().items()}
        params, state = self._base.init()
        return self._base.load_netproto(net_proto, params, state)

    # -- per-bucket nets ---------------------------------------------------

    def _bucket_net(self, b):
        from ..graph.compiler import CompiledNet, TEST
        net = self._nets.get(b)
        if net is None:
            np_b = self._net_param.copy()
            # deploy nets size their net-level inputs from input_shape;
            # feed layers take the feed_shapes override — rewrite both
            # to this bucket's leading dim
            for s in np_b.input_shape:
                if len(s.dim):
                    s.dim[0] = b
            for i in range(0, len(np_b.input_dim), 4):
                np_b.input_dim[i] = b
            shapes = {n: (b,) + tuple(base[1:])
                      for n, base in self._base_shapes.items()}
            net = CompiledNet(np_b, TEST, feed_shapes=shapes,
                              device=self.device)
            self._nets[b] = net
        return net

    def run_bucket(self, b, feeds):
        """The device forward of bucket ``b``: ``feeds`` maps every feed
        blob to an array or tensor with exactly ``b`` rows; returns the
        net's output blobs as tensors on the engine's device."""
        net = self._bucket_net(b)
        with self._lock:
            params, state = self._params, self._state
        with torch.inference_mode():
            blobs, _ = net.apply(params, state, feeds, train=False)
        return {k: blobs[k] for k in net.output_blobs if k in blobs}

    def warmup(self):
        """Run every bucket once (building the CUDA kernels on first
        use) so first requests don't pay for it."""
        for b in self.buckets:
            self.forward({}, n=b)

    def feed_shapes(self):
        """{feed blob -> per-sample shape (leading dim stripped)}."""
        if self._base_shapes is None:
            raise RuntimeError("engine not loaded")
        return {n: tuple(s[1:]) for n, s in self._base_shapes.items()}

    # -- forward -----------------------------------------------------------

    def forward(self, batch, n=None):
        """Pad ``batch`` ({feed blob -> array, leading dim = rows}) to
        its bucket, run the bucket's net, slice outputs back to the
        real row count. Missing feed blobs (labels on a train-style
        prototxt) are zero-filled. Returns (outputs as numpy, bucket)."""
        if n is None:
            n = max((int(np.shape(v)[0]) for v in batch.values()),
                    default=1)
        b = bucket_for(n, self.buckets)
        if b is None:
            raise ValueError(
                f"batch of {n} rows exceeds max_batch={self.max_batch}")
        padded = {}
        for name, base in self._base_shapes.items():
            target = (b,) + tuple(base[1:])
            dt = _feed_dtype(name, base)
            arr = batch.get(name)
            if arr is None:
                padded[name] = np.zeros(target, dt)
                continue
            arr = np.asarray(arr, dt)
            if arr.shape[1:] != target[1:]:
                raise ValueError(
                    f"feed {name!r}: per-sample shape {arr.shape[1:]} "
                    f"!= expected {target[1:]}")
            if arr.shape[0] < b:
                pad = np.zeros((b - arr.shape[0],) + target[1:], dt)
                arr = np.concatenate([arr, pad], axis=0)
            padded[name] = arr
        out = self.run_bucket(b, padded)
        res = {}
        for k, v in out.items():
            a = v.cpu().numpy()
            # batch-shaped outputs are sliced back to the real rows
            res[k] = a[:n] if a.ndim and a.shape[0] == b else a
        return res, b

    # -- hot reload --------------------------------------------------------

    def poll_reload(self):
        """Swap in the manifest's newest servable weights when they
        differ from what is loaded; returns the new entry or None.
        Every failure path (torn manifest, missing/corrupt blob) keeps
        the current weights serving."""
        from ..resilience import checkpoint
        man = checkpoint.load_manifest(self.prefix)
        latest = (man or {}).get("latest")
        if not isinstance(latest, dict):
            return None
        with self._lock:
            loaded = self._loaded
        if loaded is not None and \
                latest.get("iter") == loaded.get("iter") and \
                latest.get("sha256") == loaded.get("sha256"):
            return None
        try:
            model_path, entry = checkpoint.load_model_only(
                self.prefix, log_fn=self.log)
        except (OSError, ValueError) as e:
            self.log(f"serve: reload skipped ({e}); keeping "
                     f"iter {None if loaded is None else loaded.get('iter')}")
            return None
        if loaded is not None and \
                entry.get("iter") == loaded.get("iter") and \
                entry.get("sha256") == loaded.get("sha256"):
            return None          # newest SERVABLE blob is what we have
        t0 = time.perf_counter()
        try:
            params, state = self._load_params(model_path)
        except (OSError, ValueError, KeyError) as e:
            self.log(f"serve: reload of {model_path} failed ({e}); "
                     "keeping current weights")
            return None
        from_iter = None if loaded is None else loaded.get("iter")
        with self._lock:
            self._params, self._state = params, state
            self._loaded = entry
            self._reloads += 1
        ms = (time.perf_counter() - t0) * 1e3
        self.log(f"serve: hot-reloaded iter {entry.get('iter')} "
                 f"(was {from_iter}) in {ms:.0f} ms")
        if self.metrics is not None:
            self.metrics.log("serve_reload", iter=entry.get("iter"),
                             from_iter=from_iter,
                             model=entry.get("model"), ms=round(ms, 3))
        return entry

    def status(self):
        """Snapshot for /healthz (called from HTTP handler threads); its
        ``sha`` is the loaded blob's, which the fleet's canary keys on."""
        with self._lock:
            loaded, reloads = self._loaded, self._reloads
        return {
            "iter": None if loaded is None else loaded.get("iter"),
            "model": None if loaded is None else loaded.get("model"),
            "sha": None if loaded is None else loaded.get("sha256"),
            "reloads": reloads,
            "buckets": list(self.buckets),
            "feeds": {n: list(s) for n, s in self.feed_shapes().items()},
            "device": str(self.device),
        }
