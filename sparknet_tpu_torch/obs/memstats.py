"""Memory accounting beside each sampled step (the port of
sparknet_tpu/obs/memstats.py): why did step time regress?

  live_arrays       the caching allocator's active blocks (count and
                    bytes) on a card, the live tensors on the CPU: a
                    leak shows as a steady climb. The JAX package counts
                    its live jax.Arrays here.
  device memory     allocated, reserved and peak bytes from torch.cuda,
                    under the JAX package's hbm_* names
  host rss          ru_maxrss, the host-side twin (prefetch buffers,
                    snapshot staging)

There is no compile cache: the port's step is eager (stepstats.py).
Emitted as ``memstats`` events next to each sampled ``step``, so the
``report`` verb shows memory beside step time.
"""


def live_array_stats(device=None):
    """(count, bytes) of the caching allocator's active blocks on the
    card; on the CPU, of the process's live tensors found by the garbage
    collector (as jax.live_arrays enumerates every array)."""
    import torch
    if device is not None and torch.device(device).type == "cuda":
        ms = torch.cuda.memory_stats(device)
        return (int(ms.get("active.all.current", 0)),
                int(ms.get("active_bytes.all.current", 0)))
    import gc
    count = total = 0
    for o in gc.get_objects():
        if issubclass(type(o), torch.Tensor) and not o.is_cuda:
            count += 1
            total += o.numel() * o.element_size()
    return count, total


def device_memory_stats(device=None):
    """{hbm_bytes_in_use, hbm_peak_bytes_in_use, hbm_bytes_limit,
    hbm_bytes_reserved} of the card, or {} on the CPU."""
    import torch
    from .stepstats import device_memory
    mem = device_memory(device)
    if not mem:
        return {}
    out = {f"hbm_{k}": v for k, v in mem.items()}
    out["hbm_bytes_reserved"] = int(torch.cuda.memory_reserved(device))
    return out


def host_rss_bytes():
    """Peak host RSS in bytes (linux ru_maxrss is KiB), or None."""
    try:
        import resource
        kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return int(kb) * 1024
    except Exception:
        return None


class MemoryMonitor:
    """sample(it) on the solver's step-sample cadence; each sample emits
    one ``memstats`` event. Tracks the peak of the live bytes."""

    def __init__(self, sink, sample_every=1, device=None):
        self.sink = sink
        self.sample_every = max(1, int(sample_every))
        self.device = device
        self._n = 0
        self.peak_live_bytes = 0
        self.samples = 0

    def sample(self, it, force=False, **extra):
        self._n += 1
        if not force and (self._n - 1) % self.sample_every:
            return None
        count, nbytes = live_array_stats(self.device)
        ev = {"iter": it}
        if count is not None:
            ev["live_arrays"] = count
            ev["live_bytes"] = nbytes
            self.peak_live_bytes = max(self.peak_live_bytes, nbytes or 0)
        ev.update(device_memory_stats(self.device))
        rss = host_rss_bytes()
        if rss is not None:
            ev["host_rss_bytes"] = rss
        ev.update({k: v for k, v in extra.items() if v is not None})
        self.samples += 1
        if self.sink is not None:
            self.sink.log("memstats", **ev)
        return ev
