"""PipelineLMSolver: zoo.transformer_lm trained with its trunk as a GPipe
pipeline over the "pipe" slots (the port of
sparknet_tpu/parallel/pipeline_solver.py).

  prefix (embed)      replicated, once
  blocks (x L)        ONE CompiledNet (the block at microbatch shape);
                      its params stacked on a leading (L, ...) dim, stage
                      d owning L/S consecutive blocks; the forward is
                      parallel/pipeline.py's pipeline_apply (M
                      microbatches, default 2 x stages)
  suffix (head+loss)  replicated, once

The optimizer is the Caffe-semantics Updater over the flat {prefix/...,
blocks/..., suffix/...} param dict (every lr and decay multiplier 1, as
in the JAX solver); stacked leaves update elementwise, so the math is
the unpipelined net's. Snapshots are the JAX solver's ``.lm.npz``: keys
``p/<layer>@i`` and ``h/<layer>@i@s`` and ``__iter__``, so each package
resumes the other's file.
"""

import time

import numpy as np
import torch

from ..device import resolve_device
from ..graph.compiler import TRAIN, CompiledNet
from ..solver.lr_policy import make_lr_fn
from ..solver.solver import clear_grads, grads_of, to_device
from ..solver.updates import Updater
from .mesh import PIPE_AXIS, make_mesh
from .pipeline import pipeline_apply, stack_params


def _flat(prefix_name, layer_params):
    return {f"{prefix_name}/{ln}": list(blobs)
            for ln, blobs in layer_params.items()}


def _unflat(flat, prefix_name):
    plen = len(prefix_name) + 1
    return {k[plen:]: v for k, v in flat.items()
            if k.startswith(prefix_name + "/")}


class PipelineLMSolver:
    """A Solver-shaped driver (train_step / step / params / history /
    iter / snapshot / restore) for the pipelined LM: three CompiledNets
    composed, not one net, so not a Solver subclass (as in the JAX
    package)."""

    def __init__(self, solver_param, mesh=None, num_layers=4,
                 num_microbatches=None, axis=PIPE_AXIS, device="cuda",
                 log_fn=print, metrics=None, compute_dtype=None,
                 **lm_kwargs):
        from ..models import zoo
        self.param = solver_param
        self.log = log_fn or (lambda *a: None)
        self.device = resolve_device(device)
        self._own_metrics = isinstance(metrics, str)
        if self._own_metrics:
            from ..utils.metrics import MetricsLogger
            metrics = MetricsLogger(metrics)
        self.metrics = metrics
        from ..obs import Tracer
        self.tracer = Tracer(self.metrics)
        self.stepstats = self.comms = None
        self._comms_registered = False
        if self.metrics is not None:
            from ..obs import CommsMeter, StepAccounting
            self.stepstats = StepAccounting(self.metrics)
            self.comms = CommsMeter(self.metrics)
        self.mesh = mesh if mesh is not None else make_mesh({axis: -1})
        self.axis = axis
        S = self.mesh.shape[axis]
        if num_layers % S:
            raise ValueError(f"num_layers {num_layers} not divisible by "
                             f"pipeline stages {S}")
        self.num_layers = num_layers
        self.num_microbatches = num_microbatches or max(2 * S, 1)
        prefix_np, block_np, suffix_np = zoo.transformer_lm_pieces(
            **lm_kwargs)
        kw = dict(device=self.device, compute_dtype=compute_dtype)
        self.prefix = CompiledNet(prefix_np, TRAIN, **kw)
        self.suffix = CompiledNet(suffix_np, TRAIN, **kw)
        self.batch_size, self.seq_len = self.prefix.feed_shapes()["data"]
        if self.batch_size % self.num_microbatches:
            raise ValueError(
                f"batch {self.batch_size} not divisible by "
                f"microbatches {self.num_microbatches}")
        mb = self.batch_size // self.num_microbatches
        self.d_model = self.suffix.feed_shapes()["x"][2]
        self.block = CompiledNet(
            block_np, TRAIN, feed_shapes={"x": (mb, self.seq_len,
                                                self.d_model)}, **kw)
        seed = int(solver_param.random_seed)
        gen = torch.Generator().manual_seed(seed if seed >= 0 else 0)
        prefix_p, _ = self.prefix.init(gen)
        suffix_p, _ = self.suffix.init(gen)
        blocks = [self.block.init(gen)[0] for _ in range(num_layers)]
        self.params = {**_flat("prefix", prefix_p),
                       **_flat("blocks", stack_params(blocks)),
                       **_flat("suffix", suffix_p)}
        for blobs in self.params.values():
            for p in blobs:
                p.requires_grad_(True)
        mults = {ln: [(1.0, 1.0)] * len(v) for ln, v in self.params.items()}
        self.updater = Updater(solver_param, mults)
        self.history = self.updater.init(self.params)
        self.lr_fn = make_lr_fn(solver_param)
        self.iter = 0
        self._last_loss = None
        self.snapshot_prefix = None   # set to enable periodic snapshots

    # -- forward/loss ------------------------------------------------------
    def _block_fn(self, bp, h):
        blobs, _ = self.block.apply(bp, {}, {"x": h}, train=True)
        return blobs["res2"]

    def loss(self, batch):
        pp = _unflat(self.params, "prefix")
        bp = _unflat(self.params, "blocks")
        sp_ = _unflat(self.params, "suffix")
        blobs, _ = self.prefix.apply(pp, {}, batch, train=True)
        h = pipeline_apply(self._block_fn, bp, blobs["embed"], self.mesh,
                           self.num_microbatches, axis=self.axis)
        loss, _ = self.suffix.loss_fn(sp_, {}, {"x": h,
                                                "label": batch["label"]})
        return loss

    # -- public API --------------------------------------------------------
    def smoothed_loss(self):
        """Latest step loss (one fetch), or None before any step."""
        if self._last_loss is None:
            return None
        return float(self._last_loss)

    def train_step(self, batch):
        t0 = time.perf_counter()
        dev = to_device(batch, self.device)
        clear_grads(self.params)
        loss = self.loss(dev)
        loss.backward()
        self.updater(self.params, grads_of(self.params), self.history,
                     self.lr_fn(self.iter), self.iter)
        self.iter += 1
        self._last_loss = loss.detach()
        self._obs_step(time.perf_counter() - t0, self._last_loss, batch)
        return self._last_loss

    def step(self, num_iters, data_iter):
        sp = self.param
        t_last, it_last = time.time(), self.iter
        for _ in range(num_iters):
            loss = self.train_step(next(data_iter))
            if sp.display and (self.iter - 1) % sp.display == 0:
                v = float(loss)
                lr = float(self.lr_fn(self.iter - 1))
                self.log(f"Iteration {self.iter - 1}, loss = {v:.6g}, "
                         f"lr = {lr:.6g}")
                if self.metrics:
                    dt = time.time() - t_last
                    toks = (self.iter - it_last) * self.batch_size \
                        * self.seq_len
                    self.metrics.log(
                        "train", iter=self.iter - 1, loss=v, lr=lr,
                        tokens_per_sec=round(toks / dt, 1) if dt > 0
                        else None)
                    t_last, it_last = time.time(), self.iter
            if sp.snapshot and self.snapshot_prefix \
                    and self.iter % int(sp.snapshot) == 0:
                self.snapshot(self.snapshot_prefix)

    def _register_comms(self, cm):
        """GPipe stage traffic: every microbatch activation crosses each
        stage boundary once forward and its gradient once backward."""
        from ..obs.comms import tree_bytes
        S = self.mesh.shape[self.axis]
        mb = self.batch_size // self.num_microbatches
        act = mb * self.seq_len * self.d_model * 4       # f32 carrier
        cm.set_topology(strategy=type(self).__name__,
                        n_devices=self.mesh.size,
                        axes=dict(self.mesh.shape),
                        param_bytes=tree_bytes(self.params))
        if S > 1:
            cm.register("pipeline_ppermute",
                        2 * self.num_microbatches * act, axis=self.axis,
                        note="microbatch activations fwd + grads bwd, "
                             "per chip per step")

    def _obs_step(self, host_s, result, batch):
        if self.stepstats is None:
            return
        if not self._comms_registered:
            self._comms_registered = True
            self._register_comms(self.comms)
        from ..obs.comms import tree_bytes
        it = self.iter - 1
        self.comms.add_h2d(tree_bytes(batch))
        self.comms.tick(it)
        self.stepstats.observe(it, host_s, result=result)

    def close(self):
        """Flush the step and comms summaries; close an owned metrics
        stream."""
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

    # -- checkpointing (npz: the pipelined layout is not a net) ------------
    def snapshot(self, prefix):
        flat = {}
        for ln, blobs in self.params.items():
            for i, b in enumerate(blobs):
                flat[f"p/{ln}@{i}"] = b.detach().cpu().numpy()
        for ln, blobs in self.history.items():
            for i, slots in enumerate(blobs):
                for s, h in enumerate(slots):
                    flat[f"h/{ln}@{i}@{s}"] = h.detach().cpu().numpy()
        path = f"{prefix}_iter_{self.iter}.lm.npz"
        # crash-safe: a relaunch never sees a torn .lm.npz
        from ..resilience.checkpoint import atomic_write_bytes
        atomic_write_bytes(
            path, lambda f: np.savez(f, __iter__=self.iter, **flat))
        self.log(f"Snapshotting to {path}")
        return path

    @torch.no_grad()
    def restore(self, path):
        z = np.load(path)
        self.iter = int(z["__iter__"])
        for k in z.files:
            if k == "__iter__":
                continue
            kind, rest = k.split("/", 1)
            if kind == "p":
                ln, i = rest.rsplit("@", 1)
                ref = self.params[ln][int(i)]
            else:
                ln, i, s = rest.rsplit("@", 2)
                ref = self.history[ln][int(i)][int(s)]
            ref.copy_(torch.from_numpy(np.asarray(z[k])).reshape(ref.shape))
