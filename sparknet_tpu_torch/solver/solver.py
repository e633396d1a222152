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

With ``metrics`` (a utils/metrics.py MetricsLogger) it writes the JAX
Solver's "train" events at display points. ``set_input_transform``
installs a transform that runs on the device before the forward (the
raw-record feed of data/device_transform.py). Not ported (ROADMAP A6): its
"test" events and other observability hooks, chaos, elastic, heartbeat,
watchdog and staleness machinery, remat and scan knobs and debug_info.
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
                 log_fn=print, metrics=None, compute_dtype=None):
        if solver_needs_type_upgrade(solver_param):
            solver_param = upgrade_solver(solver_param)
        self.param = solver_param
        self.log = log_fn or (lambda *a: None)
        self.metrics = metrics
        self.device = resolve_device(device)
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
        return loss

    def step(self, num_iters, data_iter, test_data_fn=None):
        """Run ``num_iters`` steps: pull batches from ``data_iter``,
        display the smoothed loss, run scheduled tests (test_data_fn() ->
        a fresh test batch iterator) and snapshot on the cadence."""
        sp = self.param
        iter_size = int(sp.iter_size)
        t_last, it_last = time.time(), self.iter
        for _ in range(num_iters):
            if sp.test_interval and self.iter % sp.test_interval == 0 and \
                    (self.iter > 0 or sp.test_initialization) and \
                    self.test_net is not None and test_data_fn is not None:
                for k, v in self.test(test_data_fn()).items():
                    self.log(f"    Test net output: {k} = {v}")
                t_last, it_last = time.time(), self.iter
            if iter_size == 1:
                batch = next(data_iter)
            else:
                micros = [next(data_iter) for _ in range(iter_size)]
                batch = {k: np.stack([m[k] for m in micros])
                         for k in micros[0]}
            self._smoothed.append(self.train_step(batch))
            if sp.display and (self.iter - 1) % sp.display == 0:
                sm, lr = self.smoothed_loss(), self.lr_fn(self.iter - 1)
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

    def test(self, data_iter, num_iters=None):
        """Average the TEST net's output blobs over test_iter batches
        (Caffe solver.cpp TestAndStoreResult :414-444)."""
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
        default, or HDF5); returns (model_path, state_path)."""
        from ..resilience import checkpoint
        model_path, state_path = checkpoint.save_snapshot(
            self, prefix or self.param.snapshot_prefix)
        self.log(f"Snapshotting to {model_path}")
        return model_path, state_path

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

    def restore(self, state_path):
        """Resume from a .solverstate (binaryproto) or .solverstate.h5
        and the weights it names (learned_net). A snapshot its manifest
        marks partial or corrupt, or one stamped by another world, is
        refused with the reason."""
        from ..resilience import checkpoint
        checkpoint.check_restorable(state_path,
                                    checkpoint.world_signature(self))
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
