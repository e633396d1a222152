"""NetParameter -> a net over PyTorch tensors: the graph compiler.

The port of sparknet_tpu/graph/compiler.py (Caffe net.cpp: FilterNet
:287, AppendTop/Bottom :385/:444, param ownership & sharing,
ForwardFromTo :565, loss weights):

  * Data layers are feeds (ops/feed.py): ``apply`` takes a ``batch`` dict;
    nothing inside the graph performs IO.
  * In-place ops (ReLU with top == bottom) rebind the blob name.
  * The forward runs eagerly, layer by layer, on the device the net was
    built for, TEST or TRAIN phase; gradients come from autograd
    (``loss_fn`` + ``backward()``). Conv + bias + ReLU (+ cross-channel
    LRN) tails can run as one fused CUDA kernel, forward and backward
    (``_epilogue_plan``, SPARKNET_EPILOGUE).
  * Mixed precision as in the JAX package: params stay f32 masters and
    each layer casts them to its input's dtype, so activations take
    ``compute_dtype`` where they are born from params alone (Embed).
    ``net.compute_dtype`` resolves SPARKNET_PRECISION (``--precision``)
    when the constructor gets None, but the layers get the constructor's
    argument, exactly as the JAX package's do: the variable alone moves
    no layer to bf16.
  * Remat (SPARKNET_REMAT, ``--remat none|dots|full``): in a TRAIN
    forward, runs of layers sharing a ``prefix/`` name run under
    ``torch.utils.checkpoint``, so the backward recomputes them
    (``_remat_groups``, ``apply``).
  * Inception fission (graph/fission.py, SPARKNET_FISSION, on by
    default as in the JAX package on every backend): a channel Concat
    stays a virtual ``Branches``; a group-1 Convolution consuming it runs
    one partial conv per branch and a MAX/AVE Pooling maps over the
    branches. ``apply`` returns a ``LazyBlobs`` that concatenates a
    virtual blob only when a caller reads it.
  * Scan-over-layers (SPARKNET_SCAN / ``--scan``, ``_scan_runs``):
    under ``on`` a chain of structurally identical ``prefix/`` blocks
    runs as the JAX package's lax.scan body runs it (each layer's own
    apply, no fission, no epilogue), and its internal blobs are absent
    from the result; ``auto`` scans only on a TPU there, so here it is
    off.
"""

import functools

import os

import numpy as np
import torch

from ..device import resolve_device
from ..proto.message import Message
from . import fillers as F
from . import fission
from .registry import get as get_layer, V1_TYPE_MAP

# import for registration side effects
from .. import ops as _ops  # noqa: F401

TRAIN, TEST = 0, 1

REMAT_POLICIES = ("none", "dots", "full")


def _env_remat():
    """SPARKNET_REMAT -> policy name ("0"/"1" mean none/full, as in the
    JAX package)."""
    v = os.environ.get("SPARKNET_REMAT", "").lower()
    pol = {"": "none", "0": "none", "none": "none",
           "1": "full", "full": "full", "dots": "dots"}.get(v)
    if pol is None:
        raise ValueError(
            f"SPARKNET_REMAT={v!r}: want none|dots|full (or 0/1)")
    return pol


def _env_precision():
    """SPARKNET_PRECISION -> compute dtype (the ``--precision`` knob):
    "bf16" is torch.bfloat16; "fp32" or unset is None, the full-precision
    path."""
    v = os.environ.get("SPARKNET_PRECISION", "").strip().lower()
    if v in ("bf16", "bfloat16"):
        return torch.bfloat16
    if v in ("", "fp32", "float32", "off"):
        return None
    raise ValueError(f"SPARKNET_PRECISION={v!r}: want bf16|fp32")


def _saved_by_dots():
    """The aten ops whose outputs the "dots" policy saves: matrix
    products and convolutions, what jax.checkpoint_policies.
    checkpoint_dots saves (dot_general and conv_general_dilated)."""
    aten = torch.ops.aten
    return {aten.mm.default, aten.addmm.default, aten.bmm.default,
            aten.baddbmm.default, aten.convolution.default,
            aten._convolution.default}


def _dots_policy(saved, ctx, func, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return CheckpointPolicy.MUST_SAVE if func in saved \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _checkpointed(fn, pol, *args):
    """``fn(*args)`` under torch.utils.checkpoint with the named policy:
    "full" recomputes the whole segment in the backward; "dots" saves
    the matmul and convolution outputs and recomputes the rest (the
    elementwise tails, and the port's CUDA kernels, whose ctypes launch
    no dispatch mode sees: they are always recomputed whole)."""
    from torch.utils.checkpoint import (
        checkpoint, create_selective_checkpoint_contexts)
    if pol == "dots":
        ctx = functools.partial(
            create_selective_checkpoint_contexts,
            functools.partial(_dots_policy, _saved_by_dots()))
        return checkpoint(fn, *args, use_reentrant=False, context_fn=ctx)
    return checkpoint(fn, *args, use_reentrant=False)


def upgrade_v1(net_param):
    """Upgrade legacy V1 'layers' to V2 'layer' entries (the capability of
    Caffe util/upgrade_proto.cpp, re-derived from the schema mapping)."""
    if not net_param.layers:
        return net_param
    out = net_param.copy()
    out.clear("layers")
    for v1 in net_param.layers:
        lp = out.add("layer")
        if v1.has("name"):
            lp.name = v1.name
        if v1.has("type"):
            lp.type = V1_TYPE_MAP[v1.enum_name("type")]
        lp.bottom.extend(v1.bottom)
        lp.top.extend(v1.top)
        lp.loss_weight.extend(v1.loss_weight)
        for r in v1.include:
            lp.include.append(r.copy())
        for r in v1.exclude:
            lp.exclude.append(r.copy())
        for b in v1.blobs:
            lp.blobs.append(b.copy())
        # blobs_lr / weight_decay pairs -> ParamSpecs
        n = max(len(v1.blobs_lr), len(v1.weight_decay))
        for i in range(n):
            ps = lp.add("param")
            if i < len(v1.blobs_lr):
                ps.lr_mult = v1.blobs_lr[i]
            if i < len(v1.weight_decay):
                ps.decay_mult = v1.weight_decay[i]
        for f in ("accuracy_param", "argmax_param", "concat_param",
                  "contrastive_loss_param", "convolution_param", "data_param",
                  "dropout_param", "dummy_data_param", "eltwise_param",
                  "exp_param", "hdf5_data_param", "hdf5_output_param",
                  "hinge_loss_param", "image_data_param",
                  "infogain_loss_param", "inner_product_param", "lrn_param",
                  "memory_data_param", "mvn_param", "pooling_param",
                  "power_param", "relu_param", "sigmoid_param",
                  "softmax_param", "slice_param", "tanh_param",
                  "threshold_param", "window_data_param", "transform_param",
                  "loss_param"):
            if v1.has(f):
                setattr(lp, f, getattr(v1, f).copy())
    return out


def _rule_matches(rule, state):
    """NetStateRule vs NetState (Caffe net.cpp StateMeetsRule)."""
    if rule.has("phase") and rule.phase != state.phase:
        return False
    if rule.has("min_level") and state.level < rule.min_level:
        return False
    if rule.has("max_level") and state.level > rule.max_level:
        return False
    stages = set(state.stage)
    for s in rule.stage:
        if s not in stages:
            return False
    for s in rule.not_stage:
        if s in stages:
            return False
    return True


def filter_net(net_param, phase, level=0, stages=()):
    """Phase/level/stage filtering (Caffe net.cpp FilterNet :287)."""
    state = Message("NetState", phase=phase, level=level, stage=list(stages))
    out = net_param.copy()
    out.clear("layer")
    for lp in net_param.layer:
        inc = lp.include
        exc = lp.exclude
        if inc and exc:
            raise ValueError(f"layer {lp.name}: both include and exclude rules")
        keep = True
        if inc:
            keep = any(_rule_matches(r, state) for r in inc)
        elif exc:
            keep = not any(_rule_matches(r, state) for r in exc)
        if keep and lp.has("phase") and lp.phase != phase:
            keep = False
        if keep:
            out.layer.append(lp.copy())
    return out


def scan_mode():
    """SPARKNET_SCAN: auto (default) | on | off."""
    mode = os.environ.get("SPARKNET_SCAN", "auto").lower()
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"SPARKNET_SCAN={mode!r}: want auto|on|off")
    return mode


def epilogue_mode():
    """SPARKNET_EPILOGUE: auto (default) | on | off."""
    mode = os.environ.get("SPARKNET_EPILOGUE", "auto").lower()
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"SPARKNET_EPILOGUE={mode!r}: want auto|on|off")
    return mode


class CompiledNet:
    """A phase-specific net, built for one device.

    build: shape-infers every blob, instantiates layer impls, and indexes
    params (with cross-layer sharing via ParamSpec.name, Caffe net.cpp
    AppendParam).

      init(generator)                    -> (params, state)
      apply(params, state, batch, train, generator) -> (blobs, new_state)
      loss_fn(params, state, batch, generator)
                                         -> (loss, (blobs, new_state))

    params:  {layer_name: [tensors]}   (owning layers only)
    state:   {layer_name: [tensors]}
    blobs:   {blob_name: tensor} after the full forward

    ``device`` defaults to the card and raises when there is none; pass
    ``device="cpu"`` to run on the CPU (the kernels' plain versions).

    ``compute_dtype`` (e.g. torch.bfloat16) is the activations' dtype
    over f32 params; None keeps them f32. ``net.compute_dtype`` takes
    SPARKNET_PRECISION when the argument is None (so twin nets built
    from it inherit the resolved policy), but the layers get this
    argument and nothing else, so SPARKNET_PRECISION alone leaves a
    net's activations in f32, as the JAX package's layers do.

    ``remat`` (None: SPARKNET_REMAT) is the rematerialization policy of
    a TRAIN forward: "none", "dots" or "full" (Solver.set_remat).
    ``scan`` (None: SPARKNET_SCAN) is the scan-over-layers mode: "auto",
    "on" or "off" (Solver.set_scan).
    """

    def __init__(self, net_param, phase=TEST, feed_shapes=None, level=0,
                 stages=(), device="cuda", compute_dtype=None):
        from .upgrade import upgrade_net
        net_param = upgrade_net(net_param)
        self.phase = phase
        self.dtype = torch.float32     # params (the f32 masters)
        self.compute_dtype = compute_dtype if compute_dtype is not None \
            else _env_precision()
        self.remat = None              # None: SPARKNET_REMAT
        self._remat_cache = None
        self.scan = None               # None: SPARKNET_SCAN
        self._scan_cache = None
        self.device = resolve_device(device)
        self.net_param = filter_net(net_param, phase, level, stages)
        self.name = net_param.name
        feed_shapes = dict(feed_shapes or {})

        self.layers = []          # [(lp, impl, bottoms, tops)]
        self.param_refs = {}      # layer_name -> [(owner_name, idx)]
        self.param_meta = {}      # (owner, idx) -> (shape, filler, lr, decay)
        self.loss_weights = {}    # layer_name -> [w per top]
        shared = {}               # ParamSpec.name -> (owner, idx)
        blob_shapes = {}
        available = {}            # blob name -> producing layer (output tracking)

        # net-level inputs (deploy nets: net.input + input_shape/input_dim)
        self.net_inputs = list(self.net_param.input)
        if self.net_inputs:
            if self.net_param.input_shape:
                in_shapes = [tuple(int(d) for d in s.dim)
                             for s in self.net_param.input_shape]
            else:
                dims = [int(d) for d in self.net_param.input_dim]
                in_shapes = [tuple(dims[i:i + 4])
                             for i in range(0, len(dims), 4)]
            for nm, s in zip(self.net_inputs, in_shapes):
                blob_shapes[nm] = s
                available[nm] = "__input__"

        for lp in self.net_param.layer:
            cls = get_layer(lp.type)
            bottoms = list(lp.bottom)
            tops = list(lp.top)
            for b in bottoms:
                if b not in blob_shapes:
                    raise ValueError(
                        f"layer {lp.name!r}: bottom {b!r} is undefined")
            bshapes = [blob_shapes[b] for b in bottoms]
            if getattr(cls, "is_feed", False):
                impl = cls(lp, bshapes, phase, feed_shapes=feed_shapes)
            else:
                impl = cls(lp, bshapes, phase)
            impl.compute_dtype = compute_dtype
            impl.device = self.device
            tshapes = impl.out_shapes()
            if len(tops) < len(tshapes) and impl.loss_like:
                # Caffe auto-top (net.cpp AppendTop): a LOSS layer may
                # declare fewer tops than it produces
                auto = [lp.name if len(tshapes) - len(tops) == 1
                        else f"{lp.name}_top{i}"
                        for i in range(len(tops), len(tshapes))]
                tops = tops + auto
                lp.top.extend(auto)
            if len(tshapes) != len(tops):
                raise ValueError(
                    f"layer {lp.name!r} ({lp.type}): {len(tops)} tops declared "
                    f"but impl produces {len(tshapes)}")
            for b in bottoms:
                available.pop(b, None)
            for t, s in zip(tops, tshapes):
                blob_shapes[t] = tuple(s)
                available[t] = lp.name
            self.layers.append((lp, impl, bottoms, tops))

            # params (with sharing)
            refs = []
            for i, (shape, filler, lr_mult, decay_mult) in enumerate(
                    impl.param_shapes()):
                pname = lp.param[i].name if i < len(lp.param) and \
                    lp.param[i].has("name") else ""
                if pname and pname in shared:
                    owner = shared[pname]
                    oshape = self.param_meta[owner][0]
                    if int(np.prod(oshape)) != int(np.prod(shape)):
                        raise ValueError(
                            f"shared param {pname!r}: count mismatch")
                    refs.append(owner)
                else:
                    key = (lp.name, i)
                    self.param_meta[key] = (tuple(shape), filler,
                                            float(lr_mult), float(decay_mult))
                    if pname:
                        shared[pname] = key
                    refs.append(key)
            self.param_refs[lp.name] = refs

            # loss weights (Caffe layer.hpp SetLossWeights: *Loss layers
            # default top[0] weight to 1)
            ws = list(lp.loss_weight)
            if not ws:
                ws = [1.0] + [0.0] * (len(tops) - 1) if impl.loss_like \
                    else [0.0] * len(tops)
            elif len(ws) != len(tops):
                raise ValueError(f"layer {lp.name}: loss_weight count mismatch")
            self.loss_weights[lp.name] = ws

        self.blob_shapes = blob_shapes
        # net outputs: produced and never consumed (net.cpp:270-284)
        self.output_blobs = [b for b, l in available.items()
                             if l != "__input__"]
        self._epilogue_cache = None

    # -- feeds -------------------------------------------------------------
    def feed_blobs(self):
        """Blob names the batch dict must provide."""
        names = list(self.net_inputs)
        for lp, impl, bottoms, tops in self.layers:
            if getattr(impl, "is_feed", False):
                names.extend(tops)
        return names

    def feed_shapes(self):
        return {n: self.blob_shapes[n] for n in self.feed_blobs()}

    # -- init --------------------------------------------------------------
    def init(self, generator=None):
        """Fresh params from the layers' fillers, drawn in sorted
        (layer, index) order from ``generator`` (a CPU torch.Generator;
        None means one seeded with 0), then moved to the net's device."""
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        fresh = {key: F.fill(gen, meta[0], meta[1], self.dtype)
                 for key, meta in sorted(self.param_meta.items())}
        params, state = {}, {}
        for lp, impl, bottoms, tops in self.layers:
            owned = [k for k in self.param_refs[lp.name] if k[0] == lp.name]
            if owned:
                params[lp.name] = [fresh[k].to(self.device) for k in owned]
            ss = impl.state_shapes()
            if ss:
                state[lp.name] = [torch.full(shape, val, dtype=self.dtype,
                                             device=self.device)
                                  for shape, val in ss]
        # pretrained blobs embedded in the prototxt (LayerParameter.blobs)
        for lp, impl, bottoms, tops in self.layers:
            if lp.blobs and lp.name in params:
                for i, bp in enumerate(lp.blobs):
                    if i < len(params[lp.name]):
                        params[lp.name][i] = self._tensor(
                            blob_to_array(bp), params[lp.name][i].shape)
        return params, state

    def _tensor(self, arr, shape):
        return torch.from_numpy(np.array(arr, np.float32).reshape(
            tuple(shape))).to(self.device, self.dtype)

    def resolve_params(self, params, layer_name):
        return [params[owner][idx]
                for owner, idx in self.param_refs[layer_name]]

    # -- forward -----------------------------------------------------------
    def _epilogue_plan(self):
        """Fusable conv-epilogue sites, cached: {conv_idx: (relu_idx,
        lrn_idx | None)}.

        A site is Convolution (bias_term, single top) immediately
        followed by a zero-slope in-place ReLU on the same blob — the
        zoo/prototxt idiom — optionally followed by an adjacent 4D
        ACROSS_CHANNELS LRN reading that blob. The LRN extension only
        qualifies when nothing ELSE reads the relu'd blob (no later
        consumer, no loss weight, not a net output): the fused kernel
        never materializes it — absent, never stale."""
        if self._epilogue_cache is not None:
            return self._epilogue_cache
        plan = {}
        nl = len(self.layers)
        for ci in range(nl - 1):
            lp, impl, bottoms, tops = self.layers[ci]
            if getattr(impl, "type_name", None) != "Convolution" \
                    or not impl.bias_term or len(tops) != 1 \
                    or any(self.loss_weights[lp.name]):
                continue
            top = tops[0]
            rlp, rimpl, rbot, rtop = self.layers[ci + 1]
            if getattr(rimpl, "type_name", None) != "ReLU" \
                    or rbot != [top] or rtop != [top] \
                    or any(self.loss_weights[rlp.name]):
                continue
            if rlp.has("relu_param") and rlp.relu_param.negative_slope:
                continue
            plan[ci] = (ci + 1, None)
            if ci + 2 >= nl or len(self.blob_shapes[top]) != 4:
                continue
            llp, limpl, lbot, ltop = self.layers[ci + 2]
            if getattr(limpl, "type_name", None) != "LRN" or limpl.within \
                    or lbot != [top]:
                continue
            later = sum(b == top for lj in range(ci + 3, nl)
                        for b in self.layers[lj][2])
            if later == 0 and top not in self.output_blobs:
                plan[ci] = (ci + 1, ci + 2)
        self._epilogue_cache = plan
        return plan

    def _active_epilogue(self):
        """The epilogue sites the SPARKNET_EPILOGUE policy enables for
        this forward: off — none; auto — only the 3-op bias+ReLU+LRN
        fusion, and only on the card; on — every site, any device (the
        CPU runs the kernels' plain versions: tests)."""
        mode = epilogue_mode()
        if mode == "off":
            return {}
        plan = self._epilogue_plan()
        if mode == "on":
            return plan
        if self.device.type != "cuda":
            return {}
        return {ci: v for ci, v in plan.items() if v[1] is not None}

    def _feed(self, value):
        if isinstance(value, np.ndarray):
            value = torch.from_numpy(value)
        return torch.as_tensor(value).to(self.device)

    def _layer_generators(self, generator):
        """One torch.Generator per rng-consuming layer for this forward,
        all derived from a single draw of ``generator`` (a CPU generator;
        None means one seeded with 0): the stand-in for the JAX package's
        fold_in(rng, layer_index)."""
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        base = int(torch.randint(0, 2 ** 62, (), generator=gen))
        out = {}
        for li, (lp, impl, bottoms, tops) in enumerate(self.layers):
            if impl.needs_rng:
                g = torch.Generator(device=self.device)
                g.manual_seed((base ^ (li * 0x9E3779B97F4A7C15)) % 2 ** 63)
                out[li] = g
        return out

    def _remat_groups(self):
        """Rematerialization segments {start: end}: maximal runs of >= 2
        consecutive layers sharing a name prefix before "/" (the zoo's
        "block{i}/..." convention; GoogLeNet's "conv2/...", "pool5/..."),
        the JAX package's grouping exactly. Cached."""
        if self._remat_cache is not None:
            return self._remat_cache
        groups = {}
        start = prefix = None
        for li, (lp, impl, bottoms, tops) in enumerate(self.layers):
            p = lp.name.split("/")[0] if "/" in lp.name else None
            if p != prefix:
                if prefix is not None and li - start >= 2:
                    groups[start] = li
                start, prefix = li, p
        if prefix is not None and len(self.layers) - start >= 2:
            groups[start] = len(self.layers)
        self._remat_cache = groups
        return groups

    def _segment_externals(self, lo, hi):
        """Blob names a [lo, hi) segment must surface: consumed by later
        layers, carrying loss weight, or net outputs."""
        produced = set()
        for li in range(lo, hi):
            produced.update(self.layers[li][3])
        needed = set()
        for li in range(hi, len(self.layers)):
            needed.update(self.layers[li][2])
        for li in range(lo, hi):
            lp = self.layers[li][0]
            for t, w in zip(self.layers[li][3], self.loss_weights[lp.name]):
                if w:
                    needed.add(t)
        needed.update(self.output_blobs)
        return sorted(produced & needed)

    def _apply_range(self, params, state, new_state, blobs, lo, hi, batch,
                     train, rngs, ep, fiss=False):
        """Run layers [lo, hi) over the mutable blob dict (the body a
        remat segment replays). ``ep``: the active epilogue sites; a site
        fuses only when its whole conv/ReLU(/LRN) window lies inside
        [lo, hi), else its layers run unfused (right either way).
        ``fiss``: dispatch through fission.try_apply first."""
        from ..ops import cuda_epilogue as ce
        skip = set()
        for li in range(lo, hi):
            if li in skip:
                continue
            lp, impl, bottoms, tops = self.layers[li]
            if getattr(impl, "is_feed", False):
                for t in tops:
                    blobs[t] = self._feed(batch[t])
                continue
            lparams = self.resolve_params(params, lp.name)
            bvals = [blobs[b] for b in bottoms]
            fuse = ep.get(li)
            if fuse is not None and max(x for x in fuse
                                        if x is not None) < hi:
                ri, lrni = fuse
                bvals = [fission.materialize(v) for v in bvals]
                y = impl.apply_raw(lparams, bvals, train)
                skip.add(ri)
                if lrni is None:
                    # ReLU is the in-place rebind: the fused output IS
                    # the conv/relu blob
                    blobs[tops[0]] = ce.bias_relu(y, lparams[1])
                else:
                    lm = self.layers[lrni][1]
                    blobs[self.layers[lrni][3][0]] = ce.bias_relu_lrn(
                        y, lparams[1], lm.size, lm.alpha, lm.beta, lm.k)
                    skip.add(lrni)
                    # the relu'd pre-LRN blob is never materialized;
                    # absent, never stale (the plan proved no consumer)
                    blobs.pop(tops[0], None)
                continue
            tvals = fission.try_apply(lp, impl, lparams, bvals, train) \
                if fiss else None
            if tvals is None:
                # the normal path; a virtual concat bottom materializes
                bvals = [fission.materialize(v) for v in bvals]
                if impl.has_state:
                    tvals, new_state[lp.name] = impl.apply_stateful(
                        lparams, state[lp.name], bvals, train)
                elif impl.needs_rng:
                    tvals = impl.apply(lparams, bvals, train, rngs.get(li))
                else:
                    tvals = impl.apply(lparams, bvals, train)
            for t, v in zip(tops, tvals):
                blobs[t] = v

    def _apply_segment(self, params, state, new_state, blobs, lo, hi,
                       batch, train, rngs, ep, pol, fiss):
        """Layers [lo, hi) under torch.utils.checkpoint with policy
        ``pol``. Each rng-consuming layer of the segment draws from its
        own torch.Generator, which the checkpoint's RNG stash (the global
        CPU/CUDA states) does not cover: their states are taken before
        the segment and set again at the start of every run of it, so
        the recompute draws the forward's masks. Net-state updates come
        from the forward's outputs only, never the recompute's. A virtual
        concat crosses the segment's boundary as its branches
        (fission.spread)."""
        in_names = sorted({b for j in range(lo, hi)
                           for b in self.layers[j][2] if b in blobs})
        out_names = self._segment_externals(lo, hi)
        seg_states = sorted({self.layers[j][0].name for j in range(lo, hi)
                             if self.layers[j][1].has_state})
        gens = {j: rngs[j] for j in range(lo, hi) if j in rngs}
        gen_states = {j: g.get_state() for j, g in gens.items()}
        in_flat, in_parts = fission.spread([blobs[n] for n in in_names])
        out_parts = []          # set by the forward's run of seg_fn

        def seg_fn(*flat):
            for j, g in gens.items():
                g.set_state(gen_states[j])
            sblobs = dict(zip(in_names, fission.gather(flat, in_parts)))
            sstate = {}
            self._apply_range(params, state, sstate, sblobs, lo, hi, batch,
                              train, rngs, ep, fiss)
            outs, out_parts[:] = fission.spread([sblobs[n]
                                                 for n in out_names])
            return tuple(outs) + tuple(t for n in seg_states
                                       for t in sstate[n])

        outs = _checkpointed(seg_fn, pol, *in_flat)
        k = sum(max(c, 1) for c in out_parts)
        # a blob produced before the segment and overwritten in place
        # inside it (top == bottom across the boundary) must not survive
        # with its pre-segment value: internal blobs are absent, never
        # stale
        produced = {t for j in range(lo, hi) for t in self.layers[j][3]}
        for n in produced.difference(out_names):
            blobs.pop(n, None)
        for n, v in zip(out_names, fission.gather(outs[:k], out_parts)):
            blobs[n] = v
        for n in seg_states:
            m = len(state[n])
            new_state[n] = list(outs[k:k + m])
            k += m

    def _scan_runs(self):
        """Scan-over-layers sites, cached: maximal runs of >= 2
        consecutive structurally identical "prefix/" layer groups (the
        zoo's "block{i}/..." convention), each chained through a single
        boundary blob — the JAX package's rule exactly.

        Two groups are identical when every corresponding layer matches
        on type, name suffix, prefix-stripped bottoms/tops, top blob
        shapes and owned param shapes, and is stateless, rng-free,
        loss-free, feed-free, with no cross-layer param sharing.
        Chaining requires group i's one external input to be group i-1's
        one externally consumed top, read by nothing else.

        Returns [{lo, hi, glen, n, entry, body_out, out}]: layer range,
        group length and count, group 0's external input blob, group 0's
        boundary top (the carry) and the last group's boundary blob."""
        if self._scan_cache is not None:
            return self._scan_cache
        pgroups = []                       # (prefix, lo, hi)
        prefix, start = None, 0
        for li, (lp, _, _, _) in enumerate(self.layers):
            p = lp.name.split("/")[0] if "/" in lp.name else None
            if p != prefix:
                if prefix is not None:
                    pgroups.append((prefix, start, li))
                prefix, start = p, li
        if prefix is not None:
            pgroups.append((prefix, start, len(self.layers)))
        nl = len(self.layers)

        def group_info(gi):
            """(signature, entry, boundary) or None if ineligible."""
            pfx, lo, hi = pgroups[gi]
            produced, sig, externals = set(), [], set()
            strip = len(pfx) + 1
            for li in range(lo, hi):
                lp, impl, bottoms, tops = self.layers[li]
                if getattr(impl, "is_feed", False) or impl.has_state \
                        or impl.needs_rng \
                        or any(self.loss_weights[lp.name]):
                    return None
                if any(owner != lp.name
                       for owner, _ in self.param_refs[lp.name]):
                    return None
                bsig = []
                for b in bottoms:
                    if b in produced:
                        bsig.append(b[strip:] if b.startswith(pfx + "/")
                                    else b)
                    else:
                        externals.add(b)
                        bsig.append("\x00ENTRY")
                pshapes = tuple((self.param_meta[k][0],)
                                for k in self.param_refs[lp.name])
                sig.append((lp.type, lp.name[strip:], tuple(bsig),
                            tuple(t[strip:] if t.startswith(pfx + "/")
                                  else "\x00T:" + t for t in tops),
                            tuple(tuple(self.blob_shapes[t]) for t in tops),
                            pshapes))
                produced.update(tops)
            if len(externals) != 1:
                return None
            out = {t for li in range(lo, hi) for t in self.layers[li][3]
                   if t in self.output_blobs
                   or any(t in self.layers[lj][2] for lj in range(hi, nl))}
            if len(out) != 1:
                return None
            return tuple(sig), next(iter(externals)), next(iter(out))

        infos = [group_info(gi) for gi in range(len(pgroups))]

        def chains(a, b):
            """Group b continues group a: same structure, b's input is
            a's boundary, and that blob is read by b alone."""
            ia, ib = infos[a], infos[b]
            if ia is None or ib is None or ia[0] != ib[0]:
                return False
            if pgroups[a][2] != pgroups[b][1]:     # must be adjacent
                return False
            if ib[1] != ia[2] or ia[2] in self.output_blobs:
                return False
            bhi = pgroups[b][2]
            return not any(ia[2] in self.layers[lj][2]
                           for lj in range(bhi, nl))

        runs, gi = [], 0
        while gi < len(pgroups):
            gj = gi
            while gj + 1 < len(pgroups) and chains(gj, gj + 1):
                gj += 1
            if gj > gi:
                lo, hi = pgroups[gi][1], pgroups[gj][2]
                runs.append({"lo": lo, "hi": hi,
                             "glen": pgroups[gi][2] - pgroups[gi][1],
                             "n": gj - gi + 1,
                             "entry": infos[gi][1],
                             "body_out": infos[gi][2],
                             "out": infos[gj][2]})
            gi = gj + 1
        self._scan_cache = runs
        return runs

    def _scan_enabled(self):
        """The scan policy (``self.scan``, else SPARKNET_SCAN): on scans
        everywhere; auto scans only on a TPU in the JAX package (XLA:CPU
        pessimizes loop bodies), so it is off here, as is off."""
        mode = self.scan if self.scan is not None else scan_mode()
        if mode not in ("auto", "on", "off"):
            raise ValueError(f"scan={mode!r}: want auto|on|off")
        return mode == "on"

    def _apply_scan(self, run, params, state, new_state, blobs, batch,
                    train, rngs, groups, pol):
        """Execute one scan run: its layers through the normal path, each
        block a remat segment under remat, as the JAX package's lax.scan
        body calls them: the entry blob materialized, then every layer's
        own apply, with neither fission nor the epilogue. Then every blob
        the run made but its last boundary blob is dropped
        (``scan_dropped``): absent, as in the JAX package."""
        lo, hi = run["lo"], run["hi"]
        blobs[run["entry"]] = fission.materialize(blobs[run["entry"]])
        li = lo
        while li < hi:
            end = groups.get(li)
            if end is None:
                self._apply_range(params, state, new_state, blobs, li,
                                  li + 1, batch, train, rngs, {})
                li += 1
            else:
                self._apply_segment(params, state, new_state, blobs, li,
                                    end, batch, train, rngs, {}, pol, False)
                li = end
        for n in self.scan_dropped(run):
            blobs.pop(n, None)

    def scan_dropped(self, run):
        """The blobs a scan run leaves absent: all it produces but its
        last boundary blob."""
        return {t for j in range(run["lo"], run["hi"])
                for t in self.layers[j][3]} - {run["out"]}

    def apply(self, params, state, batch, train=None, generator=None):
        """Run the forward. TEST-phase callers wrap it in
        ``torch.inference_mode()``; a TRAIN-phase forward records the
        autograd graph (``train`` defaults to the net's phase).
        ``generator`` seeds the per-layer randomness (TRAIN dropout).

        Four policies, each read once per call, shape what comes back:
        * remat (``self.remat``, else SPARKNET_REMAT: none|dots|full):
          with train=True each ``_remat_groups`` segment runs under
          torch.utils.checkpoint (``_apply_segment``); its internal
          blobs are absent from the returned dict (only its boundary
          blobs, loss tops and net outputs survive). A TEST forward
          runs no remat.
        * scan (``self.scan``, else SPARKNET_SCAN: auto|on|off): each
          ``_scan_runs`` chain runs through ``_apply_scan``; its
          block-internal blobs are absent, and remat checkpoints each
          block as a segment.
        * fission (SPARKNET_FISSION, on by default): channel concats
          stay virtual inside the forward; the returned LazyBlobs
          concatenates one when a caller reads it.
        * epilogue (SPARKNET_EPILOGUE): a fused bias+ReLU+LRN site
          leaves its pre-LRN blob absent (never stale).
        Keep remat, scan and the epilogue off to inspect every blob."""
        if train is None:
            train = self.phase == TRAIN
        pol = (self.remat if self.remat is not None else _env_remat()) \
            if train else "none"
        if pol not in REMAT_POLICIES:
            raise ValueError(f"remat={pol!r}: want none|dots|full")
        fiss = fission.enabled()
        groups = self._remat_groups() if pol != "none" else {}
        scans = {r["lo"]: r for r in self._scan_runs()} \
            if self._scan_enabled() else {}
        ep = self._active_epilogue()
        rngs = self._layer_generators(generator) if train else {}
        blobs = {n: self._feed(batch[n]) for n in self.net_inputs}
        new_state = dict(state)
        li = 0
        while li < len(self.layers):
            run = scans.get(li)
            if run is not None:
                self._apply_scan(run, params, state, new_state, blobs,
                                 batch, train, rngs, groups, pol)
                li = run["hi"]
                continue
            hi = groups.get(li)
            if hi is not None:
                self._apply_segment(params, state, new_state, blobs, li, hi,
                                    batch, train, rngs, ep, pol, fiss)
                li = hi
                continue
            # a fusion site outside any segment runs its whole window in
            # one range so the fused branch engages; a window a segment
            # or a scan run starts inside runs unfused
            end = li + 1
            fuse = ep.get(li)
            if fuse is not None:
                w_end = max(x for x in fuse if x is not None) + 1
                if all(j not in groups and j not in scans
                       for j in range(li + 1, w_end)):
                    end = w_end
            self._apply_range(params, state, new_state, blobs, li, end,
                              batch, train, rngs, ep, fiss)
            li = end
        return fission.LazyBlobs(blobs), new_state

    def total_loss(self, blobs):
        """Weighted sum of the loss tops, in f32 (Caffe net.cpp
        ForwardFromTo's loss accumulation via loss_weight)."""
        total = None
        for lp, impl, bottoms, tops in self.layers:
            for t, w in zip(tops, self.loss_weights[lp.name]):
                if w:
                    term = w * blobs[t].sum().float()
                    total = term if total is None else total + term
        if total is None:
            return torch.zeros((), dtype=torch.float32, device=self.device)
        return total

    def loss_fn(self, params, state, batch, generator=None):
        blobs, new_state = self.apply(params, state, batch,
                                      generator=generator)
        return self.total_loss(blobs), (blobs, new_state)

    # -- weight io ---------------------------------------------------------
    def params_to_netproto(self, params, state=None):
        """Emit a NetParameter with blobs filled — .caffemodel-compatible
        (Caffe net.cpp ToProto :911)."""
        out = Message("NetParameter", name=self.name or "net")
        for lp, impl, bottoms, tops in self.layers:
            olp = lp.copy()
            olp.clear("blobs")
            merged = []
            if lp.name in params:
                merged += list(params[lp.name])
            if state and lp.name in state:
                merged += list(state[lp.name])
            for t in merged:
                olp.blobs.append(array_to_blob(
                    t.detach().to("cpu", torch.float32).numpy()))
            out.layer.append(olp)
        return out

    def load_netproto(self, net_proto, params, state=None, strict=False):
        """Copy weights from a NetParameter by layer name (Caffe net.cpp
        CopyTrainedLayersFrom :805): sizes must match; layers absent from
        either side are skipped unless strict."""
        from .upgrade import upgrade_net
        net_proto = upgrade_net(net_proto)
        by_name = {l.name: l for l in net_proto.layer}
        params = {k: list(v) for k, v in params.items()}
        state = {k: list(v) for k, v in (state or {}).items()}
        for lp, impl, bottoms, tops in self.layers:
            src = by_name.get(lp.name)
            if src is None or not src.blobs:
                if strict and lp.name in params:
                    raise ValueError(f"no weights for layer {lp.name!r}")
                continue
            tgt = list(params.get(lp.name, []))
            n_p = len(tgt)
            for i, bp in enumerate(src.blobs):
                arr = blob_to_array(bp)
                if i < n_p:
                    if arr.size != tgt[i].numel():
                        raise ValueError(
                            f"layer {lp.name!r} blob {i}: size mismatch "
                            f"{arr.shape} vs {tuple(tgt[i].shape)}")
                    tgt[i] = self._tensor(arr, tgt[i].shape)
                elif lp.name in state and i - n_p < len(state[lp.name]):
                    j = i - n_p
                    state[lp.name][j] = self._tensor(
                        arr, state[lp.name][j].shape)
            if tgt:
                params[lp.name] = tgt
        return params, state


def blob_to_array(bp):
    if bp.has("shape"):
        shape = [int(d) for d in bp.shape.dim]
    else:
        shape = [d for d in (bp.num, bp.channels, bp.height, bp.width)]
    data = bp.double_data if len(bp.double_data) else bp.data
    # no intermediate list(): the wire codec hands packed floats back as a
    # numpy array — a 230MB CaffeNet import must not pay a per-element copy
    arr = np.asarray(data, np.float32)
    if shape and int(np.prod(shape)) == arr.size:
        arr = arr.reshape(shape)
    return arr


def array_to_blob(arr):
    bp = Message("BlobProto")
    bp.ensure("shape").dim.extend(int(d) for d in arr.shape)
    bp.data.extend_np(np.asarray(arr, np.float32).ravel())
    return bp
