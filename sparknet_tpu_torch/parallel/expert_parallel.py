"""dp x ep: data parallelism composed with expert parallelism (the port of
sparknet_tpu/parallel/expert_parallel.py).

The MoE runner: the batch dim split over the whole ("data", "expert")
grid, so tokens arrive split along the expert axis and the MoE layer's
exchange (ops/moe.py ``apply_slots``) splits the expert compute ep-fold;
each MoE layer's expert-major blobs (w1/b1/w2/b2, dim 0 = num_experts)
are split over the "expert" slots, each slot holding and updating only
its own experts' rows (the history too). The router and every other blob
stay replicated: every token computes all num_experts logits before
dispatch. Capacity is each slot's own (ops/moe.py), so under overflow
this solver is held to the JAX ExpertParallelSolver, not to the
single-device MoE.

Gradients: every slot's loss is the mean over its 1/(dp*ep) token
slice and the step takes the mean of the slots' losses. A replicated
blob's gradient is then the mean over all slots of theirs (the JAX
solver's pmean over both axes), and an expert blob's is the sum of what
every source slot's tokens sent it through the exchange, over dp*ep (the
JAX solver's pmean over "data" divided by ep): the global-batch gradient
either way. The Switch aux loss is each slot's own routing statistics,
averaged, as in the JAX solver.

``seq_axis`` composes a third axis: dp x sp x ep, the sequence dim split
over "seq" (ring attention and positional offsets, as under
SeqParallelSolver), the expert exchange over "expert" within each (data,
seq) row.
"""

from ..obs.comms import all_to_all_bytes, ring_allreduce_bytes, tree_bytes
from .data_parallel import check_seq_shardable_losses
from .lockstep import MeshSolver
from .mesh import DATA_AXIS, EXPERT_AXIS, make_mesh, slot_rows


class ExpertParallelSolver(MeshSolver):
    """Solver over ("data", ["seq",] "expert") slots: the batch split
    over data x expert, MoE expert blobs split over expert, everything
    else replicated."""

    # MoE param blob order: router, w1, b1, w2, b2 (ops/moe.py
    # param_shapes); blob 0 (the router) is replicated, 1-4 expert-split
    _EXPERT_SLOTS = (1, 2, 3, 4)

    def __init__(self, solver_param, mesh=None, data_axis=DATA_AXIS,
                 expert_axis=EXPERT_AXIS, seq_axis=None, **kw):
        mesh = mesh if mesh is not None else \
            make_mesh({data_axis: 1, expert_axis: -1})
        self.data_axis, self.expert_axis = data_axis, expert_axis
        self.seq_axis = seq_axis
        self.batch_axes = (data_axis, expert_axis)
        super().__init__(solver_param, mesh, **kw)
        if seq_axis:
            check_seq_shardable_losses(self.net, "ExpertParallelSolver")
        self.ep = ep = mesh.shape[expert_axis]
        self._expert_layers = set()
        for lp, impl, _, _ in self.net.layers:
            if lp.type == "MoE" and getattr(impl, "expert_parallel", False):
                if ep > 1 and impl.num_experts % ep:
                    raise ValueError(
                        f"{lp.name}: num_experts {impl.num_experts} not "
                        f"divisible by expert axis size {ep}")
                self._expert_layers.add(lp.name)

    def _axes(self):
        axes = {"data": self.data_axis, "expert": self.expert_axis}
        if self.seq_axis:
            axes["seq"] = self.seq_axis
        return axes

    def _slot_params(self):
        out = []
        for w in range(self.mesh.size):
            e = self.mesh.axis_index(w, self.expert_axis)
            tree = dict(self.params)
            for ln in self._expert_layers:
                blobs = list(self.params[ln])
                for i in self._EXPERT_SLOTS:
                    lo, hi = slot_rows(blobs[i].shape[0], self.ep, e)
                    blobs[i] = blobs[i][lo:hi]
                tree[ln] = blobs
            out.append(tree)
        return out

    def _register_comms(self, cm):
        """Replicated params pmean over every axis, expert blobs over the
        non-expert axes, and the MoE dispatch/combine all_to_all pairs
        over the expert axis (forward and backward)."""
        super()._register_comms(cm)
        ep = self.ep
        n_other = max(1, self.mesh.size // ep)
        eb = rb = 0
        for ln, blobs in self.params.items():
            for i, b in enumerate(blobs):
                nb = b.numel() * b.element_size()
                if ln in self._expert_layers and i in self._EXPERT_SLOTS:
                    eb += nb
                else:
                    rb += nb
        rb += tree_bytes(self.state)
        cm.set_topology(axes=dict(self.mesh.shape))
        cm.register("allreduce_dense",
                    ring_allreduce_bytes(rb, self.mesh.size), axis="all",
                    note="replicated-param grads + state pmean per step")
        if eb:
            cm.register("allreduce_expert", ring_allreduce_bytes(eb, n_other),
                        axis=self.data_axis,
                        note="expert-sharded grads pmean over non-expert "
                             "axes (global expert bytes)")
        itemsize = 2 if self.net.compute_dtype is not None else 4
        a2a = 0
        for lp, impl, bottoms, _ in self.local_net.layers:
            if lp.name in self._expert_layers:
                act = 1
                for d in self.local_net.blob_shapes[bottoms[0]]:
                    act *= int(d)
                a2a += 4 * all_to_all_bytes(act * itemsize, ep)
        if a2a:
            cm.register("moe_all_to_all", a2a, axis=self.expert_axis,
                        note="token dispatch/combine fwd+bwd per step "
                             "(analytic, from local activation shapes)")
