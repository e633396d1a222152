"""dp x sp: data parallelism composed with sequence parallelism (the port
of sparknet_tpu/parallel/seq_parallel.py).

The long-context runner: the batch dim split over the "data" slots, the
sequence dim over the "seq" slots. Under the published "seq" axis the
net's sequence-aware layers take their part: Attention(ring=True) runs
ring attention across the seq slots (parallel/ring.py),
PositionalEmbed adds its shard's global positions, and
SoftmaxWithLoss's per-token mean distributes exactly over equal shards,
so the mean of the slots' losses is the single-device loss on the global
batch, and its gradient the one the JAX solver's pmean over seq, then
data, gives. The params are replicated: one tensor read by every slot.

The ring couples the slots inside every attention layer, so the step
runs the layers in lock step (parallel/lockstep.py) and the whole
step's activations live at once: unlike DataParallelSolver's slot after
slot backward, memory grows with the slot count. ``--remat full``
checkpoints each block over all slots.
"""

from ..obs.comms import ring_allreduce_bytes, tree_bytes
from .data_parallel import check_seq_shardable_losses
from .lockstep import MeshSolver
from .mesh import DATA_AXIS, SEQ_AXIS, make_mesh
from .ring import ring_attention_comm_bytes


class SeqParallelSolver(MeshSolver):
    """Solver whose step runs over ("data", "seq") slots: batch dim 0
    split over data, dim 1 (the sequence) over seq; params, state and
    history replicated; the slots' losses averaged."""

    def __init__(self, solver_param, mesh=None, data_axis=DATA_AXIS,
                 seq_axis=SEQ_AXIS, **kw):
        mesh = mesh if mesh is not None else \
            make_mesh({data_axis: 1, seq_axis: -1})
        self.data_axis, self.seq_axis = data_axis, seq_axis
        self.batch_axes = (data_axis,)
        super().__init__(solver_param, mesh, **kw)
        check_seq_shardable_losses(self.net, "SeqParallelSolver")

    def _axes(self):
        return {"data": self.data_axis, "seq": self.seq_axis}

    def _register_comms(self, cm):
        """The grads/state pmean over both axes (one ring over the whole
        mesh), and ring attention's K/V rotation, forward and backward."""
        super()._register_comms(cm)
        gb = tree_bytes(self.params) + tree_bytes(self.state)
        sp = self.mesh.shape[self.seq_axis]
        cm.set_topology(axes=dict(self.mesh.shape))
        cm.register("allreduce_grads",
                    ring_allreduce_bytes(gb, self.mesh.size),
                    axis=f"{self.data_axis}x{self.seq_axis}",
                    note="pmean(grads)+pmean(state) per step")
        if sp > 1:
            itemsize = 2 if self.net.compute_dtype is not None else 4
            ring_b = 0
            for lp, impl, bottoms, _ in self.local_net.layers:
                if getattr(impl, "ring", False):
                    b, s_local = self.local_net.blob_shapes[bottoms[0]][:2]
                    ring_b += ring_attention_comm_bytes(
                        (b, s_local, getattr(impl, "inner", 0)), sp,
                        itemsize=itemsize)
            if ring_b:
                cm.register("ring_attention_ppermute", 2 * ring_b,
                            axis=self.seq_axis,
                            note="K/V block rotation, fwd+bwd, per chip "
                                 "(analytic, from local activation "
                                 "shapes)")
