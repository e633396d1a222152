"""Switch-style mixture-of-experts FFN on one device (the port of
sparknet_tpu/ops/moe.py).

A sparknet_tpu extension with no Caffe twin. Routing is top-1 (Switch
Transformer): each token goes to the expert of its largest router gate
(``torch.argmax`` takes the first of equal maxima, as ``jnp.argmax``
does); an expert accepts at most C = ceil(tokens / num_experts *
capacity_factor) tokens, the earlier tokens first, and the overflow
tokens pass through as zeros (the residual around the layer carries
them). Tops: [output], [output, aux] or [output, aux, stats]; aux is the
load-balancing loss num_experts * sum_e fraction_e * mean_gate_e (give
it a loss_weight), stats is [fraction_0 .. fraction_{X-1}, overflow
fraction] without gradient.

Dispatch and combine are sort-based, as in the JAX layer: a stable sort
of the tokens by expert, ``searchsorted`` for each expert's first slot,
the overflow sent to a trash row past the (X*C, E) buffer, which is then
dropped. No (n, X, C) one-hot mask is built. Both directions are writes
(``index_put``): the dispatch writes each token to its slot and the
combine each slot's output to its token, so only a trash row (the
dispatch's, and the combine's row n for the empty slots) sees duplicate
indices, no atomic add lands anywhere, each backward is a gather, and
the dropped tokens' gradient is exactly zero. The expert FFN
(relu(x W1 + b1) W2 + b2) runs in float32 whatever the activations'
dtype, and the output is cast back.

Expert parallelism: with ``expert_parallel: true`` under an "expert"
axis (parallel/context.py, published by parallel/expert_parallel.py)
the layer needs every expert slot at once (``slot_coupled``), and
``apply_slots`` runs the JAX layer's exchange over the slots: each slot
routes its own tokens with the capacity of its own token count (the
JAX layer's per-source-device rule: under overflow the drop order is
each slot's arrival order), one all_to_all sends each expert's
(X, C, E) dispatch rows to the slot that owns the expert, the slot runs
its X/ep experts over the ep*C gathered rows with its shard of the
expert weights, and a second all_to_all returns the outputs to their
source slots. Without the axis ``expert_parallel`` computes the same
thing as the plain layer.

Weight blobs, expert-major as in the JAX layer: router (X, E) | w1 (X, F,
E) | b1 (X, F) | w2 (X, E, F) | b2 (X, E); unless the layer names a
weight filler, the weights fill uniform in +-sqrt(3 / fan_in) with the
fan-in of each expert's own product (E, or F for w2).
"""

import math

import torch

from ..graph.registry import Layer, register
from ..proto import Message
from .convolution import _param_mults


@register
class MoE(Layer):
    type_name = "MoE"

    def __init__(self, lp, bottom_shapes, phase):
        super().__init__(lp, bottom_shapes, phase)
        p = lp.moe_param
        self.p = p
        b, s, e = bottom_shapes[0]
        self.embed = int(e)
        self.num_experts = int(p.num_experts)
        if self.num_experts < 2:
            raise ValueError(f"{lp.name}: moe_param.num_experts must be >= 2")
        self.hidden = int(p.hidden_dim) or 4 * self.embed
        self.capacity_factor = float(p.capacity_factor)
        self.expert_parallel = bool(int(p.expert_parallel))

    def capacity(self, n):
        return max(1, math.ceil(n / self.num_experts * self.capacity_factor))

    def param_shapes(self):
        mults = _param_mults(self.lp, 5)
        X, E, F = self.num_experts, self.embed, self.hidden

        def xavier(fan_in):
            # the generic xavier filler would take the fan-in of the whole
            # 3-d blob (F*E), not of one expert's product
            lim = math.sqrt(3.0 / fan_in)
            return Message("FillerParameter", type="uniform",
                           min=-lim, max=lim)

        wf = self.p.weight_filler if self.p.has("weight_filler") else None
        return [((X, E), wf or xavier(E), *mults[0]),       # router
                ((X, F, E), wf or xavier(E), *mults[1]),    # w1
                ((X, F), None, *mults[2]),                  # b1
                ((X, E, F), wf or xavier(F), *mults[3]),    # w2
                ((X, E), None, *mults[4])]                  # b2

    def out_shapes(self):
        shapes = [tuple(self.bottom_shapes[0])]
        if len(self.lp.top) > 1:
            shapes.append(())                     # the aux loss
        if len(self.lp.top) > 2:
            shapes.append((self.num_experts + 1,))
        return shapes

    def route(self, xt, router):
        """-> (gates (n, X) f32, expert (n,), each token's gate (n,))."""
        gates = torch.softmax(xt.float() @ router.float().t(), dim=-1)
        idx = torch.argmax(gates, dim=-1)
        return gates, idx, gates.gather(1, idx[:, None])[:, 0]

    def dispatch(self, x, router):
        """Route one slot's tokens: -> (the (X, C, E) dispatch buffer,
        the routing the combine and the tops need)."""
        b, s, e = x.shape
        n, X = b * s, self.num_experts
        xt = x.reshape(n, e)
        gates, idx, gate = self.route(xt, router)
        # sort-based dispatch: a token's rank within its expert is its
        # position in the stable sort less the expert's first position;
        # ranks past the capacity go to the trash row X*C
        C = self.capacity(n)
        order = torch.argsort(idx, stable=True)
        idx_sorted = idx[order]
        starts = torch.searchsorted(
            idx_sorted, torch.arange(X, device=x.device, dtype=idx.dtype))
        rank = torch.arange(n, device=x.device) - starts[idx_sorted]
        keep = rank < C
        dest = torch.where(keep, idx_sorted * C + rank,
                           torch.full_like(rank, X * C))
        slot = torch.empty_like(dest)          # each token's slot
        slot[order] = dest
        buf = torch.zeros(X * C + 1, e, device=x.device,
                          dtype=torch.float32).index_put((slot,), xt.float())
        return buf[:-1].reshape(X, C, e), (x, gates, idx, gate, slot, keep, C)

    @staticmethod
    def experts(xe, w1, b1, w2, b2):
        """The expert FFN over (X, C, E) rows, in f32."""
        h = torch.relu(torch.einsum("xce,xfe->xcf", xe, w1.float())
                       + b1.float()[:, None, :])
        return torch.einsum("xcf,xef->xce", h, w2.float()) \
            + b2.float()[:, None, :]

    def combine(self, ye, routing):
        """Each slot's (X, C, E) expert outputs back to its tokens, and
        the layer's tops."""
        x, gates, idx, gate, slot, keep, C = routing
        b, s, e = x.shape
        n, X = b * s, self.num_experts
        # each slot's output written back to its token (an empty slot to
        # the trash row n; a dropped token's row stays zero), weighted by
        # the token's gate
        owner = torch.full((X * C + 1,), n, device=x.device,
                           dtype=slot.dtype)
        owner[slot] = torch.arange(n, device=x.device)
        y = ye.new_zeros(n + 1, e).index_put(
            (owner[:-1],), ye.reshape(X * C, e))[:n] * gate[:, None]
        tops = [y.reshape(b, s, e).to(x.dtype)]
        if len(self.lp.top) > 1:
            frac = torch.bincount(idx, minlength=X).float() / n
            tops.append(X * (frac * gates.mean(dim=0)).sum())
            if len(self.lp.top) > 2:
                overflow = 1.0 - keep.float().mean()
                tops.append(torch.cat([frac, overflow[None]]).detach())
        return tops

    def apply(self, params, bottoms, train):
        router, w1, b1, w2, b2 = params
        xe, routing = self.dispatch(bottoms[0], router)
        return self.combine(self.experts(xe, w1, b1, w2, b2), routing)

    def slot_coupled(self):
        from ..parallel import context
        return self.expert_parallel and context.axis("expert") is not None

    def apply_slots(self, params, bottoms, train):
        """The expert-parallel exchange over the "expert" slots: one
        (params, bottoms) a slot in (each slot's w1/b1/w2/b2 its own
        X/ep experts), one tops list a slot out."""
        from ..parallel import context
        from ..parallel.mesh import all_to_all
        mesh, axis = context.current_mesh(), context.axis("expert")
        routed = [self.dispatch(b[0], p[0]) for p, b in zip(params, bottoms)]
        xe = all_to_all([r[0] for r in routed], mesh, axis,
                        split_dim=0, concat_dim=1)
        ye = [self.experts(x, *p[1:]) for x, p in zip(xe, params)]
        ye = all_to_all(ye, mesh, axis, split_dim=1, concat_dim=0)
        return [self.combine(y, r[1]) for y, r in zip(ye, routed)]
