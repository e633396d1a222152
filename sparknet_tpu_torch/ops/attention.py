"""Multi-head self-attention (the port of sparknet_tpu/ops/attention.py).

Bottom blob (B, S, E). One fused QKV projection (3*H*D, E) whose output
rows are laid out (3, H, D), as in the JAX package, so weights carry
over unchanged. The core is the flash-attention kernel
(ops/cuda_attention.py) when ``attention_param.flash`` is set and S is
a multiple of 128, else ``dense_attention``, the JAX layer's rule.
With ``attention_param.ring`` under a "seq" axis (parallel/context.py,
published by the sequence-parallel solvers) the layer needs every seq
slot at once: ``slot_coupled()`` says so, and ``apply_slots`` runs ring
attention (parallel/ring.py) over the slots' projections; without a
"seq" axis ``ring`` is ignored, as in the JAX layer.
"""

import torch

from ..graph.registry import Layer, register
from ..proto import Message
from .convolution import _param_mults
from .cuda_attention import flash_attention


def dense_attention(q, k, v, causal=False, scale=None):
    """Plain full attention (B, H, S, D), the port of
    sparknet_tpu/parallel/ring.py:dense_attention: scores in f32 from
    q * scale in q's dtype, masked with -inf, softmax, output in q's
    dtype."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    s = (q * scale).float() @ k.float().transpose(-1, -2)
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        keep = torch.ones(sq, sk, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return (p @ v.float()).to(q.dtype)


@register
class Attention(Layer):
    type_name = "Attention"

    def __init__(self, lp, bottom_shapes, phase):
        super().__init__(lp, bottom_shapes, phase)
        p = lp.attention_param
        self.p = p
        b, s, e = bottom_shapes[0]
        self.embed = int(e)
        self.num_heads = int(p.num_heads)
        self.head_dim = int(p.head_dim) if p.has("head_dim") \
            else self.embed // self.num_heads
        self.causal = bool(p.causal)
        self.ring = bool(p.ring)
        self.flash = bool(p.flash)
        self.inner = self.num_heads * self.head_dim

    def param_shapes(self):
        mults = _param_mults(self.lp, 4)
        # an attention with zero projections kills its input: default xavier
        wf = self.p.weight_filler if self.p.has("weight_filler") \
            else Message("FillerParameter", type="xavier")
        return [
            ((3 * self.inner, self.embed), wf, *mults[0]),   # fused qkv
            ((3 * self.inner,), None, *mults[1]),
            ((self.embed, self.inner), wf, *mults[2]),       # out proj
            ((self.embed,), None, *mults[3]),
        ]

    def out_shapes(self):
        return [tuple(self.bottom_shapes[0])]

    def project(self, params, x):
        """x (B, S, E) -> q, k, v (B, H, S, D), contiguous: the kernels
        take no strides."""
        wqkv, bqkv = params[0].to(x.dtype), params[1].to(x.dtype)
        b, s, _ = x.shape
        heads = wqkv.shape[0] // (3 * self.head_dim)
        qkv = (x @ wqkv.T + bqkv).reshape(b, s, 3, heads, self.head_dim)
        return [qkv[:, :, i].transpose(1, 2).contiguous() for i in range(3)]

    def core(self, q, k, v):
        if self.flash and q.shape[2] % 128 == 0:
            return flash_attention(q, k, v, self.causal)
        return dense_attention(q, k, v, causal=self.causal)

    def output(self, params, o):
        """o (B, H, S, D) -> (B, S, E) through the output projection."""
        b, h, s, d = o.shape
        wo, bo = params[2].to(o.dtype), params[3].to(o.dtype)
        return o.transpose(1, 2).reshape(b, s, h * d) @ wo.T + bo

    def apply(self, params, bottoms, train):
        q, k, v = self.project(params, bottoms[0])
        return [self.output(params, self.core(q, k, v))]

    def slot_coupled(self):
        from ..parallel import context
        return self.ring and context.axis("seq") is not None

    def apply_slots(self, params, bottoms, train):
        """Ring attention over the "seq" slots: one (params, bottoms) a
        slot in, one [top] a slot out."""
        from ..parallel import context
        from ..parallel.ring import ring_attention
        qkv = [self.project(p, b[0]) for p, b in zip(params, bottoms)]
        o = ring_attention([t[0] for t in qkv], [t[1] for t in qkv],
                           [t[2] for t in qkv], context.current_mesh(),
                           context.axis("seq"), causal=self.causal)
        return [[self.output(p, ow)] for p, ow in zip(params, o)]
