"""The port's sequence-parallel attention against the JAX package on the
CPU: ring_attention and ulysses_attention over 4 "seq" slots, causal and
not, forward and the gradients of q, k and v, against the JAX functions
under shard_map over 4 devices of the virtual CPU mesh, on the same
seeded numpy inputs; and both against the port's dense attention on the
whole sequence. f32 throughout; every comparison within 1e-5 of the
reference's largest element (the blockwise softmax sums in another
order). Also: PositionalEmbed under a "seq" axis adds each shard's global
positions (sequence_sharded_apply), and Attention(ring=True) couples
the slots only under a "seq" axis.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from sparknet_tpu.parallel import make_mesh as jmesh
from sparknet_tpu.parallel import ring as jring
from sparknet_tpu.parallel.compat import shard_map
from sparknet_tpu_torch.graph.registry import get as tget
from sparknet_tpu_torch.ops.attention import dense_attention
from sparknet_tpu_torch.parallel import context, mesh, ring
from sparknet_tpu_torch.proto import Message as TMessage

TOL = 1e-5
N, SHAPE = 4, (2, 4, 32, 8)          # 4 seq slots; (B, H, S, D)


def _qkvg(seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(*SHAPE).astype(np.float32) for _ in range(4)]


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * float(np.abs(want).max()))


def _jax(fn_name, causal, q, k, v, g):
    fn = getattr(jring, fn_name)

    def loss(q, k, v):
        o = shard_map(lambda a, b, c: fn(a, b, c, "seq", causal=causal),
                      mesh=jmesh({"seq": N}), in_specs=(P(None, None, "seq"),)
                      * 3, out_specs=P(None, None, "seq"),
                      check_vma=False)(q, k, v)
        return jnp.sum(o * g), o

    (_, o), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return np.asarray(o), [np.asarray(x) for x in grads]


def _port(fn_name, causal, q, k, v, g):
    sm = mesh.SlotMesh({"seq": N})
    ins = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    shards = [list(torch.chunk(t, N, 2)) for t in ins]
    out = getattr(ring, fn_name)(*shards, sm, "seq", causal=causal)
    o = torch.cat(out, 2)
    (o * torch.from_numpy(g)).sum().backward()
    return o.detach().numpy(), [t.grad.numpy() for t in ins]


@pytest.mark.parametrize("fn_name", ["ring_attention", "ulysses_attention"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_sequence_parallel_attention_matches_jax(fn_name, causal):
    q, k, v, g = _qkvg(0)
    jo, jg = _jax(fn_name, causal, q, k, v, g)
    to, tg = _port(fn_name, causal, q, k, v, g)
    _close(to, jo)
    for a, b in zip(tg, jg):
        _close(a, b)
    # and the whole-sequence attention
    dense = dense_attention(*[torch.from_numpy(x) for x in (q, k, v)],
                            causal=causal).numpy()
    _close(to, dense)


def test_ring_comm_bytes_match_jax():
    for shape, n in (((2, 256, 64), 4), ((1, 1024, 1024), 8)):
        assert ring.ring_attention_comm_bytes(shape, n, itemsize=2) == \
            jring.ring_attention_comm_bytes(shape, n, itemsize=2)


def _layer(type_name, shape, **fields):
    lp = TMessage("LayerParameter", name="x", type=type_name, **fields)
    return tget(type_name)(lp, [shape], 0)


def test_positional_embed_adds_each_shards_global_positions():
    layer = _layer("PositionalEmbed", (1, 8, 4),
                   embed_param=dict(input_dim=64, num_output=4))
    whole = _layer("PositionalEmbed", (1, 64, 4),
                   embed_param=dict(input_dim=64, num_output=4))
    table = torch.arange(256, dtype=torch.float32).reshape(64, 4)
    x = torch.zeros(1, 64, 4)
    want = whole.apply([table], [x], True)[0]
    fwd = ring.sequence_sharded_apply(
        lambda xs: layer.apply([table], [xs], True)[0],
        mesh.SlotMesh({"seq": 8}), seq_dim=1)
    assert torch.equal(fwd(x), want)
    # without a seq axis a shard adds rows [0, S)
    assert torch.equal(layer.apply([table], [x[:, :8]], True)[0][0],
                       table[:8])


def test_ring_attention_couples_the_slots_only_under_a_seq_axis():
    layer = _layer("Attention", (2, 16, 8),
                   attention_param=dict(num_heads=2, causal=True, ring=True))
    plain = _layer("Attention", (2, 16, 8),
                   attention_param=dict(num_heads=2, causal=True))
    assert layer.ring and not layer.slot_coupled()
    sm = mesh.SlotMesh({"seq": 2})
    with context.axis_context(seq="seq"), context.mesh_context(sm):
        assert layer.slot_coupled() and not plain.slot_coupled()
        rs = np.random.RandomState(1)
        params = [torch.from_numpy(rs.randn(*s).astype(np.float32) * 0.3)
                  for s, *_ in layer.param_shapes()]
        x = torch.from_numpy(rs.randn(2, 32, 8).astype(np.float32))
        out = layer.apply_slots([params] * 2,
                                [[x[:, :16]], [x[:, 16:]]], True)
    whole = _layer("Attention", (2, 32, 8),
                   attention_param=dict(num_heads=2, causal=True))
    want = whole.apply(params, [x], True)[0]
    _close(torch.cat([o[0] for o in out], 1).detach().numpy(),
           want.detach().numpy())
