"""Flash attention: the hand-written CUDA kernels and their plain
versions, forward and backward.

The port of sparknet_tpu/ops/pallas_attention.py (flash_attention
:286, _flash_forward :109, _flash_backward :237), on (B, H, S, D)
tensors in float32 or bfloat16:

    O      = softmax(scale * Q K^T [causal mask]) V,   LSE = m + log l
    P_ij   = exp(scale * Q_i K_j^T - LSE_i)            (recomputed)
    delta_i = rowsum(dO_i * O_i)
    dS_ij  = P_ij * (dO_i V_j^T - delta_i)
    dQ = scale * dS K,  dK = scale * dS^T Q,  dV = P^T dO

Masked scores are -1e30 (never -inf) and l is floored at 1e-30, as in
the JAX kernels; the forward scales Q before QK^T and the backward
scales the product, as they do. LSE is stored (B*H, S), not
lane-replicated. The backward computes delta once, in the dQ kernel,
and hands it to the dK/dV kernel.

For float32 tensors every kernel runs its products on the tensor cores
in split TF32 (csrc/flash_tf32.cuh, mma.sync): each f32 operand is
split into a TF32 hi and lo and a b ~ a_hi b_lo + a_lo b_hi + a_hi b_hi,
summed in f32, which is as accurate as f32 products (one TF32 pass is
not: it reads ~15x over the f32 limit on O); nothing is rounded between
the products. For bfloat16 tensors every kernel runs its products on the
tensor cores in bf16, with f32 sums, and rounds to bfloat16 what feeds a
second product: P before O = P V in the forward (csrc/flash_fwd.cu,
wgmma), P and dS before dV = P^T dO, dQ = dS K and dK = dS^T Q in the
backward (csrc/flash_bwd.cu, wgmma), as the JAX kernels'
default-precision dots do on the TPU. The plain versions keep them in
f32.

A head_dim D <= 256 that the kernels were not built for (``HEAD_DIMS``)
runs through the next built one: Q, K, V (and O, dO) are zero-padded to
it and the outputs sliced back. That is exact: zero columns add nothing
to Q K^T or to rowsum(dO * O), and give zero columns of O, dQ, dK and dV.
The scale stays 1/sqrt(D) of the true D. Past 256 any D is taken and
runs the wide kernels of csrc/flash_wide.cuh through the same entry
points and counters: the forward, dQ and dK/dV each on a thread-block
cluster that splits D into ``WIDE_CHUNK`` = 128-column slices, one a
CTA, and builds each score tile once from the slices' partial products
(exchanged through distributed shared memory, every product on the
tensor cores as above; dK/dV builds S^T and dP^T for a resident key
tile and rounds P^T and dS^T to bfloat16 as the bfloat16 backward does).
A cluster holds at most ``WIDE_CLUSTER`` = 8 slices (D <= 1024); past
that the slices split into equal clusters, each of which builds the
scores again. So D is zero-padded, for all three kernels, to the next
multiple of 128 whose slices split into equal clusters of at most 8
(``built_head_dim``: 320 -> 384, 1100 -> 1280).

``flash_attention`` is differentiable: for CUDA tensors its forward is
csrc/flash_fwd.cu and its backward the two kernels of csrc/flash_bwd.cu
(``flash_attention_dq``, then ``flash_attention_dkv``); for CPU tensors
the plain versions below. Nothing else picks between them, and nothing
falls back. ``flash_attention.launches``, ``flash_attention_dq.launches``
and ``flash_attention_dkv.launches`` count kernel launches.
"""

import ctypes
import math

import torch

from . import cuda_build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)   # the head_dims the kernels are built for
WIDE_CHUNK = 128    # past 256: the columns of D a cluster's CTA owns
WIDE_CLUSTER = 8    # and the most CTAs (slices) a cluster holds


def default_scale(q, scale=None):
    return scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])


def built_head_dim(d):
    """The head_dim of the kernels that take D = ``d``: the smallest of
    ``HEAD_DIMS`` at least ``d``, and past the last of them (the wide
    kernels) the least multiple of ``WIDE_CHUNK`` at least ``d`` whose
    slices split into equal clusters of at most ``WIDE_CLUSTER``."""
    for b in HEAD_DIMS:
        if d <= b:
            return b
    slices = -(-d // WIDE_CHUNK)
    groups = -(-slices // WIDE_CLUSTER)
    return groups * -(-slices // groups) * WIDE_CHUNK


def pad_head_dim(tensors, d):
    """Each of ``tensors`` zero-padded along its last dim to ``d``."""
    return [t if t.shape[-1] == d else
            torch.nn.functional.pad(t, (0, d - t.shape[-1])) for t in tensors]


def _above_diagonal(s, device):
    return torch.ones(s, s, dtype=torch.bool, device=device).triu(1)


def flash_attention_fwd_plain(q, k, v, causal=False, scale=None):
    """Plain PyTorch forward: (O in q.dtype, LSE (B*H, S) f32)."""
    b, h, s, _ = q.shape
    scale = default_scale(q, scale)
    sc = (q.float() * scale) @ k.float().transpose(-1, -2)
    if causal:
        sc = sc.masked_fill(_above_diagonal(s, q.device), NEG_INF)
    m = sc.amax(-1, keepdim=True)
    p = torch.exp(sc - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = (p @ v.float()) / l
    return o.to(q.dtype), (m + torch.log(l)).reshape(b * h, s)


def _probs(q, k, lse, causal, scale):
    """P = exp(scale * Q K^T - LSE) in f32, masked entries exactly 0."""
    b, h, s, _ = q.shape
    sc = scale * (q.float() @ k.float().transpose(-1, -2))
    if causal:
        sc = sc.masked_fill(_above_diagonal(s, q.device), NEG_INF)
    return torch.exp(sc - lse.reshape(b, h, s, 1))


def flash_attention_dq_plain(q, k, v, o, lse, do, causal=False, scale=None):
    """Plain PyTorch dQ: (dq in q.dtype, delta (B*H, S) f32)."""
    b, h, s, _ = q.shape
    scale = default_scale(q, scale)
    dof = do.float()
    delta = (dof * o.float()).sum(-1)
    ds = _probs(q, k, lse, causal, scale) * (
        dof @ v.float().transpose(-1, -2) - delta[..., None])
    return (scale * (ds @ k.float())).to(q.dtype), delta.reshape(b * h, s)


def flash_attention_dkv_plain(q, k, v, do, lse, delta, causal=False,
                              scale=None):
    """Plain PyTorch dK and dV from delta (the dQ step's): (dk, dv)."""
    b, h, s, _ = q.shape
    scale = default_scale(q, scale)
    dof = do.float()
    p = _probs(q, k, lse, causal, scale)
    dv = p.transpose(-1, -2) @ dof
    ds = p * (dof @ v.float().transpose(-1, -2) - delta.reshape(b, h, s, 1))
    dk = scale * (ds.transpose(-1, -2) @ q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal=False, scale=None):
    """Plain PyTorch backward, the FlashAttention-2 formulas with P
    recomputed from the saved LSE: (dq, dk, dv)."""
    dq, delta = flash_attention_dq_plain(q, k, v, o, lse, do, causal, scale)
    dk, dv = flash_attention_dkv_plain(q, k, v, do, lse, delta, causal,
                                       scale)
    return dq, dk, dv


# sparknet_flash_forward(q, k, v, o, lse, dtype, bh, seq, head_dim, scale,
#                        causal, stream) in csrc/flash_fwd.cu
_FWD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
# sparknet_flash_backward_dq(q, k, v, o, dout, lse, dq, delta, dtype, bh,
#                            seq, head_dim, scale, causal, stream) and
# sparknet_flash_backward_dkv(q, k, v, dout, lse, delta, dk, dv, ...)
# in csrc/flash_bwd.cu
_BWD_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def check_cuda_inputs(what, rows=(), **tensors):
    """Raise ValueError on what the kernels do not take: tensors not on
    one CUDA device, not 4-D (B, H, S, D) of one shape and dtype, not
    contiguous or not 16-byte aligned, a dtype they were not built for
    (float32, bfloat16), more than 65535 (batch, head) pairs or 64-row
    tiles; and per-row tensors ``rows`` (LSE, delta) not contiguous f32
    (B*H, S)."""
    ref = next(iter(tensors.values()))
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != ref.device:
            raise ValueError(f"{what}: {name} on {t.device}, want one cuda "
                             "device")
        if t.dim() != 4 or t.shape != ref.shape or t.dtype != ref.dtype:
            raise ValueError(f"{what}: {name} {tuple(t.shape)} {t.dtype}, "
                             f"want (B, H, S, D) {tuple(ref.shape)} "
                             f"{ref.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous (B, H, S, D)")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must start 16-byte aligned "
                             "(the kernels copy 16-byte chunks)")
    if ref.dtype not in cuda_build.DTYPE_CODES:
        raise ValueError(f"{what}: dtype {ref.dtype} not built "
                         "(float32, bfloat16)")
    b, h, s, d = ref.shape
    if b * h > cuda_build.MAX_GRID_Y:
        raise ValueError(f"{what}: B*H = {b * h} > {cuda_build.MAX_GRID_Y}")
    if s > 64 * cuda_build.MAX_GRID_Y:
        raise ValueError(f"{what}: S = {s} > {64 * cuda_build.MAX_GRID_Y}")
    for t in rows:
        if t.device != ref.device or t.dtype != torch.float32 \
                or t.shape != (b * h, s) or not t.is_contiguous():
            raise ValueError(f"{what}: per-row tensor {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}, want contiguous "
                             f"float32 ({b * h}, {s}) on {ref.device}")


def _launch(what, source, symbol, argtypes, ref, pointers, scale, causal):
    """Launch on tensors already padded to a built head_dim."""
    b, h, s, d = ref.shape
    fn = cuda_build.function(source, symbol, argtypes)
    with torch.cuda.device(ref.device):
        err = fn(*(t.data_ptr() for t in pointers),
                 cuda_build.DTYPE_CODES[ref.dtype], b * h, s, d, scale,
                 int(causal), cuda_build.stream_handle(ref.device))
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")


def flash_attention_fwd(q, k, v, causal=False, scale=None):
    """The forward on its own: (O, LSE) from the kernel for CUDA tensors,
    from the plain version for CPU tensors."""
    scale = default_scale(q, scale)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal, scale)
    check_cuda_inputs("flash_attention", q=q, k=k, v=v)
    b, h, s, d = q.shape
    lse = torch.empty(b * h, s, dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return torch.empty_like(q), lse
    q, k, v = pad_head_dim((q, k, v), built_head_dim(d))
    o = torch.empty_like(q)
    _launch("flash_attention", "flash_fwd", "sparknet_flash_forward",
            _FWD_ARGTYPES, q, (q, k, v, o, lse), scale, causal)
    flash_attention.launches += 1
    return o[..., :d].contiguous(), lse


def flash_attention_dq(q, k, v, o, lse, do, causal=False, scale=None):
    """dQ and delta: the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    scale = default_scale(q, scale)
    if q.device.type == "cpu":
        return flash_attention_dq_plain(q, k, v, o, lse, do, causal, scale)
    check_cuda_inputs("flash_attention_dq", rows=(lse,), q=q, k=k, v=v, o=o,
                      do=do)
    b, h, s, d = q.shape
    delta = torch.empty(b * h, s, dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return torch.empty_like(q), delta
    q, k, v, o, do = pad_head_dim((q, k, v, o, do), built_head_dim(d))
    dq = torch.empty_like(q)
    _launch("flash_attention_dq", "flash_bwd", "sparknet_flash_backward_dq",
            _BWD_ARGTYPES, q, (q, k, v, o, do, lse, dq, delta), scale, causal)
    flash_attention_dq.launches += 1
    return dq[..., :d].contiguous(), delta


def flash_attention_dkv(q, k, v, do, lse, delta, causal=False, scale=None):
    """dK and dV from delta (flash_attention_dq's): the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    scale = default_scale(q, scale)
    if q.device.type == "cpu":
        return flash_attention_dkv_plain(q, k, v, do, lse, delta, causal,
                                         scale)
    check_cuda_inputs("flash_attention_dkv", rows=(lse, delta), q=q, k=k,
                      v=v, do=do)
    d = q.shape[-1]
    if q.numel() == 0:
        return torch.empty_like(k), torch.empty_like(v)
    q, k, v, do = pad_head_dim((q, k, v, do), built_head_dim(d))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_attention_dkv", "flash_bwd", "sparknet_flash_backward_dkv",
            _BWD_ARGTYPES, q, (q, k, v, do, lse, delta, dk, dv), scale,
            causal)
    flash_attention_dkv.launches += 1
    return dk[..., :d].contiguous(), dv[..., :d].contiguous()


class _FlashAttention(torch.autograd.Function):
    """The forward saves q, k, v, O and LSE; the backward recomputes P
    from LSE, as the JAX package's custom_vjp does."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = flash_attention_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.flash = (causal, scale)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        causal, scale = ctx.flash
        g = g.to(q.dtype).contiguous()
        dq, delta = flash_attention_dq(q, k, v, o, lse, g, causal, scale)
        dk, dv = flash_attention_dkv(q, k, v, g, lse, delta, causal, scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=False, scale=None):
    """Flash attention (B, H, S, D) -> (B, H, S, D), differentiable; scale
    defaults to 1/sqrt(D). CUDA kernels on CUDA tensors, the plain
    versions on CPU tensors."""
    return _FlashAttention.apply(q, k, v, bool(causal),
                                 float(default_scale(q, scale)))


flash_attention.launches = 0
flash_attention_dq.launches = 0
flash_attention_dkv.launches = 0
