"""Cross-channel LRN: the hand-written CUDA kernels and their plain
versions, forward and backward.

Caffe lrn_layer.cpp ACROSS_CHANNELS (:108-133, backward :180-204):
    scale = k + alpha/size * sum_{window} x^2,  out = x * scale^-beta
    dx = g * scale^-beta
       - (2*alpha*beta/size) * x * sum_{mirrored window} g*x*scale^(-beta-1)
with the window [c - half, c + size - 1 - half], half = (size - 1) // 2,
zero-padded at the channel edges, and the mirrored window
[c - (size - 1 - half), c + half].

``lrn_across`` is differentiable: its forward is the kernel of
csrc/lrn.cu and its backward the kernel of csrc/lrn_bwd.cu for a CUDA
tensor, the plain versions for a CPU tensor; nothing else picks between
them. ``lrn_across.launches`` and ``lrn_across_bwd.launches`` count
kernel launches.
"""

import ctypes

import torch

from . import cuda_build


def window_sum(t, size, lo):
    """Sum over channel offsets [-lo, size - 1 - lo] (dim 1), zero-padded
    at the channel edges: ``size`` shifted slices added in order."""
    c = t.shape[1]
    pad = list(t.shape)
    pad[1] = lo
    before = t.new_zeros(pad)
    pad[1] = size - 1 - lo
    after = t.new_zeros(pad)
    tp = torch.cat([before, t, after], dim=1)
    out = tp[:, 0:c]
    for d in range(1, size):
        out = out + tp[:, d:d + c]
    return out


def lrn_scale_f32(xf, size, alpha, k):
    """k + alpha/size * sum_{window} x^2 on an f32 tensor."""
    return k + (alpha / size) * window_sum(xf * xf, size, (size - 1) // 2)


def lrn_window_f32(xf, size, alpha, beta, k):
    """The forward formula on an f32 tensor, channels on dim 1."""
    return xf * lrn_scale_f32(xf, size, alpha, k) ** (-beta)


def lrn_across_plain(x, size, alpha, beta, k):
    """Plain PyTorch cross-channel LRN (differentiable); f32 math, output
    in ``x.dtype``."""
    return lrn_window_f32(x.float(), int(size), alpha, beta, k).to(x.dtype)


def lrn_across_bwd_plain(x, g, size, alpha, beta, k):
    """Plain PyTorch gradient of the cross-channel LRN at ``x`` for the
    output gradient ``g``: the explicit formula, scale recomputed from x,
    f32 math, output in ``g.dtype``."""
    size = int(size)
    xf, gf = x.float(), g.float()
    scale = lrn_scale_f32(xf, size, alpha, k)
    t = gf * xf * scale ** (-beta - 1.0)
    acc = window_sum(t, size, size - 1 - (size - 1) // 2)
    dx = gf * scale ** (-beta) - (2.0 * alpha * beta / size) * xf * acc
    return dx.to(g.dtype)


# sparknet_lrn_forward(x, out, dtype, n, c, hw, size, alpha/size, beta,
#                      k, stream) in csrc/lrn.cu
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
             ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
# sparknet_lrn_backward(x, bias, g, dx, dtype, bias_relu, n, c, hw, size,
#                       alpha/size, beta, k, 2*alpha*beta/size, stream)
# in csrc/lrn_bwd.cu
_BWD_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                 ctypes.c_float, ctypes.c_float, ctypes.c_float,
                 ctypes.c_float, ctypes.c_void_p]


def _lrn_forward(x, size, alpha, beta, k):
    """The forward on its own: the kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    if x.device.type == "cpu":
        return lrn_across_plain(x, size, alpha, beta, k)
    dtype = cuda_build.check_cuda_input(x, "lrn_across", size)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    fn = cuda_build.function("lrn", "sparknet_lrn_forward", _ARGTYPES)
    n, c, h, w = x.shape
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), out.data_ptr(), dtype, n, c, h * w,
                 int(size), alpha / size, beta, k,
                 cuda_build.stream_handle(x.device))
    if err != 0:
        raise RuntimeError(f"lrn kernel launch failed: cudaError {err}")
    lrn_across.launches += 1
    return out


def launch_lrn_backward(x, bias, g, size, alpha, beta, k, what):
    """Launch csrc/lrn_bwd.cu on CUDA tensors ``x`` and ``g`` (and, for
    the fused epilogue, the bias, else None) and return dx. Raises on
    what the kernel does not take; counts nothing."""
    dtype = cuda_build.check_cuda_input(x, what, size,
                                        cuda_build.MAX_WINDOW_BWD)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"{what}: gradient {tuple(g.shape)} {g.dtype} on "
                         f"{g.device}, want {tuple(x.shape)} {x.dtype} on "
                         f"{x.device}")
    g = g.contiguous()
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx
    fn = cuda_build.function("lrn_bwd", "sparknet_lrn_backward",
                             _BWD_ARGTYPES)
    n, c, h, w = x.shape
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), 0 if bias is None else bias.data_ptr(),
                 g.data_ptr(), dx.data_ptr(), dtype, int(bias is not None),
                 n, c, h * w, int(size), alpha / size, beta, k,
                 2.0 * alpha * beta / size,
                 cuda_build.stream_handle(x.device))
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")
    return dx


def lrn_across_bwd(x, g, size, alpha, beta, k):
    """Gradient of the cross-channel LRN at NCHW ``x`` for ``g``: the CUDA
    kernel on CUDA tensors, the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return lrn_across_bwd_plain(x, g, size, alpha, beta, k)
    dx = launch_lrn_backward(x, None, g, size, alpha, beta, k,
                             "lrn_across_bwd")
    if x.numel():
        lrn_across_bwd.launches += 1
    return dx


class _LRNAcross(torch.autograd.Function):
    """The forward saves x; the backward recomputes scale from it, as
    the JAX package's custom_vjp does."""

    @staticmethod
    def forward(ctx, x, size, alpha, beta, k):
        ctx.save_for_backward(x)
        ctx.lrn = (size, alpha, beta, k)
        return _lrn_forward(x, size, alpha, beta, k)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return (lrn_across_bwd(x, g.contiguous(), *ctx.lrn),
                None, None, None, None)


def lrn_across(x, size, alpha, beta, k):
    """Cross-channel LRN on NCHW ``x``, differentiable: the CUDA kernels
    on a CUDA tensor, the plain versions on a CPU tensor."""
    return _LRNAcross.apply(x, size, alpha, beta, k)


lrn_across.launches = 0
lrn_across_bwd.launches = 0
