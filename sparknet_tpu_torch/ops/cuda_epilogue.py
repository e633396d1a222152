"""Fused convolution epilogue: the hand-written CUDA kernels and their
plain versions, forward and backward.

    bias_relu:      out = max(x + b, 0)
    bias_relu_lrn:  y = max(x + b, 0)
                    out = y * (k + alpha/size * sum_{window} y^2)^-beta

``x`` is the raw (bias-free) NCHW convolution output, ``b`` the (C,)
bias, cast to ``x.dtype`` as the TPU kernels do. Both forwards run as
one template kernel (csrc/epilogue.cu) in one read of x and one write of
out; the pre-LRN y never reaches device memory.

Both wrappers are differentiable and save only x and b. The backward of
bias_relu_lrn is the LRN backward kernel fused with the bias+ReLU
(csrc/lrn_bwd.cu): it recomputes y, rounded to ``x.dtype`` as the JAX
package's backward forms it, and masks with y > 0. The backward of
bias_relu is plain PyTorch on every device, as it is XLA in the JAX
package. dbias is an f32 sum of dx over (N, H, W), cast to ``b.dtype``.

Each wrapper takes the kernels for CUDA tensors and the plain versions
for CPU tensors, and counts its kernel launches in
``<wrapper>.launches``. Site selection lives in graph/compiler.py
(SPARKNET_EPILOGUE).
"""

import ctypes

import torch

from . import cuda_build
from .cuda_lrn import launch_lrn_backward, lrn_across_bwd_plain, \
    lrn_window_f32


def _biased_relu_f32(x, b):
    return torch.relu(x.float()
                      + b.to(x.dtype).float().reshape(1, -1, 1, 1))


def bias_relu_plain(x, b):
    """Plain PyTorch max(x + b, 0); f32 math, output in ``x.dtype``."""
    return _biased_relu_f32(x, b).to(x.dtype)


def bias_relu_lrn_plain(x, b, size, alpha, beta, k):
    """Plain PyTorch LRN(max(x + b, 0)); f32 math throughout (y is not
    rounded to ``x.dtype`` before the LRN), output in ``x.dtype``."""
    return lrn_window_f32(_biased_relu_f32(x, b), int(size), alpha, beta,
                          k).to(x.dtype)


def _bias_grad(dx, b):
    return dx.float().sum(dim=(0, 2, 3)).to(b.dtype)


def _relu_in_dtype(x, b):
    """y = max(x + b, 0) formed in ``x.dtype``, as the JAX package's
    backwards form it (pallas_epilogue.py _br_bwd, _brl_bwd)."""
    return torch.relu(x + b.to(x.dtype).reshape(1, -1, 1, 1))


def bias_relu_bwd(x, b, g):
    """(dx, db) of max(x + b, 0) for the output gradient ``g``: plain
    PyTorch on every device."""
    y = _relu_in_dtype(x, b)
    dx = torch.where(y > 0, g, torch.zeros_like(g))
    return dx, _bias_grad(dx, b)


def bias_relu_lrn_bwd_plain(x, b, g, size, alpha, beta, k):
    """Plain PyTorch (dx, db) of LRN(max(x + b, 0)): the LRN backward on
    y formed in ``x.dtype``, masked with y > 0; output in ``g.dtype``."""
    y = _relu_in_dtype(x, b)
    dy = lrn_across_bwd_plain(y, g, size, alpha, beta, k)
    dx = torch.where(y > 0, dy, torch.zeros_like(dy))
    return dx, _bias_grad(dx, b)


# sparknet_epilogue_forward(x, bias, out, dtype, with_lrn, n, c, hw, size,
#                           alpha/size, beta, k, stream) in csrc/epilogue.cu
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
             ctypes.c_void_p]


def _check_bias(x, b, what):
    if b.dim() != 1 or b.shape[0] != x.shape[1] or b.device != x.device:
        raise ValueError(f"{what}: bias must be ({x.shape[1]},) on "
                         f"{x.device}, got {tuple(b.shape)} on {b.device}")


def _launch(x, b, with_lrn, size, alpha, beta, k, what):
    dtype = cuda_build.check_cuda_input(x, what, size if with_lrn else None)
    _check_bias(x, b, what)
    bias = b.detach().to(x.dtype).contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    fn = cuda_build.function("epilogue", "sparknet_epilogue_forward",
                             _ARGTYPES)
    n, c, h, w = x.shape
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), bias.data_ptr(), out.data_ptr(), dtype,
                 int(with_lrn), n, c, h * w, int(size), alpha / size, beta,
                 k, cuda_build.stream_handle(x.device))
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")
    return out


def _bias_relu_forward(x, b):
    if x.device.type == "cpu":
        return bias_relu_plain(x, b)
    out = _launch(x, b, False, 1, 0.0, 0.0, 1.0, "bias_relu")
    if x.numel():
        bias_relu.launches += 1
    return out


def _bias_relu_lrn_forward(x, b, size, alpha, beta, k):
    if x.device.type == "cpu":
        return bias_relu_lrn_plain(x, b, size, alpha, beta, k)
    out = _launch(x, b, True, size, alpha, beta, k, "bias_relu_lrn")
    if x.numel():
        bias_relu_lrn.launches += 1
    return out


def bias_relu_lrn_bwd(x, b, g, size, alpha, beta, k):
    """(dx, db) of LRN(max(x + b, 0)) for ``g``: the fused backward kernel
    on CUDA tensors (dbias a PyTorch f32 sum), the plain version on CPU
    tensors."""
    if x.device.type == "cpu":
        return bias_relu_lrn_bwd_plain(x, b, g, size, alpha, beta, k)
    _check_bias(x, b, "bias_relu_lrn_bwd")
    dx = launch_lrn_backward(x, b.detach().to(x.dtype).contiguous(), g,
                             size, alpha, beta, k, "bias_relu_lrn_bwd")
    if x.numel():
        bias_relu_lrn_bwd.launches += 1
    return dx, _bias_grad(dx, b)


class _BiasRelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, b):
        ctx.save_for_backward(x, b)
        return _bias_relu_forward(x, b)

    @staticmethod
    def backward(ctx, g):
        x, b = ctx.saved_tensors
        return bias_relu_bwd(x, b, g)


class _BiasReluLRN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, b, size, alpha, beta, k):
        ctx.save_for_backward(x, b)
        ctx.lrn = (size, alpha, beta, k)
        return _bias_relu_lrn_forward(x, b, size, alpha, beta, k)

    @staticmethod
    def backward(ctx, g):
        x, b = ctx.saved_tensors
        dx, db = bias_relu_lrn_bwd(x, b, g.contiguous(), *ctx.lrn)
        return dx, db, None, None, None, None


def bias_relu(x, b):
    """max(x + b[None, :, None, None], 0) on NCHW, differentiable: the
    CUDA kernel on a CUDA tensor, the plain version on a CPU tensor."""
    return _BiasRelu.apply(x, b)


def bias_relu_lrn(x, b, size, alpha, beta, k):
    """Cross-channel LRN of max(x + b, 0) on NCHW in one fused pass,
    differentiable: the CUDA kernels on CUDA tensors, the plain versions
    on CPU tensors."""
    return _BiasReluLRN.apply(x, b, size, alpha, beta, k)


bias_relu.launches = 0
bias_relu_lrn.launches = 0
bias_relu_lrn_bwd.launches = 0
