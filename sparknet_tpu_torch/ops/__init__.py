"""Layer implementations (registered by import side effect).

Plain PyTorch for the convolutions, pooling, matmuls, reshapes and
losses; the cross-channel LRN (cuda_lrn) and the fused conv epilogue
(cuda_epilogue), forward and backward, are CUDA kernels written for
Hopper, built from ../csrc at first use.
"""

from . import (  # noqa: F401
    activations,
    convolution,
    dense,
    feed,
    losses,
    lrn,
    pooling,
    structural,
)
from .cuda_epilogue import bias_relu, bias_relu_lrn, bias_relu_lrn_bwd
from .cuda_lrn import lrn_across, lrn_across_bwd

# every wrapper that launches a CUDA kernel; each counts in ``.launches``
KERNEL_WRAPPERS = (lrn_across, lrn_across_bwd, bias_relu_lrn,
                   bias_relu_lrn_bwd, bias_relu)


def kernel_launches():
    """{wrapper name: its kernel's launches in this process}."""
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
