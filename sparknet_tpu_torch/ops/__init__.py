"""Layer implementations (registered by import side effect): every layer
type the JAX package registers.

Plain PyTorch for the convolutions, pooling, matmuls, normalizations,
neuron and structural layers, losses, the user's Python layers and the
mixture-of-experts FFN; the cross-channel LRN (cuda_lrn), the fused conv
epilogue (cuda_epilogue) and flash attention (cuda_attention), forward
and backward, are CUDA kernels written for Hopper, built from ../csrc at
first use.
"""

from . import (  # noqa: F401
    activations,
    attention,
    convolution,
    dense,
    feed,
    losses,
    lrn,
    moe,
    normalization,
    pooling,
    python_layer,
    structural,
)
from .cuda_attention import (flash_attention, flash_attention_dkv,
                             flash_attention_dq)
from .cuda_epilogue import bias_relu, bias_relu_lrn, bias_relu_lrn_bwd
from .cuda_lrn import lrn_across, lrn_across_bwd

# every wrapper that launches a CUDA kernel; each counts in ``.launches``
KERNEL_WRAPPERS = (lrn_across, lrn_across_bwd, bias_relu_lrn,
                   bias_relu_lrn_bwd, bias_relu, flash_attention,
                   flash_attention_dq, flash_attention_dkv)


def kernel_launches():
    """{wrapper name: its kernel's launches in this process}."""
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
