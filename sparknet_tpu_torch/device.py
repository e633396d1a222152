"""Device selection and precision for the port's entry points."""

import torch


def resolve_device(device="cuda"):
    """``torch.device`` for ``device``. Entry points default to the card;
    asking for CUDA where there is none raises instead of falling back
    to the CPU, which runs only when the caller names it.

    On the card it also turns TF32 off for cuDNN convolutions and for
    matmuls (``torch.backends.cudnn.allow_tf32`` and
    ``torch.backends.cuda.matmul.allow_tf32``, both process-wide), so
    every entry point computes in float32, the JAX package's default
    precision, and agrees with the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' (CLI: --device cpu) to run on "
                "the CPU")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev
