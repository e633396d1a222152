"""sparknet_tpu_torch — SparkNet's PyTorch/CUDA port for NVIDIA Hopper.

The second package of this repository, beside the JAX/TPU package
``sparknet_tpu``, which stays the reference it is held against. It
imports ``torch`` and numpy, never JAX and nothing of ``sparknet_tpu``:
what it shares with that package (the proto codecs, the model DSL and
zoo) is a copy of its own.

Layer map:
  proto/       prototxt + binaryproto codecs (copied verbatim)
  graph/       NetParameter -> CompiledNet (TEST and TRAIN phases, loss
               weights), net and solver upgrades, fillers, weight and
               solver-history carry-over from the JAX package (weights.py)
  ops/         layers and losses on PyTorch tensors; cross-channel LRN
               and the fused conv epilogue, forward and backward, as
               CUDA kernels behind autograd Functions (cuda_lrn.py,
               cuda_epilogue.py, built from csrc/ by cuda_build.py)
  models/      the NetParam DSL + model zoo (copied verbatim)
  solver/      lr policies, Caffe's update rules, the one-device Solver
  resilience/  snapshot manifests: crash-safe commit, resume, weights-only
               load
  serve/       engine, batcher, HTTP server
  cli.py       ``python -m sparknet_tpu_torch train --solver <prototxt>``
               and ``serve --prefix <ckpt>``

Entry points run on the card unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
