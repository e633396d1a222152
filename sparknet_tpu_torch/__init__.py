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
  ops/         every layer type of the JAX package on PyTorch tensors:
               convolution.py (Convolution, Deconvolution, Im2col),
               pooling.py (MAX, AVE, STOCHASTIC, SPP), activations.py
               (the neuron layers), normalization.py (BatchNorm, LayerNorm,
               MVN), structural.py (Slice, Split, Reshape, Tile, ArgMax,
               Reduction, Silence, BatchReindex, Filter...), moe.py (the
               Switch-MoE FFN), python_layer.py (type "Python"), losses,
               feeds, attention; cross-channel LRN, the fused conv
               epilogue and flash attention, forward and backward, as
               CUDA kernels behind autograd Functions (cuda_lrn.py,
               cuda_epilogue.py, cuda_attention.py, built from csrc/ by
               cuda_build.py)
  models/      the NetParam DSL + model zoo (copied verbatim)
  solver/      lr policies, Caffe's update rules, the one-device Solver
  resilience/  snapshot manifests: crash-safe commit, resume, weights-only
               load
  serve/       engine, batcher, HTTP server
  cli.py       ``python -m sparknet_tpu_torch train --solver <prototxt>``,
               ``serve --prefix <ckpt>``, ``lm`` and the other verbs

Public custom-layer API (ops/python_layer.py): subclass ``Layer`` and
decorate it with ``register_layer``, and prototxts can use its type
string; or use type "Python" with python_param to plug a class in by
module path. Both names load the layer registry on first use, so
importing the package alone imports nothing else.

Entry points run on the card unless the caller asks for the CPU.
"""

__version__ = "0.1.0"


def __getattr__(name):
    if name in ("Layer", "register_layer"):
        from .graph import registry
        return registry.Layer if name == "Layer" else registry.register
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
