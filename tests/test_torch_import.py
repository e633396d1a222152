"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, and its modules import where there is no nvcc and no card.

The import check runs in a subprocess because this pytest process has
already imported JAX (tests/conftest.py)."""

import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
PORT = os.path.join(REPO, "sparknet_tpu_torch")

MODULES = [
    "sparknet_tpu_torch", "sparknet_tpu_torch.cli", "sparknet_tpu_torch.device",
    "sparknet_tpu_torch.proto", "sparknet_tpu_torch.graph",
    "sparknet_tpu_torch.graph.compiler", "sparknet_tpu_torch.graph.weights",
    "sparknet_tpu_torch.models", "sparknet_tpu_torch.ops",
    "sparknet_tpu_torch.ops.cuda_build", "sparknet_tpu_torch.ops.cuda_lrn",
    "sparknet_tpu_torch.ops.cuda_epilogue", "sparknet_tpu_torch.ops.losses",
    "sparknet_tpu_torch.graph.upgrade", "sparknet_tpu_torch.resilience",
    "sparknet_tpu_torch.resilience.checkpoint", "sparknet_tpu_torch.serve",
    "sparknet_tpu_torch.solver", "sparknet_tpu_torch.solver.solver",
    "sparknet_tpu_torch.solver.updates", "sparknet_tpu_torch.solver.lr_policy",
    "sparknet_tpu_torch.solver.hdf5_io", "sparknet_tpu_torch.ops.attention",
    "sparknet_tpu_torch.ops.cuda_attention",
    "sparknet_tpu_torch.ops.normalization", "sparknet_tpu_torch.data",
    "sparknet_tpu_torch.utils", "sparknet_tpu_torch.parallel",
    "sparknet_tpu_torch.parallel.data_parallel", "sparknet_tpu_torch.apps",
    "sparknet_tpu_torch.apps.cifar_app", "sparknet_tpu_torch.data.cifar",
    "sparknet_tpu_torch.data.prefetch", "sparknet_tpu_torch.data.synthetic",
    "sparknet_tpu_torch.models.proto_loader", "sparknet_tpu_torch.tools",
    "sparknet_tpu_torch.utils.watchdog", "sparknet_tpu_torch.data.datum",
    "sparknet_tpu_torch.data.lmdb", "sparknet_tpu_torch.data.leveldb",
    "sparknet_tpu_torch.data.transforms",
    "sparknet_tpu_torch.data.device_transform",
    "sparknet_tpu_torch.data.db_source", "sparknet_tpu_torch.data.imagenet",
    "sparknet_tpu_torch.apps.imagenet_app", "sparknet_tpu_torch.ops.feed",
    "sparknet_tpu_torch.data.device_cache", "sparknet_tpu_torch.data.wire",
    "sparknet_tpu_torch.data.file_sources", "sparknet_tpu_torch.data.sampler",
    "sparknet_tpu_torch.ops.moe", "sparknet_tpu_torch.ops.python_layer",
    "sparknet_tpu_torch.ops.activations", "sparknet_tpu_torch.ops.structural",
    "sparknet_tpu_torch.ops.pooling", "sparknet_tpu_torch.ops.convolution",
    "sparknet_tpu_torch.obs", "sparknet_tpu_torch.obs.trace",
    "sparknet_tpu_torch.obs.stepstats", "sparknet_tpu_torch.obs.memstats",
    "sparknet_tpu_torch.obs.comms", "sparknet_tpu_torch.obs.divergence",
    "sparknet_tpu_torch.obs.health", "sparknet_tpu_torch.obs.event_schema",
    "sparknet_tpu_torch.obs.report", "sparknet_tpu_torch.obs.critpath",
    "sparknet_tpu_torch.obs.fleettrace", "sparknet_tpu_torch.utils.metrics",
    "sparknet_tpu_torch.utils.signals", "sparknet_tpu_torch.utils.timing",
    "sparknet_tpu_torch.utils.exit_codes",
    "sparknet_tpu_torch.resilience.recovery",
    "sparknet_tpu_torch.resilience.seam",
    "sparknet_tpu_torch.resilience.heartbeat",
    "sparknet_tpu_torch.resilience.elastic",
    "sparknet_tpu_torch.resilience.chaos", "sparknet_tpu_torch.obs.tracing",
    "sparknet_tpu_torch.obs.monitor", "sparknet_tpu_torch.serve.fleet",
    "sparknet_tpu_torch.serve.loadgen", "sparknet_tpu_torch.sim",
    "sparknet_tpu_torch.sim.clock", "sparknet_tpu_torch.sim.memdir",
    "sparknet_tpu_torch.sim.servefleet", "sparknet_tpu_torch.sim.sweep",
    "sparknet_tpu_torch.graph.fission", "sparknet_tpu_torch.native",
    "sparknet_tpu_torch.analysis", "sparknet_tpu_torch.analysis.cli",
    "sparknet_tpu_torch.analysis.baseline",
    "sparknet_tpu_torch.analysis.engine",
    "sparknet_tpu_torch.analysis.jax_rules",
    "sparknet_tpu_torch.analysis.metrics_rules",
    "sparknet_tpu_torch.analysis.project",
    "sparknet_tpu_torch.analysis.protocol_rules",
    "sparknet_tpu_torch.analysis.thread_rules",
]


def test_port_imports_without_jax_or_the_jax_package():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'sparknet_tpu' or "
        "m.startswith('sparknet_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _port_sources():
    for root, _, files in os.walk(PORT):
        for fn in files:
            if fn.endswith(".py"):
                yield os.path.join(root, fn)


def test_port_sources_name_no_jax_import():
    pat = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|"
                     r"import\s+sparknet_tpu\b(?!_torch)|"
                     r"from\s+sparknet_tpu\b(?!_torch))", re.M)
    hits = []
    for path in _port_sources():
        with open(path) as f:
            for m in pat.finditer(f.read()):
                hits.append(f"{os.path.relpath(path, REPO)}: {m.group(0)}")
    assert not hits, hits
    assert sum(1 for _ in _port_sources()) > 20


def test_port_imports_leave_h5py_and_pil_out():
    """h5py and PIL are absent on the card's machine: the port imports
    them only inside the functions that read images and .h5 files."""
    code = (
        "import importlib, sys\n"
        "import sparknet_tpu_torch, sparknet_tpu_torch.data\n"
        "first = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('h5py', 'PIL'))\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('h5py', 'PIL', 'jax'))\n"
        "assert not first and not bad, (first, bad)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_kernel_sources_ship_with_the_package():
    csrc = os.path.join(PORT, "csrc")
    assert {"lrn.cu", "epilogue.cu", "lrn_bwd.cu", "channel_walk.cuh",
            "flash_fwd.cu", "flash_bwd.cu", "flash_common.cuh",
            "flash_mma.cuh"} <= \
        set(os.listdir(csrc))
    for fn, bound in (("lrn.cu", "memory"), ("epilogue.cu", "memory"),
                      ("lrn_bwd.cu", "memory"), ("flash_fwd.cu", "operations"),
                      ("flash_bwd.cu", "operations")):
        with open(os.path.join(csrc, fn)) as f:
            head = f.read(2500)
        # each kernel names the TPU kernel it replaces and its bound
        assert "sparknet_tpu/ops/pallas_" in head and bound in head, fn


def test_custom_layer_api_loads_the_registry_on_first_use():
    code = (
        "import sys\n"
        "import sparknet_tpu_torch as p\n"
        "assert 'torch' not in sys.modules\n"
        "from sparknet_tpu_torch import Layer, register_layer\n"
        "from sparknet_tpu_torch.graph import registry\n"
        "assert Layer is registry.Layer and register_layer is "
        "registry.register\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
