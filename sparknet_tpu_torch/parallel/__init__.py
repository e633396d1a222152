"""Distributed solvers of the port over worker slots stacked on one
device — per-step data parallelism and SparkNet's tau-step local SGD,
single-tier or over (host, data) fault domains (data_parallel.py), the
multi-host runtime (multihost.py), and the mesh axes of the ``lm``
verb: FSDP (fsdp.py), tensor parallelism (gspmd.py), sequence
parallelism with ring and Ulysses attention (seq_parallel.py, ring.py),
expert parallelism (expert_parallel.py) and the GPipe pipeline
(pipeline.py, pipeline_solver.py), over slot meshes whose collectives
live in mesh.py and whose coupled layers run in lock step
(lockstep.py)."""

from .context import axis_context, current_axes, current_host
from .data_parallel import DataParallelSolver, LocalSGDSolver
from .expert_parallel import ExpertParallelSolver
from .fsdp import FSDPSolver, fsdp_enabled, plan_param_specs
from .gspmd import GSPMDSolver, default_param_rule, transformer_tp_rule
from .mesh import (SlotMesh, local_batch_slice, make_mesh, make_tp_mesh,
                   mesh_axis_size)
from .multihost import (SlotGrid, auto_host_mesh, host_mesh, init_runtime,
                        needs_host_relay, survivor_mesh)
from .pipeline import gpipe, pipeline_apply, stack_params
from .pipeline_solver import PipelineLMSolver
from .ring import ring_attention, sequence_sharded_apply, ulysses_attention
from .seq_parallel import SeqParallelSolver

__all__ = ["DataParallelSolver", "ExpertParallelSolver", "FSDPSolver",
           "GSPMDSolver", "LocalSGDSolver", "PipelineLMSolver",
           "SeqParallelSolver", "SlotGrid", "SlotMesh", "auto_host_mesh",
           "axis_context", "current_axes", "current_host",
           "default_param_rule", "fsdp_enabled", "gpipe", "host_mesh",
           "init_runtime", "local_batch_slice", "make_mesh", "make_tp_mesh",
           "mesh_axis_size", "needs_host_relay", "pipeline_apply",
           "plan_param_specs", "ring_attention", "sequence_sharded_apply",
           "stack_params", "survivor_mesh", "transformer_tp_rule",
           "ulysses_attention"]
