"""`sparknet_tpu_torch lint` — static analysis for the codebase's own
bug classes (the port's copy of sparknet_tpu/analysis/: stdlib-only
AST code, kept here so the port imports nothing of the JAX package).

The runtime machinery of PRs 1-4 (obs, resilience, elastic rounds)
catches failures while they happen; this subsystem catches the bug
classes this codebase is most exposed to *before* anything runs, in the
spirit of always-on program-analysis platforms (Tricorder, Sadowski et
al., ICSE 2015): build the analyzers once, run them on every commit.

Two analyzer families over a shared AST engine (engine.py):

  jax_rules.py     SPK1xx — compiled-code hazards: host syncs reachable
                   from jit/pmap/shard_map roots (which would erase the
                   local-SGD comms savings the SparkNet design exists
                   to deliver), recompile hazards, PRNG-key reuse,
                   collective axis-name mismatches, missing buffer
                   donation in update loops.
  thread_rules.py  SPK2xx — lock discipline for the threaded host side
                   (watchdog, metrics, prefetch, monitor): fields
                   annotated ``# spk: guarded-by=<lock>`` are flagged
                   when read/written outside a ``with <lock>:`` block
                   in any method reachable from a thread entry point.

Findings can be suppressed inline (``# spk: disable=CODE``) or accepted
into a committed baseline file with a written justification
(baseline.py), so legacy findings never block CI while new ones do.
CLI: ``python -m sparknet_tpu_torch lint [--strict] [paths...]``
(cli.py); with no paths it lints the sparknet_tpu_torch package against
its own baseline, ``.sparknet-torch-lint-baseline.json``. The rule
families and codes are the JAX package's; the SPK1xx rules look for
JAX calls, which the port has none of.

Import discipline: nothing in this package imports jax (or any other
heavyweight dependency) — linting runs on checkout hosts with no
accelerator stack, exactly like ``sparknet monitor``.
"""

from .engine import (Finding, Module, LintEngine, lint_paths,
                     all_rules, ALL_CODES)
from .baseline import Baseline

__all__ = ["Finding", "Module", "LintEngine", "lint_paths",
           "all_rules", "ALL_CODES", "Baseline"]
