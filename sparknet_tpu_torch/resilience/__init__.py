"""Run safety: the crash-safe snapshot commit with keep-N retention,
resume (falling back past a snapshot that fails to restore),
weights-only loading for serving, and divergence recovery."""

from .checkpoint import (WorldMismatch, check_restorable, find_resumable,
                         load_manifest, load_model_only, manifest_path,
                         resume_auto, save_model_snapshot, save_snapshot)
from .recovery import RecoveryAbort, RecoveryPolicy

__all__ = ["RecoveryAbort", "RecoveryPolicy", "WorldMismatch",
           "check_restorable", "find_resumable", "load_manifest",
           "load_model_only", "manifest_path", "resume_auto",
           "save_model_snapshot", "save_snapshot"]
