"""Snapshot manifests: the crash-safe snapshot commit for training,
resume, and weights-only loading for serving."""

from .checkpoint import (WorldMismatch, check_restorable, find_resumable,
                         load_manifest, load_model_only, manifest_path,
                         resume_auto, save_model_snapshot, save_snapshot)

__all__ = ["WorldMismatch", "check_restorable", "find_resumable",
           "load_manifest", "load_model_only", "manifest_path",
           "resume_auto", "save_model_snapshot", "save_snapshot"]
