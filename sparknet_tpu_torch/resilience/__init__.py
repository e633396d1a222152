"""Run safety: the crash-safe snapshot commit with keep-N retention,
resume (falling back past a snapshot that fails to restore),
weights-only loading for serving, divergence recovery; and the serving
fleet's membership: leased heartbeats over a rendezvous directory
(heartbeat.py, over the seam.py clock and directory), the host half of
elastic membership (elastic.py) and the chaos grammar (chaos.py)."""

from .checkpoint import (WorldMismatch, check_restorable, find_resumable,
                         load_manifest, load_model_only, manifest_path,
                         resume_auto, save_model_snapshot, save_snapshot)
from .chaos import ChaosIOError, ChaosMonkey, active_chaos, install_chaos
from .elastic import EXIT_QUORUM_LOST, ElasticPolicy, QuorumLost
from .heartbeat import (GateResult, HeartbeatCoordinator, HostDead,
                        fresh_leases, manifest_sha)
from .recovery import RecoveryAbort, RecoveryPolicy

__all__ = ["ChaosIOError", "ChaosMonkey", "EXIT_QUORUM_LOST",
           "ElasticPolicy", "GateResult", "HeartbeatCoordinator", "HostDead",
           "QuorumLost", "RecoveryAbort", "RecoveryPolicy", "WorldMismatch",
           "active_chaos", "check_restorable", "find_resumable",
           "fresh_leases", "install_chaos", "load_manifest",
           "load_model_only", "manifest_path", "manifest_sha", "resume_auto",
           "save_model_snapshot", "save_snapshot"]
