"""Run safety and multi-host resilience: the crash-safe snapshot commit
with keep-N retention, resume (falling back past a snapshot that fails
to restore), cross-world resharding and the non-writers' manifest
barrier (checkpoint.py), weights-only loading for serving, divergence
recovery (recovery.py), jittered-backoff retries of flaky reads
(retry.py), elastic membership with its masked consensus over the slots
(elastic.py), leased heartbeats over a rendezvous directory with the
file relay of the cross-host average and the coordinated-restart
barrier (heartbeat.py, over the seam.py clock and directory), and the
chaos grammar that exercises all of it (chaos.py)."""

from .checkpoint import (WorldMismatch, check_restorable, find_resumable,
                         load_manifest, load_model_only, manifest_path,
                         reshard_for_world, resume_auto, save_model_snapshot,
                         save_snapshot, wait_for_manifest, world_signature,
                         world_slots)
from .chaos import ChaosIOError, ChaosMonkey, active_chaos, install_chaos
from .elastic import (EXIT_QUORUM_LOST, ElasticPolicy, QuorumLost,
                      expand_to_slots, masked_consensus,
                      masked_consensus_stats, masked_scalar_mean,
                      slots_finite, staleness_discount, tree_finite,
                      weighted_consensus, weighted_consensus_stats)
from .heartbeat import (AsyncFileConsensus, FileConsensus, GateResult,
                        HeartbeatCoordinator, HostDead, fresh_leases,
                        manifest_sha, restart_barrier)
from .recovery import RecoveryAbort, RecoveryPolicy
from .retry import RetryExhausted, RetryPolicy, retry_from_env

__all__ = ["AsyncFileConsensus", "ChaosIOError", "ChaosMonkey",
           "EXIT_QUORUM_LOST", "ElasticPolicy", "FileConsensus",
           "GateResult", "HeartbeatCoordinator", "HostDead", "QuorumLost",
           "RecoveryAbort", "RecoveryPolicy", "RetryExhausted",
           "RetryPolicy", "WorldMismatch", "active_chaos",
           "check_restorable", "expand_to_slots", "find_resumable",
           "fresh_leases", "install_chaos", "load_manifest",
           "load_model_only", "manifest_path", "manifest_sha",
           "masked_consensus", "masked_consensus_stats",
           "masked_scalar_mean", "reshard_for_world", "restart_barrier",
           "resume_auto", "retry_from_env", "save_model_snapshot",
           "save_snapshot", "slots_finite", "staleness_discount",
           "tree_finite", "wait_for_manifest", "weighted_consensus",
           "weighted_consensus_stats", "world_signature", "world_slots"]
