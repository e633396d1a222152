"""A copy of sparknet_tpu/utils/exit_codes.py. The canonical process exit-code table — ONE place, named constants.

Supervisors (k8s restart policies, the DEPLOY.md runbook) branch on
these numbers, so a raw literal drifting in some call site is an
operational bug: the supervisor reads "42" as watchdog-killed whether
or not the code that exited meant that. Every ``sys.exit``/``os._exit``
with a non-trivial code spells it through this table (0/1/2 are the
universal Unix conventions and may stay literal).

| code | name                | meaning                                    |
|------|---------------------|--------------------------------------------|
| 0    | EXIT_OK             | success                                    |
| 1    | EXIT_FAILURE        | generic failure                            |
| 2    | EXIT_USAGE          | bad usage / unreadable metrics or baseline |
| 3    | EXIT_RECOVERY_ABORT | divergence recovery gave up (RecoveryAbort)|
| 4    | EXIT_QUORUM_LOST    | too few live hosts for consensus           |
| 42   | EXIT_WATCHDOG_STALL | watchdog killed a stalled run              |

Adding a code: define the constant here and in the JAX package's table,
document it in DEPLOY.md, and teach the supervisor.
"""

EXIT_OK = 0
EXIT_FAILURE = 1
EXIT_USAGE = 2
EXIT_RECOVERY_ABORT = 3
EXIT_QUORUM_LOST = 4
EXIT_WATCHDOG_STALL = 42
