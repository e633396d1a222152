"""Metrics event registry — GENERATED, do not edit by hand.

Every event name the repo emits via ``metrics.log(...)`` with
the union of field names seen at its emit sites (``open`` =
some site forwards **kwargs, so the field set is not closed).
Consumers (obs/report.py, obs/monitor.py) may only filter on
names in this registry — lint rule SPK401 and
tests/test_torch_obs.py both enforce it; the latter also holds
it equal to the JAX package's registry.

Regenerate with:  python -m sparknet_tpu_torch lint --write-event-schema
"""

EVENTS = {
    'bench': {
        "fields": ['kind'],
        "open": True,
    },
    'bench_config': {
        "fields": ['device', 'iters_per_window', 'peak_bf16_flops', 'platform', 'warmup', 'windows'],
        "open": False,
    },
    'bench_headline': {
        "fields": [],
        "open": True,
    },
    'canary': {
        "fields": ['action', 'base_err_rate', 'base_p99_ms', 'baseline_sha', 'err_rate', 'p99_ms', 'pct', 'reason', 'requests', 'sha'],
        "open": False,
    },
    'chaos': {
        "fields": ['kind'],
        "open": True,
    },
    'checkpoint': {
        "fields": ['bytes', 'dropped', 'format', 'iter', 'kept', 'kind', 'model', 'refused', 'state'],
        "open": False,
    },
    'comms': {
        "fields": [],
        "open": True,
    },
    'config': {
        "fields": ['batch', 'd_model', 'dtype', 'fsdp', 'layers', 'loss_floor_nats', 'pipeline_stages', 'precision', 'seq_len', 'tp'],
        "open": False,
    },
    'device_cache': {
        "fields": ['hit_rate', 'hits', 'misses', 'nbytes', 'reason', 'records', 'resident', 'source'],
        "open": True,
    },
    'divergence': {
        "fields": [],
        "open": True,
    },
    'eviction': {
        "fields": [],
        "open": True,
    },
    'fsdp': {
        "fields": ['axis', 'hist_bytes_per_device', 'hist_bytes_replicated', 'iter', 'kind', 'min_size', 'param_bytes_per_device', 'param_bytes_replicated', 'sharded_leaves', 'total_leaves', 'world'],
        "open": False,
    },
    'ghost_reaped': {
        "fields": ['hosts', 'observer', 'orphaned_files'],
        "open": False,
    },
    'h2d_stage': {
        "fields": ['bytes', 'dispatch_ms', 'in_flight', 'kb_per_item', 'name', 'puts', 'slots', 'wait_ms'],
        "open": False,
    },
    'hbm': {
        "fields": ['iter'],
        "open": True,
    },
    'health': {
        "fields": ['cause', 'kind', 'severity'],
        "open": True,
    },
    'health_summary': {
        "fields": [],
        "open": True,
    },
    'host_alive': {
        "fields": ['alive', 'host', 'lease_age_s', 'observer'],
        "open": False,
    },
    'host_evicted': {
        "fields": ['host', 'live', 'reason', 'round'],
        "open": False,
    },
    'host_joined': {
        "fields": ['host', 'live', 'round', 'via', 'world'],
        "open": False,
    },
    'host_round': {
        "fields": ['arrived', 'dead', 'lease_age_s', 'mono', 'observer', 'round', 'wait_s'],
        "open": False,
    },
    'ingest': {
        "fields": ['hi', 'host', 'hosts', 'kind', 'lo', 'partitions', 'reads', 'records'],
        "open": False,
    },
    'membership': {
        "fields": ['agreed', 'from_world', 'hosts', 'kind', 'live', 'observer', 'quorum', 'round', 'sha', 'to_world', 'unit'],
        "open": True,
    },
    'memstats': {
        "fields": [],
        "open": True,
    },
    'moe': {
        "fields": ['eval_ce', 'expert_util', 'iter', 'overflow_fraction'],
        "open": True,
    },
    'parked': {
        "fields": ['lag', 'round', 'unit', 'worker'],
        "open": True,
    },
    'prefetch': {
        "fields": [],
        "open": True,
    },
    'readmission': {
        "fields": [],
        "open": True,
    },
    'recompile': {
        "fields": ['cache_size', 'first', 'iter', 'reason'],
        "open": False,
    },
    'recovery': {
        "fields": ['attempt', 'iter', 'kind', 'loss', 'lr_decay', 'reason', 'rollbacks', 'to_iter'],
        "open": False,
    },
    'relay_io': {
        "fields": ['bytes', 'host', 'mono', 'round', 'seconds'],
        "open": False,
    },
    'reshard': {
        "fields": ['direction', 'from_world', 'iter', 'n_from', 'n_to', 'owners', 'state', 'to_world'],
        "open": False,
    },
    'retry': {
        "fields": ['attempt', 'error', 'exhausted', 'where'],
        "open": False,
    },
    'round': {
        "fields": ['images_per_s', 'iter', 'loss', 'lr', 'round'],
        "open": False,
    },
    'route': {
        "fields": ['attempts', 'code', 'latency_ms', 'replica', 'retried', 'sha'],
        "open": False,
    },
    'scale': {
        "fields": ['action', 'breach_windows', 'live', 'p99_ms', 'queue_depth', 'reason', 'target'],
        "open": False,
    },
    'serve_batch': {
        "fields": ['bucket', 'fill', 'infer_ms', 'iter', 'queue_depth', 'requests', 'size', 'wait_ms'],
        "open": False,
    },
    'serve_reject': {
        "fields": ['limit', 'queue_depth', 'reason'],
        "open": False,
    },
    'serve_reload': {
        "fields": ['from_iter', 'iter', 'model', 'ms'],
        "open": False,
    },
    'serve_request': {
        "fields": ['bucket', 'latency_ms', 'rows', 'wait_ms'],
        "open": False,
    },
    'serve_summary': {
        "fields": ['batch_fill', 'batches', 'drained', 'latency_ms_p50', 'latency_ms_p95', 'latency_ms_p99', 'rejects', 'reloads', 'requests', 'rows', 'rps', 'uptime_s'],
        "open": False,
    },
    'serve_trace': {
        "fields": ['attempts', 'batch_ms', 'code', 'fulfill_ms', 'infer_ms', 'net_ms', 'queue_ms', 'replica', 'retried', 'server_ms', 'spans', 'src', 'tail', 'total_ms', 'trace'],
        "open": False,
    },
    'sim': {
        "fields": ['admissions', 'dead', 'evictions', 'hosts', 'live', 'parked', 'readmissions', 'round', 't_s', 'wait_s'],
        "open": False,
    },
    'slo_burn': {
        "fields": ['alert', 'bad', 'budget_left', 'fast', 'fast_long', 'good', 'slow', 'slow_long'],
        "open": False,
    },
    'span': {
        "fields": [],
        "open": True,
    },
    'staleness': {
        "fields": ['lag', 'park_rounds', 'parked', 'round', 's', 'version', 'weight'],
        "open": False,
    },
    'step': {
        "fields": [],
        "open": True,
    },
    'step_summary': {
        "fields": ['iter', 'name'],
        "open": True,
    },
    'summary': {
        "fields": ['final_loss', 'loss_floor_nats', 'steps', 'tokens_per_sec'],
        "open": False,
    },
    'test': {
        "fields": ['iter', 'metric', 'round', 'value'],
        "open": True,
    },
    'trace_align': {
        "fields": ['obs_mono', 'observer', 'peer', 'peer_mono', 'peer_stamp', 'seq'],
        "open": False,
    },
    'train': {
        "fields": ['images_per_sec', 'iter', 'loss', 'lr', 'tokens_per_sec'],
        "open": False,
    },
    'unparked': {
        "fields": [],
        "open": True,
    },
    'watchdog': {
        "fields": ['elapsed_s', 'emergency_snapshot_ok', 'exit_code', 'kind', 'loss'],
        "open": False,
    },
}

KINDS = ['abort', 'admission', 'coordinated_restart', 'exec', 'killed', 'mesh_shrunk', 'nan', 'params', 'plan', 'quorum_lost', 'recovery_armed', 'resume', 'rollback', 'serve', 'stall', 'summary', 'world_reset']

KINDS_OPEN = True
