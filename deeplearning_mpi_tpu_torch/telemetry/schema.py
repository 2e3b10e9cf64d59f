"""Canonical metric schema: the one list of instrument names and label
keys the port may emit.

A copy of the reference's ``telemetry/schema.py`` (``METRICS``,
``LABEL_KEYS``, ``is_canonical``), kept equal to it by
``tests/test_torch_telemetry.py``: the reconciliation invariants of the
serving and training books are arithmetic over metric names, and a
misspelt name is not an error anywhere at run time, only a column that is
always zero. Adding a metric is a two-line change: the call site and the
entry here (and in the reference).
"""

from __future__ import annotations

__all__ = ["LABEL_KEYS", "METRICS", "is_canonical"]

#: Every label key any ``labeled(...)`` call may use.
LABEL_KEYS: frozenset[str] = frozenset(
    {
        "direction",
        "dtype",
        "kind",
        "outcome",
        "reason",
        "replica",
        "role",
        "stage",
        "tenant",
    }
)

#: name -> (kind, {allowed label keys}). Kind is one of
#: "counter" | "gauge" | "histogram".
METRICS: dict[str, tuple[str, frozenset[str]]] = {
    # -- compilation service (PR 4, compiler/) ------------------------------
    "compile_cache_evicted_total": ("counter", frozenset()),
    "compile_cache_hit_total": ("counter", frozenset()),
    "compile_cache_miss_total": ("counter", frozenset()),
    "compile_cache_quarantined_total": ("counter", frozenset()),
    "compile_seconds": ("histogram", frozenset()),
    "train_compile_seconds": ("gauge", frozenset()),
    "xla_bytes_per_step": ("gauge", frozenset()),
    "xla_flops_per_step": ("gauge", frozenset()),
    # -- serving engine (PR 2/7/9, serving/) --------------------------------
    "serve_compile_seconds": ("histogram", frozenset()),
    "serve_compile_total": ("counter", frozenset()),
    "serve_decode_held_steps": ("counter", frozenset()),
    "serve_decode_steps": ("counter", frozenset()),
    "serve_handoff_depth": ("gauge", frozenset()),
    "serve_handoff_stalls_total": ("counter", frozenset()),
    "serve_handoffs_total": ("counter", frozenset()),
    "serve_kv_blocks_in_use": ("gauge", frozenset({"role"})),
    "serve_kv_bytes": ("gauge", frozenset({"dtype", "role"})),
    "serve_prefill_chunks": ("counter", frozenset()),
    # -- radix prefix cache + multi-tenancy (PR 11) --------------------------
    "serve_prefix_blocks": ("gauge", frozenset()),
    "serve_prefix_cow_copies_total": ("counter", frozenset()),
    "serve_prefix_evictions_total": ("counter", frozenset()),
    "serve_prefix_hits_total": ("counter", frozenset()),
    "serve_prefix_nodes": ("gauge", frozenset()),
    "serve_prefix_tokens_reused_total": ("counter", frozenset()),
    "serve_tenant_shed_total": ("counter", frozenset({"tenant"})),
    "serve_tenant_tokens_in_flight": ("gauge", frozenset({"tenant"})),
    "serve_queue_depth": ("gauge", frozenset({"role"})),
    "serve_requests_admitted": ("counter", frozenset()),
    "serve_requests_completed": ("counter", frozenset()),
    "serve_requests_shed": ("counter", frozenset()),
    "serve_requests_submitted": ("counter", frozenset()),
    "serve_requeued_total": ("counter", frozenset()),
    "serve_shed_total": ("counter", frozenset({"reason"})),
    "serve_slots_active": ("gauge", frozenset({"role"})),
    "serve_tokens_discarded_total": ("counter", frozenset()),
    "serve_tokens_generated": ("counter", frozenset()),
    "serve_tpot_s": ("histogram", frozenset()),
    "serve_ttft_s": ("histogram", frozenset({"replica"})),
    # -- speculative decode (PR 7) ------------------------------------------
    "spec_accepted_total": ("counter", frozenset()),
    "spec_blocks_rolled_back_total": ("counter", frozenset()),
    "spec_degraded_total": ("counter", frozenset()),
    "spec_draft_steps": ("counter", frozenset()),
    "spec_proposed_total": ("counter", frozenset()),
    "spec_rollback_total": ("counter", frozenset()),
    "spec_verify_steps": ("counter", frozenset()),
    # -- serving fleet + router (PR 8) --------------------------------------
    "fleet_redispatch_total": ("counter", frozenset()),
    "fleet_replica_failures_total": ("counter", frozenset({"kind"})),
    "fleet_replica_restarts_total": ("counter", frozenset()),
    "serve_hedge_total": ("counter", frozenset({"outcome"})),
    # -- fleet autoscaler (PR 13) -------------------------------------------
    "fleet_brownout_total": ("counter", frozenset({"stage"})),
    "fleet_replicas": ("gauge", frozenset()),
    "fleet_scale_total": ("counter", frozenset({"direction", "outcome"})),
    # -- control-plane crash safety (PR 20, resilience/cluster.py) ----------
    "supervisor_incarnation": ("gauge", frozenset()),
    "supervisor_journal_replay_s": ("gauge", frozenset()),
    "supervisor_readopted_total": ("counter", frozenset()),
    "supervisor_respawned_total": ("counter", frozenset()),
    # -- chaos / resilience (PR 3/5) ----------------------------------------
    "fault_injected_total": ("counter", frozenset({"kind"})),
    "recovery_latency_s": ("histogram", frozenset()),
    "recovery_total": ("counter", frozenset()),
    "rollback_total": ("counter", frozenset()),
    "train_restarts_total": ("counter", frozenset()),
    # -- numerics guardrails (PR 18, resilience/guardrails.py) --------------
    "guard_checks_total": ("counter", frozenset()),
    "guard_digest_mismatch_total": ("counter", frozenset()),
    "guard_digest_total": ("counter", frozenset()),
    "guard_poisoned_total": ("counter", frozenset()),
    "guard_quarantine_total": ("counter", frozenset()),
    "guard_rollback_total": ("counter", frozenset()),
    "guard_spike_total": ("counter", frozenset()),
    # -- elastic pod (PR 5) -------------------------------------------------
    "elastic_restore_total": ("counter", frozenset()),
    "pod_rank_failures_total": ("counter", frozenset({"kind"})),
    "pod_restarts_total": ("counter", frozenset()),
    "pod_straggler_flags_total": ("counter", frozenset()),
    "pod_world_size": ("gauge", frozenset()),
    # -- distributed tracing + flight recorder (PR 16, telemetry/spans.py) --
    "flight_dump_total": ("counter", frozenset({"reason"})),
    "span_dropped_total": ("counter", frozenset()),
    "span_recorded_total": ("counter", frozenset()),
    "trace_clock_offset_s": ("gauge", frozenset()),
    # -- load simulator (PR 19, sim/) ---------------------------------------
    "sim_brownout_max_stage": ("gauge", frozenset()),
    "sim_completed_total": ("counter", frozenset()),
    "sim_hedge_fired_total": ("counter", frozenset()),
    "sim_replica_seconds": ("gauge", frozenset()),
    "sim_requests_total": ("counter", frozenset()),
    "sim_shed_total": ("counter", frozenset({"reason"})),
    "sim_slo_attainment": ("gauge", frozenset()),
    "sim_slo_ok_total": ("counter", frozenset()),
    # -- runtime sanitizer (analysis/sanitizer.py) --------------------------
    "sanitize_donation_canary_trips_total": ("counter", frozenset()),
    "sanitize_kv_cow_violation_total": ("counter", frozenset()),
    "sanitize_kv_double_free_total": ("counter", frozenset()),
    "sanitize_kv_refcount_underflow_total": ("counter", frozenset()),
    "sanitize_kv_use_after_free_total": ("counter", frozenset()),
    "sanitize_retrace_trips_total": ("counter", frozenset()),
}


def is_canonical(name: str) -> bool:
    """True when ``name`` (a base instrument name, labels stripped) is in
    the schema."""
    return name.split("{", 1)[0] in METRICS
