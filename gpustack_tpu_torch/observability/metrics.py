"""Declared Prometheus families the port's engine exporter emits.

The subset of ``gpustack_tpu/observability/metrics.py`` ``METRIC_FAMILIES``
that the port renders on ``/metrics``: the host KV cache, its disk spill
tier, the disaggregated KV handoff, the fleet prefetch and the flight
recorder. Names and kinds are the JAX package's, so the worker's metric
normalization and the fleet dashboards read an engine of either package
alike.
"""

METRIC_FAMILIES = {
    # host-RAM block KV cache (engine/kv_host_cache.py)
    "gpustack_kv_cache_hits": "counter",
    "gpustack_kv_cache_misses": "counter",
    "gpustack_kv_cache_prefix_tokens_reused": "counter",
    "gpustack_kv_cache_bytes": "gauge",
    # disaggregated KV handoff (engine/kv_transfer.py): wire bytes and
    # blocks per direction (label direction=in|out), pull failures, and
    # end-to-end pull seconds
    "gpustack_kv_handoff_bytes_total": "counter",
    "gpustack_kv_handoff_blocks_total": "counter",
    "gpustack_kv_handoff_failures_total": "counter",
    "gpustack_kv_handoff_seconds": "histogram",
    # disk spill tier under the host cache (engine/kv_spill.py): bytes and
    # blocks per direction (out spilled to disk, in faulted back)
    "gpustack_kv_spill_bytes_total": "counter",
    "gpustack_kv_spill_blocks_total": "counter",
    "gpustack_kv_spill_resident_bytes": "gauge",
    "gpustack_kv_spill_corrupt_total": "counter",
    "gpustack_kv_spill_evictions_total": "counter",
    "gpustack_kv_spill_faultbacks_total": "counter",
    # background fleet prefetch pulls landed by this engine (POST
    # /kv/pull; label result=ok|failed)
    "gpustack_kv_prefetch_total": "counter",
    # engine flight recorder (observability/flight.py)
    "gpustack_engine_step_seconds": "histogram",
    "gpustack_engine_dispatched_tokens_total": "counter",
    "gpustack_engine_prompt_tokens_total": "counter",
    "gpustack_engine_occupancy_ratio": "gauge",
    "gpustack_engine_queue_oldest_wait_seconds": "gauge",
    "gpustack_engine_queue_depth": "gauge",
    "gpustack_engine_spec_proposed_total": "counter",
    "gpustack_engine_spec_accepted_total": "counter",
    "gpustack_engine_kv_blocks_used": "gauge",
    "gpustack_engine_flight_overhead_ratio": "gauge",
    "gpustack_engine_host_overlap_ratio": "gauge",
    "gpustack_engine_idle_wait_seconds_total": "counter",
    "gpustack_engine_rollback_tokens_total": "counter",
}


def type_line(family: str) -> str:
    """``# TYPE`` line of a declared family (KeyError for an undeclared
    one: the exporter emits no name outside the vocabulary)."""
    return f"# TYPE {family} {METRIC_FAMILIES[family]}"
