"""The PyTorch port's engine telemetry: the flight recorder against the JAX
package's, and ``/metrics`` and ``/debug/flight`` on the port's stdlib
server.

The flight recorder tests mirror ``tests/observability/test_flight.py``
(ring bounds, aggregates, exposition) without its wall-clock overhead
assertion, and feed the same records to both packages' recorders: the
aggregates and the exposition must agree exactly apart from the
self-measured overhead. The server tests serve ``tiny`` (float32, CPU)
with chunked prefill and the host KV cache, and hold ``/metrics`` to the
strict Prometheus text parser of the JAX package's test helpers; every
family it emits must be one the JAX engine's exporter declares.
"""

import dataclasses
import http.client
import json
import re
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpustack_tpu.models import init_params
from gpustack_tpu.models.config import get_config as jax_get_config
from gpustack_tpu.observability import flight as jax_flight
from gpustack_tpu.observability.metrics import METRIC_FAMILIES as JAX_FAMILIES
from gpustack_tpu.testing import promtext
from gpustack_tpu_torch.engine.api_server import OpenAIServer, build_parser  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.engine import LLMEngine  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.weights import params_from_numpy  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models.config import get_config  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.observability import metrics as port_metrics  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.observability.flight import (  # analysis: ignore[metrics-drift]
    FlightRecorder,
    aggregate_records,
)


def _rec(fr, **kw):
    base = dict(
        dur_s=0.002, mode="decode", slots_used=2, waiting=0,
        oldest_wait_s=0.0, tokens_real=2, tokens_padded=4, tokens_out=2,
    )
    base.update(kw)
    fr.record(**base)


RECORDS = [
    dict(mode="prefill", tokens_real=10, tokens_padded=16, tokens_out=1,
         slots_used=1, prompt_tokens=10, dur_s=0.03),
    dict(mode="prefill_chunk", tokens_real=32, tokens_padded=32,
         prompt_tokens=32, kv_blocks=3, kv_reused_total=48, dur_s=0.2),
    dict(mode="decode", tokens_real=2, tokens_padded=4, tokens_out=2,
         host_overlap_s=0.001),
    dict(mode="decode", waiting=3, oldest_wait_s=0.5, dur_s=0.0004),
]


# ---------------------------------------------------------------------------
# flight recorder (mirrors tests/observability/test_flight.py)
# ---------------------------------------------------------------------------


def test_ring_is_bounded_and_counters_survive():
    fr = FlightRecorder(slots_total=4, capacity=16)
    for _ in range(100):
        _rec(fr)
    assert len(fr.snapshot(limit=1000)) == 16
    assert fr.tokens_out_total == 200
    _rec(fr, tokens_out=7)
    assert fr.snapshot(limit=1)[0]["tokens_out"] == 7


def test_aggregate_padding_waste_occupancy_and_window():
    fr = FlightRecorder(slots_total=4)
    assert fr.aggregate()["steps"] == 0
    _rec(fr, mode="prefill", tokens_real=10, tokens_padded=16,
         tokens_out=1, slots_used=1, prompt_tokens=10)
    _rec(fr, mode="decode", tokens_real=2, tokens_padded=4, tokens_out=2)
    agg = fr.aggregate()
    assert agg["tokens_real"] == 12 and agg["tokens_padded"] == 20
    assert agg["padding_waste_pct"] == 40.0
    assert agg["prompt_tokens"] == 10 and agg["tokens_out"] == 3
    assert set(agg["modes"]) == {"prefill", "decode"}
    assert 0.0 < agg["occupancy_p50"] <= 0.5
    fr._ring[0] = (time.time() - 3600,) + fr._ring[0][1:]
    assert fr.aggregate(window_s=60)["steps"] == 1
    assert aggregate_records(fr.snapshot(limit=1), 4)["steps"] == 1


def test_exposition_parses_strictly_with_declared_families():
    fr = FlightRecorder(slots_total=4)
    _rec(fr, mode="prefill", tokens_real=10, tokens_padded=16,
         prompt_tokens=10)
    _rec(fr, mode="decode")
    fr.note_rollback(3)
    text = "\n".join(fr.metrics_lines()) + "\n"
    samples, types = promtext.assert_well_formed(
        text, require_histograms=["gpustack_engine_step_seconds"]
    )
    for family, kind in types.items():
        assert port_metrics.METRIC_FAMILIES[family] == kind
    by = {}
    for s in samples:
        by.setdefault(s.name, []).append(s)
    real = [s for s in by["gpustack_engine_dispatched_tokens_total"]
            if s.labels.get("kind") == "real"]
    assert real[0].value == 12
    assert by["gpustack_engine_rollback_tokens_total"][0].value == 3
    assert {
        s.labels["mode"] for s in by["gpustack_engine_step_seconds_count"]
    } == {"prefill", "decode"}


def test_declared_families_are_the_jax_packages():
    for family, kind in port_metrics.METRIC_FAMILIES.items():
        assert JAX_FAMILIES.get(family) == kind, family


def test_flight_matches_jax_recorder():
    """The same records through both recorders: equal aggregates (less the
    wall-clock span and self-measured overhead) and equal exposition
    (less the overhead gauge)."""
    recorders = (FlightRecorder(8), jax_flight.FlightRecorder(8))
    for fr in recorders:
        for r in RECORDS:
            _rec(fr, **r)
        fr.note_idle_wait(0.25)
        fr.note_rollback(2)
    port, jaxr = recorders
    drop = ("overhead_ratio", "tokens_out_per_s")
    a, b = port.aggregate(), jaxr.aggregate()
    assert {k: v for k, v in a.items() if k not in drop} == {
        k: v for k, v in b.items() if k not in drop
    }
    assert [
        {k: v for k, v in r.items() if k != "ts"} for r in port.snapshot()
    ] == [{k: v for k, v in r.items() if k != "ts"} for r in jaxr.snapshot()]

    def lines(fr):
        return [
            ln for ln in fr.metrics_lines()
            if not ln.startswith("gpustack_engine_flight_overhead_ratio")
        ]

    assert lines(port) == lines(jaxr)


# ---------------------------------------------------------------------------
# /metrics and /debug/flight on the stdlib server
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    jcfg = dataclasses.replace(jax_get_config("tiny"), dtype="float32")
    jparams = init_params(jcfg, jax.random.key(0), dtype=jnp.float32)
    cfg = dataclasses.replace(get_config("tiny"), dtype="float32")
    eng = LLMEngine(
        cfg, params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu"),
        max_slots=2, max_seq_len=256, device="cpu", prefill_chunk=32,
        host_kv_cache_mb=16, kv_block_tokens=16, kv_spill_mb=4,
        kv_spill_dir=str(tmp_path_factory.mktemp("spill")),
    )
    eng.start()
    server = OpenAIServer(eng, model_name="tiny-test")
    port = server.start("127.0.0.1", 0)
    prompt = "the same long prompt, twice. " * 3
    for _ in range(2):
        _request(port, "POST", "/v1/completions", {
            "prompt": prompt, "max_tokens": 4, "temperature": 0,
        })
        eng._kv_copy_pool.submit(lambda: None).result(timeout=60)
    yield port, eng
    server.shutdown()
    eng.stop()


def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(
            method, path,
            body=None if body is None else json.dumps(body),
            headers={"Content-Type": "application/json"},
        )
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


def _jax_exporter_families():
    """Every family the JAX engine's exporter declares: its vocabulary
    plus the ``# TYPE`` names written in its source."""
    import gpustack_tpu.engine.api_server as jax_server

    with open(jax_server.__file__) as f:
        src = f.read()
    names = set(re.findall(r"# TYPE (gpustack_[a-z_]+) ", src))
    names |= set(re.findall(  # latency histograms named in a tuple
        r'\("(gpustack_engine_[a-z0-9]+_seconds)"', src  # analysis: ignore[metrics-drift]
    ))
    return names | set(JAX_FAMILIES)


def test_metrics_is_strict_prometheus_text(served):
    port, eng = served
    status, ctype, raw = _request(port, "GET", "/metrics")
    assert status == 200 and ctype.startswith("text/plain")
    samples, types = promtext.assert_well_formed(
        raw.decode(), require_histograms=[
            "gpustack_engine_ttft_seconds", "gpustack_engine_step_seconds",
        ],
    )
    assert set(types) <= _jax_exporter_families()
    value = {s.name: s.value for s in samples if not s.labels}
    _, _, health = _request(port, "GET", "/healthz")
    h = json.loads(health)
    assert h["kv_cache_hits"] == 1 and h["kv_cache_prefix_hits"] == 1
    assert value["gpustack_kv_cache_hits"] == h["kv_cache_hits"]
    assert value["gpustack_kv_cache_misses"] == h["kv_cache_misses"]
    assert value["gpustack_kv_cache_prefix_tokens_reused"] == (
        h["kv_cache_prefix_tokens_reused"]
    )
    assert value["gpustack_engine_tokens_generated_total"] == (
        h["tokens_generated"]
    )
    assert "gpustack_kv_spill_resident_bytes" in types
    assert value["gpustack_engine_ttft_seconds_count"] == 2


def test_debug_flight_serves_records_and_aggregates(served):
    port, _ = served
    status, _, raw = _request(port, "GET", "/debug/flight?limit=500")
    assert status == 200
    data = json.loads(raw)
    assert data["model"] == "tiny-test"
    modes = {r["mode"] for r in data["records"]}
    assert {"prefill_chunk", "decode"} <= modes
    agg = data["aggregate"]
    assert agg["steps"] == len(data["records"])
    assert agg["prompt_tokens"] == sum(
        r["prompt_tokens"] for r in data["records"]
    )
    _, _, raw = _request(port, "GET", "/debug/flight?limit=1&window_s=3600")
    one = json.loads(raw)
    assert len(one["records"]) == 1 and one["aggregate"]["steps"] >= 1
    status, _, _ = _request(port, "GET", "/debug/flight?limit=x")
    assert status == 400


def test_flags_reach_the_engine():
    args = build_parser().parse_args([
        "--preset", "tiny", "--prefill-chunk", "512",
        "--host-kv-cache-mb", "4096", "--kv-block-tokens", "128",
        "--kv-cache-int8", "--kv-spill-mb", "64", "--kv-spill-dir", "/x",
    ])
    assert (args.prefill_chunk, args.host_kv_cache_mb, args.kv_block_tokens,
            args.kv_cache_int8, args.kv_spill_mb, args.kv_spill_dir) == (
        512, 4096, 128, True, 64, "/x"
    )
    off = build_parser().parse_args([])
    assert (off.prefill_chunk, off.host_kv_cache_mb, off.kv_spill_mb,
            off.kv_cache_int8) == (0, 0, 0, False)
