"""On-demand profile capture of the PyTorch port (``capture_profile`` and
``POST /debug/profile``), on the CPU: ``torch.profiler`` in place of
``jax.profiler``. The four capture cases of
``tests/engine/test_flight_profile.py`` (a trace written, the degraded
path without a profiler, an idle capture that times out, a concurrent
capture refused), plus the HTTP route's answers.
"""

import dataclasses
import http.client
import json
import os
import threading
import time

import pytest
import torch

import gpustack_tpu_torch.engine.engine as engine_mod  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.api_server import OpenAIServer  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.engine import GenRequest, LLMEngine  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models.config import get_config  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models.transformer import init_params  # analysis: ignore[metrics-drift]


@pytest.fixture(scope="module")
def engine():
    cfg = dataclasses.replace(get_config("tiny"), dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         dtype=torch.float32, device="cpu")
    eng = LLMEngine(cfg, params, max_slots=2, max_seq_len=64, device="cpu")
    eng.start()
    yield eng
    eng.stop()


def _gen(engine, n=6):
    req = engine.submit(GenRequest(prompt_ids=[1, 2, 3], max_tokens=n,
                                   temperature=0.0))
    assert req.done.wait(60)


def _background_traffic(engine, n_reqs=3):
    def go():
        for _ in range(n_reqs):
            _gen(engine)

    t = threading.Thread(target=go)
    t.start()
    return t


def _quiesce(engine):
    deadline = time.time() + 10
    while (engine._pending or engine._slots) and time.time() < deadline:
        time.sleep(0.01)
    time.sleep(0.1)   # let the in-flight step seal its record


def test_capture_profile_with_torch_profiler(engine, tmp_path):
    out_dir = str(tmp_path / "prof")
    t = _background_traffic(engine)
    try:
        result = engine.capture_profile(8, out_dir=out_dir, timeout_s=30)
    finally:
        t.join(60)
    assert not t.is_alive()
    assert result["profiler"] == "torch", result["error"]
    assert result["artifact"] == out_dir
    assert result["steps_captured"] >= 1
    assert result["aggregate"]["steps"] == result["steps_captured"]
    assert result["profiler_start_ms"] >= 0
    trace = os.path.join(out_dir, engine_mod.PROFILE_TRACE_FILE)
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    # the scheduler thread's ops are in the trace
    assert any(e.get("cat") == "cpu_op" for e in events)


def test_capture_profile_degrades_without_profiler(
    engine, tmp_path, monkeypatch
):
    monkeypatch.setattr(engine_mod, "_torch_profiler", lambda: None)
    t = _background_traffic(engine)
    try:
        result = engine.capture_profile(
            5, out_dir=str(tmp_path / "x"), timeout_s=30
        )
    finally:
        t.join(60)
    assert result["profiler"] == "flight-only"
    assert result["artifact"] == ""
    assert "unavailable" in result["error"]
    assert result["steps_captured"] >= 1
    assert not os.path.exists(tmp_path / "x")


def test_capture_profile_idle_times_out_gracefully(engine):
    _quiesce(engine)
    result = engine.capture_profile(3, out_dir="", timeout_s=0.3)
    assert result["profiler"] == "flight-only"
    assert result["steps_captured"] == 0
    assert result["aggregate"] == {}


def test_capture_closed_by_the_scheduler_when_steps_run_out(engine, tmp_path):
    """Fewer busy steps than asked: the trace opened on the scheduler
    thread is closed there after the deadline, and still written."""
    _quiesce(engine)
    out_dir = str(tmp_path / "short")
    t = threading.Thread(target=lambda: (time.sleep(0.2), _gen(engine, 3)))
    t.start()
    try:
        result = engine.capture_profile(10_000, out_dir=out_dir, timeout_s=3)
    finally:
        t.join(60)
    assert result["profiler"] == "torch", result["error"]
    assert 1 <= result["steps_captured"] < 10_000
    assert os.listdir(out_dir) == [engine_mod.PROFILE_TRACE_FILE]
    # the engine captures again afterwards
    result = engine.capture_profile(1, out_dir="", timeout_s=0.2)
    assert result["error"] == ""


def test_capture_profile_concurrent_captures_rejected(engine):
    t = threading.Thread(
        target=lambda: engine.capture_profile(1000, out_dir="", timeout_s=1.0)
    )
    t.start()
    time.sleep(0.05)
    with pytest.raises(ValueError):
        engine.capture_profile(1, out_dir="", timeout_s=0.1)
    t.join(10)
    assert not t.is_alive()


def test_debug_profile_route(engine, tmp_path):
    server = OpenAIServer(engine, model_name="tiny-test")
    port = server.start("127.0.0.1", 0)

    def post(query):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        try:
            conn.request("POST", "/debug/profile?" + query)
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read())
        finally:
            conn.close()

    try:
        assert post("steps=0")[0] == 400
        assert post("steps=x")[0] == 400
        t = _background_traffic(engine, n_reqs=2)
        out_dir = str(tmp_path / "http")
        try:
            status, result = post(f"steps=4&timeout_s=30&out_dir={out_dir}")
        finally:
            t.join(60)
        assert status == 200, result
        assert result["profiler"] == "torch", result["error"]
        assert result["steps_captured"] >= 1
        assert os.path.exists(
            os.path.join(out_dir, engine_mod.PROFILE_TRACE_FILE)
        )
        holder = threading.Thread(
            target=lambda: engine.capture_profile(1000, timeout_s=1.0)
        )
        holder.start()
        time.sleep(0.05)
        status, body = post("steps=1&timeout_s=0.1")
        holder.join(10)
        assert status == 409 and "in progress" in body["error"]["message"]
    finally:
        server.shutdown()
