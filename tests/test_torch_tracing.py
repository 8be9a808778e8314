"""The engine's trace middleware in the PyTorch port, against the JAX
package's.

- The port's copy of ``observability/tracing.py`` against the JAX module
  on the same inputs: ``parse_traceparent`` and ``from_headers`` over a
  corpus of headers (valid, all-zero, malformed, a client request id that
  is a trace id or is hashed into one), ``child`` and the propagation
  headers, ``log_line`` of sealed entries, and ``TraceStore.query`` under
  each filter.
- The port's server (``tiny``, float32, one host KV tier of 16-token
  blocks) and the JAX server (aiohttp's test client) given the same
  requests: the same response headers (``X-Request-ID``, ``traceparent``
  with the caller's trace id and a fresh span id), the same stored hop
  (name, status, parent, request id), the same phase and event names
  (``kv_upload`` and ``kv_prefix_hit`` on a warm request, ``kv_handoff``
  on a decode replica's pull from a prefill replica) and the same
  ``trace=…`` log-line fields. A handler that raises is a 500 span, and
  the untraced paths leave no entry.
- Two deliberate differences: the port stamps the two headers on a
  Server-Sent Events response too (before its first byte), where the JAX
  middleware cannot, because its handler has already sent that response's
  headers when it returns; and an unknown path is a stamped 404 span in
  the port, where aiohttp's router raises its 404 through the JAX
  middleware as a 500 span with no headers.
"""

import asyncio
import dataclasses
import http.client
import json
import logging
import re
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpustack_tpu.engine.api_server import OpenAIServer as JaxServer
from gpustack_tpu.engine.engine import LLMEngine as JaxLLMEngine
from gpustack_tpu.models import init_params
from gpustack_tpu.models.config import get_config as jax_get_config
from gpustack_tpu.observability import tracing as jt
from gpustack_tpu_torch.engine.api_server import OpenAIServer  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.engine import LLMEngine  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.weights import params_from_numpy  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models.config import get_config  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.observability import tracing as pt  # analysis: ignore[metrics-drift]

BT = 16
TRACEPARENTS = [
    "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01",
    "00-" + "AB" * 16 + "-" + "CD" * 8 + "-00",       # upper case
    "  00-" + "12" * 16 + "-" + "34" * 8 + "-01  ",   # padded
    "00-" + "0" * 32 + "-" + "cd" * 8 + "-01",        # all-zero trace
    "00-" + "ab" * 16 + "-" + "0" * 16 + "-01",       # all-zero span
    "01-" + "ab" * 16 + "-" + "cd" * 8 + "-01",       # other version
    "00-" + "ab" * 15 + "-" + "cd" * 8 + "-01",       # short trace id
    "00-" + "zz" * 16 + "-" + "cd" * 8 + "-01",       # not hex
    "",
    "garbage",
]
HEADERS = [
    {"traceparent": TRACEPARENTS[0]},
    {"traceparent": TRACEPARENTS[0], "X-Request-ID": "client-42"},
    {"traceparent": TRACEPARENTS[0], "X-Request-ID": "x"},  # too short
    {"traceparent": TRACEPARENTS[3], "X-Request-ID": "client-42"},
    {"X-Request-ID": "Fe" * 16},                     # a trace id verbatim
    {"X-Request-ID": "order-7f3a.retry_2"},           # hashed into one
    {"X-Request-ID": "bad id with spaces"},
    {"traceparent": "garbage", "X-Request-ID": "abcd-1234"},
]
HEX16 = re.compile(r"^[0-9a-f]{16}$")
HEX32 = re.compile(r"^[0-9a-f]{32}$")
TRACEPARENT = re.compile(r"^00-([0-9a-f]{32})-([0-9a-f]{16})-01$")


def _ctx_fields(ctx):
    return None if ctx is None else (ctx.trace_id, ctx.parent_id,
                                     ctx.request_id)


@pytest.mark.parametrize("value", TRACEPARENTS)
def test_parse_traceparent_matches_jax(value):
    got, want = pt.parse_traceparent(value), jt.parse_traceparent(value)
    assert _ctx_fields(got) == _ctx_fields(want)
    if got is not None:
        assert HEX16.match(got.span_id) and got.span_id != want.span_id


@pytest.mark.parametrize("headers", HEADERS)
def test_from_headers_matches_jax(headers):
    got, want = pt.from_headers(headers), jt.from_headers(headers)
    if "traceparent" in headers or _adoptable(headers):
        assert _ctx_fields(got) == _ctx_fields(want)
    else:   # minted: fresh ids on both sides
        assert HEX32.match(got.trace_id) and got.request_id == got.trace_id
        assert got.parent_id == want.parent_id == ""


def _adoptable(headers):
    rid = headers.get("X-Request-ID", "")
    return bool(re.match(r"^[A-Za-z0-9._\-]{4,128}$", rid))


def test_minted_context_when_no_header():
    got, want = pt.from_headers({}), jt.from_headers({})
    for ctx in (got, want):
        assert HEX32.match(ctx.trace_id) and HEX16.match(ctx.span_id)
        assert ctx.parent_id == "" and ctx.request_id == ctx.trace_id
    assert got.trace_id != want.trace_id


def test_child_and_propagation_headers_match_jax():
    got = pt.TraceContext("ab" * 16, "cd" * 8, "ef" * 8, "req-9")
    want = jt.TraceContext("ab" * 16, "cd" * 8, "ef" * 8, "req-9")
    assert got.traceparent() == want.traceparent()
    assert got.propagation_headers() == want.propagation_headers()
    gc, wc = got.child(), want.child()
    assert _ctx_fields(gc) == _ctx_fields(wc) == ("ab" * 16, "cd" * 8,
                                                  "req-9")
    assert HEX16.match(gc.span_id) and gc.span_id != got.span_id


ENTRIES = [
    {"trace_id": "ab" * 16, "span_id": "cd" * 8, "component": "engine",
     "name": "POST /v1/completions", "status": 200, "outcome": "ok",
     "duration_ms": 12.345, "model": "", "request_id": "ab" * 16,
     "spans": []},
    {"trace_id": "ab" * 16, "span_id": "cd" * 8, "component": "engine",
     "name": "POST /v1/chat/completions", "status": 500,
     "outcome": "error", "duration_ms": 0.05, "model": "tiny",
     "request_id": "client-42",
     "spans": [{"phase": "kv_handoff", "duration_ms": 3.21},
               {"phase": "kv_upload", "duration_ms": 0.449}]},
]


@pytest.mark.parametrize("entry", ENTRIES)
def test_log_line_matches_jax(entry):
    assert pt.RequestTrace.log_line(entry) == jt.RequestTrace.log_line(entry)


def _fill(mod):
    """The same five sealed hops into a fresh store of each module."""
    store = mod.TraceStore(maxlen=4)
    for i in range(5):
        tr = mod.RequestTrace(
            mod.TraceContext(f"{i:032x}", f"{i:016x}"), "engine",
            f"POST /v1/{i}", model="m" if i % 2 else "",
        )
        tr.add_phase("kv_upload" if i % 2 else "connect", 0.001 * i)
        tr.event("kv_prefix_hit", tokens_reused=i)
        tr.finish(status=200 if i < 3 else 503, log=False)
        store.add(mod.get_store("engine").query(
            trace_id=f"{i:032x}", limit=1)[0])
    return store


QUERIES = [
    {}, {"trace_id": f"{3:032x}"}, {"trace_id": f"{0:032x}"},
    {"model": "m"}, {"phase": "kv_upload"}, {"outcome": "error"},
    {"limit": 2}, {"min_duration_ms": 1e9},
]


@pytest.mark.parametrize("query", QUERIES)
def test_store_query_matches_jax(query):
    def view(entries):
        return [(e["trace_id"], e["name"], e["status"], e["outcome"],
                 [p["phase"] for p in e["spans"]],
                 [ev["event"] for ev in e.get("events", [])])
                for e in entries]

    assert view(_fill(pt).query(**query)) == view(_fill(jt).query(**query))


# ---------------------------------------------------------------------------
# the servers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(jax_get_config("tiny"), dtype="float32")
    jparams = init_params(jcfg, jax.random.key(0), dtype=jnp.float32)
    return jcfg, jparams


def _port_engine(weights, role=""):
    _, jparams = weights
    cfg = dataclasses.replace(get_config("tiny"), dtype="float32")
    eng = LLMEngine(
        cfg, params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu"),
        max_slots=2, max_seq_len=128, device="cpu",
        host_kv_cache_mb=64, kv_block_tokens=BT, kv_role=role,
    )
    eng.start()
    server = OpenAIServer(eng, model_name="tiny-trace")
    return eng, server, server.start("127.0.0.1", 0)


@pytest.fixture(scope="module")
def port_side(weights):
    """A plain replica, a prefill replica and a decode replica."""
    made = {role: _port_engine(weights, role)
            for role in ("", "prefill", "decode")}
    yield made
    for eng, server, _ in made.values():
        server.shutdown()
        eng.stop()


@pytest.fixture(scope="module")
def jax_engine(weights):
    jcfg, jparams = weights
    eng = JaxLLMEngine(jcfg, jparams, max_slots=2, max_seq_len=128,
                       host_kv_cache_mb=64, kv_block_tokens=BT)
    eng.start()
    yield eng
    eng.stop()


def _port_call(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request(method, path,
                     body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json",
                              **(headers or {})})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _jax_calls(engine, calls):
    """[(method, path, body, headers)] through the JAX server's middleware;
    returns [(status, headers, body)]."""
    from aiohttp.test_utils import TestClient, TestServer

    async def run():
        client = TestClient(TestServer(
            JaxServer(engine, model_name="tiny-trace").app))
        await client.start_server()
        out = []
        try:
            for method, path, body, headers in calls:
                r = await client.request(
                    method, path, headers=headers or {},
                    json=body if body is not None else None,
                )
                out.append((r.status, dict(r.headers), await r.read()))
        finally:
            await client.close()
        return out

    return asyncio.run(run())


def _settle(eng):
    """Let a finished request's KV store land before the next probe."""
    pool = getattr(eng, "_kv_copy_pool", None)
    if pool is not None:
        pool.submit(lambda: None).result()
    time.sleep(0.3)


def _hop(store, trace_id):
    """The newest hop of ``trace_id``; a server seals it just after the
    response's last byte, so wait for it a little."""
    deadline = time.monotonic() + 10
    entries = store.query(trace_id=trace_id)
    while not entries and time.monotonic() < deadline:
        time.sleep(0.01)
        entries = store.query(trace_id=trace_id)
    assert entries, f"no engine hop stored for trace {trace_id}"
    return entries[0]


def _same_hop(got, want):
    for key in ("trace_id", "parent_id", "request_id", "component", "name",
                "status", "outcome"):
        assert got[key] == want[key], key
    assert HEX16.match(got["span_id"])


TRACED_BODY = {
    "prompt": "the quick brown fox jumps over the lazy dog " * 2,
    "max_tokens": 4, "temperature": 0,
}


def _check_stamped(headers, trace_id, request_id):
    m = TRACEPARENT.match(headers["traceparent"])
    assert m and m.group(1) == trace_id
    assert headers["X-Request-ID"] == request_id
    return m.group(2)


def test_completion_headers_and_hop_match_jax(port_side, jax_engine):
    eng, _, port = port_side[""]
    tp = "00-" + "a1" * 16 + "-" + "b2" * 8 + "-01"
    hdr = {"traceparent": tp, "X-Request-ID": "client-77"}
    got = _port_call(port, "POST", "/v1/completions", TRACED_BODY, hdr)
    want = _jax_calls(jax_engine, [("POST", "/v1/completions", TRACED_BODY,
                                    hdr)])[0]
    assert got[0] == want[0] == 200
    span_got = _check_stamped(got[1], "a1" * 16, "client-77")
    span_want = _check_stamped(want[1], "a1" * 16, "client-77")
    assert span_got != "b2" * 8 and span_want != "b2" * 8
    hop_got = _hop(pt.get_store("engine"), "a1" * 16)
    hop_want = _hop(jt.get_store("engine"), "a1" * 16)
    _same_hop(hop_got, hop_want)
    assert hop_got["parent_id"] == "b2" * 8
    assert hop_got["span_id"] == span_got
    _settle(eng)


def test_warm_request_traces_kv_upload_and_prefix_hit_as_jax(
    port_side, jax_engine
):
    """A repeated completion prefix-hits the host tier: both hops carry a
    ``kv_upload`` span and a ``kv_prefix_hit`` event with the same
    reused-token count."""
    eng, _, port = port_side[""]
    tid = "c3" * 16
    hdr = {"traceparent": f"00-{tid}-{'12' * 8}-01"}
    _port_call(port, "POST", "/v1/completions", TRACED_BODY, hdr)
    _settle(eng)
    _port_call(port, "POST", "/v1/completions", TRACED_BODY, hdr)

    blocks = jax_engine.health()["kv_cache_blocks"]
    _jax_calls(jax_engine, [("POST", "/v1/completions", TRACED_BODY, hdr)])
    deadline = time.time() + 30
    while (jax_engine.health()["kv_cache_blocks"] <= blocks
           and time.time() < deadline):
        time.sleep(0.05)
    _jax_calls(jax_engine, [("POST", "/v1/completions", TRACED_BODY, hdr)])

    got, want = _hop(pt.get_store("engine"), tid), _hop(
        jt.get_store("engine"), tid)
    _same_hop(got, want)
    assert [p["phase"] for p in got["spans"]] == [
        p["phase"] for p in want["spans"]] == ["kv_upload"]
    assert [(e["event"], e["attrs"]) for e in got["events"]] == [
        (e["event"], e["attrs"]) for e in want["events"]]
    assert got["events"][0]["attrs"]["tokens_reused"] >= 2 * BT


def test_decode_replica_traces_kv_handoff_as_jax(port_side, jax_engine):
    """A completion to a decode replica with ``X-GPUStack-KV-Source``: the
    port's decode replica and the JAX one pull the prompt's blocks from
    the port's prefill replica, and both hops carry a ``kv_handoff`` span
    and event with the same attributes."""
    _, _, prefill_port = port_side["prefill"]
    _, _, decode_port = port_side["decode"]
    source = f"http://127.0.0.1:{prefill_port}/kv/export"
    body = dict(TRACED_BODY, prompt="handoff " * 12)
    tid_got, tid_want = "d4" * 16, "e5" * 16
    got = _port_call(decode_port, "POST", "/v1/completions", body, {
        "traceparent": f"00-{tid_got}-{'34' * 8}-01",
        "X-GPUStack-KV-Source": source,
    })
    want = _jax_calls(jax_engine, [("POST", "/v1/completions", body, {
        "traceparent": f"00-{tid_want}-{'34' * 8}-01",
        "X-GPUStack-KV-Source": source,
    })])[0]
    assert got[0] == want[0] == 200
    hg = _hop(pt.get_store("engine"), tid_got)
    hw = _hop(jt.get_store("engine"), tid_want)
    assert "kv_handoff" in [p["phase"] for p in hg["spans"]]
    assert [p["phase"] for p in hg["spans"] if p["phase"] == "kv_handoff"] \
        == [p["phase"] for p in hw["spans"] if p["phase"] == "kv_handoff"]
    eg = [e for e in hg["events"] if e["event"] == "kv_handoff"]
    ew = [e for e in hw["events"] if e["event"] == "kv_handoff"]
    assert len(eg) == len(ew) == 1
    assert eg[0]["attrs"] == ew[0]["attrs"]
    assert eg[0]["attrs"]["source"] == source
    assert eg[0]["attrs"]["blocks"] >= 2 and "failed" not in eg[0]["attrs"]


def test_streamed_chat_is_stamped_before_its_first_byte(port_side,
                                                          jax_engine):
    _, _, port = port_side[""]
    body = {"messages": [{"role": "user", "content": "hi"}],
            "max_tokens": 3, "stream": True}
    hdr = {"X-Request-ID": "stream-req-1"}
    got = _port_call(port, "POST", "/v1/chat/completions", body, hdr)
    want = _jax_calls(jax_engine, [("POST", "/v1/chat/completions", body,
                                    hdr)])[0]
    assert got[0] == want[0] == 200
    assert got[1]["Content-Type"] == "text/event-stream"
    assert got[2].rstrip().endswith(b"data: [DONE]")
    digest = pt.from_headers(hdr).trace_id
    span = _check_stamped(got[1], digest, "stream-req-1")
    # the JAX handler has sent its stream's headers before the middleware
    # sees the response, so it stamps none (the deliberate difference)
    assert "traceparent" not in want[1]
    hop_got = _hop(pt.get_store("engine"), digest)
    _same_hop(hop_got, _hop(jt.get_store("engine"), digest))
    assert hop_got["span_id"] == span and hop_got["request_id"] == (
        "stream-req-1")


@pytest.mark.parametrize("path", ["/healthz", "/metrics", "/debug/flight"])
def test_untraced_paths_leave_no_entry(port_side, jax_engine, path):
    _, _, port = port_side[""]
    tid = f"{abs(hash(path)) % (1 << 64):016x}" * 2
    hdr = {"traceparent": f"00-{tid}-{'56' * 8}-01"}
    got = _port_call(port, "GET", path, headers=hdr)
    want = _jax_calls(jax_engine, [("GET", path, None, hdr)])[0]
    assert got[0] == want[0] == 200
    assert "traceparent" not in got[1] and "X-Request-ID" not in got[1]
    assert "traceparent" not in want[1]
    assert pt.get_store("engine").query(trace_id=tid) == []
    assert jt.get_store("engine").query(trace_id=tid) == []


def test_models_route_is_traced_as_jax(port_side, jax_engine):
    _, _, port = port_side[""]
    tid = "f6" * 16
    hdr = {"traceparent": f"00-{tid}-{'78' * 8}-01"}
    got = _port_call(port, "GET", "/v1/models", headers=hdr)
    want = _jax_calls(jax_engine, [("GET", "/v1/models", None, hdr)])[0]
    assert got[0] == want[0] == 200
    _check_stamped(got[1], tid, tid)
    _check_stamped(want[1], tid, tid)
    _same_hop(_hop(pt.get_store("engine"), tid),
              _hop(jt.get_store("engine"), tid))


def test_unknown_path_is_a_stamped_404_span(port_side, jax_engine):
    """An unknown path: the port answers 404 with the trace headers and
    records a 404 span. aiohttp's router raises its 404 through the JAX
    middleware, which records that hop as a 500 and stamps nothing (the
    second deliberate difference)."""
    _, _, port = port_side[""]
    tid = "f7" * 16
    hdr = {"traceparent": f"00-{tid}-{'78' * 8}-01"}
    got = _port_call(port, "GET", "/nope", headers=hdr)
    want = _jax_calls(jax_engine, [("GET", "/nope", None, hdr)])[0]
    assert got[0] == want[0] == 404
    _check_stamped(got[1], tid, tid)
    assert "traceparent" not in want[1]
    hop_got = _hop(pt.get_store("engine"), tid)
    hop_want = _hop(jt.get_store("engine"), tid)
    assert (hop_got["status"], hop_got["outcome"]) == (404, "ok")
    assert (hop_want["status"], hop_want["outcome"]) == (500, "error")
    assert hop_got["name"] == hop_want["name"] == "GET /nope"


def test_handler_exception_is_a_500_span(port_side, monkeypatch):
    """A route that raises: the hop still finishes, as a 500 (the JAX
    middleware's ``finally``)."""
    _, server, port = port_side[""]

    def boom():
        raise RuntimeError("injected")

    monkeypatch.setattr(server, "models", boom)
    tid = "9a" * 16
    with pytest.raises((http.client.HTTPException, OSError)):
        _port_call(port, "GET", "/v1/models",
                   headers={"traceparent": f"00-{tid}-{'9b' * 8}-01"})
    hop = _hop(pt.get_store("engine"), tid)
    assert hop["status"] == 500 and hop["outcome"] == "error"


def _fields(line):
    return [part.split("=", 1)[0] for part in line.split(" ")
            if "=" in part and not part.startswith("[")]


def test_log_line_fields_match_jax(port_side, jax_engine, caplog):
    _, _, port = port_side[""]
    hdr = {"traceparent": f"00-{'4c' * 16}-{'5d' * 8}-01",
           "X-Request-ID": "log-req-1"}
    with caplog.at_level(logging.INFO):
        _port_call(port, "POST", "/v1/completions", TRACED_BODY, hdr)
        _jax_calls(jax_engine, [("POST", "/v1/completions", TRACED_BODY,
                                 hdr)])
    lines = {rec.name: rec.getMessage() for rec in caplog.records
             if rec.getMessage().startswith(f"trace={'4c' * 16}")}
    got = lines["gpustack_tpu_torch.observability.tracing"]  # analysis: ignore[metrics-drift]
    want = lines["gpustack_tpu.observability.tracing"]
    assert _fields(got) == _fields(want)
    assert "req=log-req-1" in got and "req=log-req-1" in want
