"""Disaggregated prefill/decode serving in the PyTorch port: two port
engines on the CPU behind the port's server (``tiny``, float32, weights
carried from one JAX init, a 64 MiB host KV cache of 16-token blocks), one
``--kv-role prefill`` and one ``decode``.

Mirrors ``tests/engine/test_kv_transfer.py``'s HTTP handoff tests and
``tests/engine/test_kv_observability.py``:

- ``/kv/export`` then ``/kv/import``; a pull with prefill on a miss (the
  disaggregated hop), after which the decode replica's greedy ids equal
  the JAX engine's for the same prompt; ``X-GPUStack-KV-Source`` on a live
  request; a peer that dies mid-stream (the replica stays cold or partly
  warm, the request is served, the failure counted); a slow peer cut by
  ``GPUSTACK_TPU_KV_HANDOFF_TIMEOUT``;
- the frames an engine exports decode bit for bit in the JAX package's
  ``FrameDecoder``, and the JAX package's exports land in the port;
  ``encode_stream``, ``encode_block`` and ``prepare_import`` give the JAX
  package's bytes and arrays;
- the fleet fabric: ``conversation_chain`` is the proxy's, ``/kv/summary``
  reports a served conversation's resident blocks, ``/kv/pull`` lands the
  chain by its tail key;
- ``/metrics`` parses strictly with the handoff and prefetch families, the
  worker's normalizer reads the KV families, ``/healthz`` carries the
  role and the handoff counters.
"""

import dataclasses
import http.client
import json
import socket
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpustack_tpu.engine import kv_transfer as jax_kt
from gpustack_tpu.engine.engine import GenRequest as JaxGenRequest
from gpustack_tpu.engine.engine import LLMEngine as JaxLLMEngine
from gpustack_tpu.engine.kv_fabric import ConvIndex as JaxConvIndex
from gpustack_tpu.engine.kv_host_cache import HostKVCache as JaxHostKVCache
from gpustack_tpu.models import init_params
from gpustack_tpu.models.config import get_config as jax_get_config
from gpustack_tpu.server.resilience import (
    conversation_chain as jax_conversation_chain,
)
from gpustack_tpu.testing.promtext import (
    assert_well_formed,
    check_histograms,
    parse_exposition,
)
from gpustack_tpu_torch.engine import kv_transfer as kt  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.api_server import OpenAIServer, build_parser  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.engine import GenRequest, LLMEngine  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.kv_fabric import ConvIndex, conversation_chain  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.kv_host_cache import HostKVCache  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.weights import params_from_numpy  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models.config import get_config  # analysis: ignore[metrics-drift]

BT = 16
PROMPT = list(range(5, 5 + 40))       # 2 full blocks of 16 and a tail


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(jax_get_config("tiny"), dtype="float32")
    jparams = init_params(jcfg, jax.random.key(0), dtype=jnp.float32)
    return jcfg, jparams


def _engine(weights, role):
    _, jparams = weights
    cfg = dataclasses.replace(get_config("tiny"), dtype="float32")
    eng = LLMEngine(
        cfg, params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu"),
        max_slots=2, max_seq_len=128, device="cpu",
        host_kv_cache_mb=64, kv_block_tokens=BT, kv_role=role,
    )
    eng.start()
    server = OpenAIServer(eng, model_name=f"tiny-{role}")
    return eng, server, server.start("127.0.0.1", 0)


@pytest.fixture(scope="module")
def pair(weights):
    a, sa, pa = _engine(weights, "prefill")
    b, sb, pb = _engine(weights, "decode")
    yield (a, sa, pa), (b, sb, pb)
    for srv, eng in ((sa, a), (sb, b)):
        srv.shutdown()
        eng.stop()


def _request(port, method, path, body=None, headers=None, raw=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        data = raw if raw is not None else (
            None if body is None else json.dumps(body)
        )
        conn.request(method, path, body=data, headers={
            "Content-Type": "application/json", **(headers or {}),
        })
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _export_url(port):
    return f"http://127.0.0.1:{port}/kv/export"


def _wait_matchable(cache, ids, want, deadline=20.0):
    t0 = time.time()
    while cache.peek_prefix_len(ids) < want and time.time() - t0 < deadline:
        time.sleep(0.01)


def _greedy(eng, prompt, n=8):
    return eng.generate(GenRequest(prompt_ids=list(prompt), max_tokens=n,
                                   temperature=0.0), timeout=120)


def _jax_greedy(weights, prompt, n=8):
    jcfg, jparams = weights
    jeng = JaxLLMEngine(jcfg, jparams, max_slots=1, max_seq_len=128)
    jeng.start()
    try:
        return jeng.generate(JaxGenRequest(
            prompt_ids=list(prompt), max_tokens=n, temperature=0.0,
        ), timeout=300).output_ids
    finally:
        jeng.stop()


# ---------------------------------------------------------------------------
# engine to engine over HTTP
# ---------------------------------------------------------------------------


def test_http_export_import_roundtrip(pair):
    (a, _, pa), (b, _, pb) = pair
    _greedy(a, PROMPT, 1)
    _wait_matchable(a.host_kv_cache, PROMPT + [0], 32)
    out_before = a.kv_handoff.bytes_out
    status, wire = _request(pa, "POST", "/kv/export",
                            {"prompt_ids": PROMPT + [0], "have": []})
    assert status == 200 and wire.startswith(kt.MAGIC)
    status, raw = _request(pb, "POST", "/kv/import", raw=wire)
    assert status == 200, raw
    out = json.loads(raw)
    assert out["blocks_attached"] == 2 and out["tokens"] == 32
    assert b.host_kv_cache.peek_prefix_len(PROMPT + [0]) == 32
    assert a.kv_handoff.bytes_out - out_before == len(wire)
    assert b.kv_handoff.bytes_in >= out["bytes"] > 0


def test_pull_with_prefill_on_miss_matches_the_jax_engine(pair, weights):
    """A prompt neither engine has seen: the decode replica's pull asks
    the prefill replica to prefill it for export; then the decode
    replica reuses the imported blocks and its greedy ids equal the JAX
    engine's (and a cold port engine's)."""
    (a, sa, pa), (b, sb, pb) = pair
    prompt = list(range(60, 60 + 40))
    pulls, blocks_out = b.kv_handoff.pulls, a.kv_handoff.blocks_out
    got = sb.kv_prefetch(_export_url(pa), prompt)
    assert got["failed"] == "" and got["blocks"] == 2
    assert a.host_kv_cache.peek_prefix_len(prompt + [0]) >= 32
    assert b.host_kv_cache.peek_prefix_len(prompt + [0]) >= 32
    assert b.kv_handoff.pulls == pulls + 1
    assert a.kv_handoff.blocks_out - blocks_out == 2
    warm = _greedy(b, prompt)
    assert warm.prefix_tokens_reused == 32
    cold = _greedy(a, list(range(60, 60 + 40)))
    assert warm.output_ids == cold.output_ids
    assert warm.output_ids == _jax_greedy(weights, prompt)


def test_source_header_on_a_live_request_pulls_blocks(pair):
    (a, _, pa), (b, _, pb) = pair
    pulls, blocks_in = b.kv_handoff.pulls, b.kv_handoff.blocks_in
    reused = b.health()["kv_cache_prefix_tokens_reused"]
    status, raw = _request(
        pb, "POST", "/v1/completions",
        {"prompt": "alpha bravo charlie delta echo xx", "max_tokens": 4,
         "temperature": 0},
        headers={"X-GPUStack-KV-Source": _export_url(pa)},
    )
    assert status == 200, raw
    assert json.loads(raw)["choices"][0]["finish_reason"]
    assert b.kv_handoff.pulls == pulls + 1
    assert b.kv_handoff.blocks_in >= blocks_in + 2
    # the request itself reused what the pull landed
    assert b.health()["kv_cache_prefix_tokens_reused"] >= reused + 32


class _RawPeer:
    """A peer that answers ``/kv/export`` with ``payload`` and then either
    closes the connection (dying mid-stream) or stalls for ``stall_s``."""

    def __init__(self, payload: bytes, stall_s: float = 0.0):
        self.payload, self.stall_s = payload, stall_s
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(4)
        self.port = self.sock.getsockname()[1]
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self):
        conn, _ = self.sock.accept()
        with conn:
            conn.settimeout(5)
            buf = b""
            while b"\r\n\r\n" not in buf:
                buf += conn.recv(65536)
            head, _, body = buf.partition(b"\r\n\r\n")
            length = int([
                line.split(b":")[1] for line in head.split(b"\r\n")
                if line.lower().startswith(b"content-length")
            ][0])
            while len(body) < length:
                body += conn.recv(65536)
            conn.sendall(
                b"HTTP/1.1 200 OK\r\nContent-Type: application/x-gpustack-kv"
                b"\r\nContent-Length: 100000000\r\n\r\n" + self.payload
            )
            time.sleep(self.stall_s)

    def close(self):
        self.sock.close()
        self.thread.join(timeout=10)


def _source_frames(a, prompt):
    """The prefill replica's export of ``prompt`` (prefilled first)."""
    _greedy(a, prompt, 1)
    _wait_matchable(a.host_kv_cache, prompt + [0], 32)
    return b"".join(kt.export_frames(a.host_kv_cache, prompt + [0]))


def test_peer_death_mid_stream_cold_starts_cleanly(pair, weights):
    (a, _, _), (b, sb, _) = pair
    prompt = list(range(200, 200 + 40))
    fails = b.kv_handoff.failures
    peer = _RawPeer(kt.MAGIC + b"\x20\x00\x00\x00partial")
    try:
        got = sb.kv_prefetch(f"http://127.0.0.1:{peer.port}/kv/export",
                             prompt)
    finally:
        peer.close()
    assert got["failed"] and got["blocks"] == 0
    assert b.kv_handoff.failures == fails + 1
    assert b.host_kv_cache.peek_prefix_len(prompt + [0]) == 0
    # cold start: served, greedy-identical to a replica that never pulled
    cold_b = _greedy(b, prompt)
    assert cold_b.prefix_tokens_reused == 0
    assert cold_b.output_ids == _greedy(a, prompt).output_ids


def test_frames_before_a_peer_death_are_imported(pair):
    """Partly warm: the complete first frame lands, the cut second one
    does not, and the request is served over the one block."""
    (a, _, _), (b, sb, _) = pair
    prompt = [3 + (7 * i) % 250 for i in range(40)]
    wire = _source_frames(a, prompt)
    frames = kt.decode_stream(wire)
    cut = len(wire) - frames[-1].nbytes // 2
    fails = b.kv_handoff.failures
    peer = _RawPeer(wire[:cut])
    try:
        got = sb.kv_prefetch(f"http://127.0.0.1:{peer.port}/kv/export",
                             prompt)
    finally:
        peer.close()
    assert got["failed"] and got["blocks"] == 1
    assert b.kv_handoff.failures == fails + 1
    assert b.host_kv_cache.peek_prefix_len(prompt + [0]) == BT
    warm = _greedy(b, prompt)
    assert warm.prefix_tokens_reused == BT
    assert warm.output_ids == _greedy(a, prompt).output_ids


def test_slow_peer_is_cut_by_the_handoff_timeout(pair, monkeypatch):
    (_, _, _), (b, sb, _) = pair
    monkeypatch.setenv("GPUSTACK_TPU_KV_HANDOFF_TIMEOUT", "0.5")
    fails = b.kv_handoff.failures
    peer = _RawPeer(kt.MAGIC, stall_s=3.0)
    t0 = time.monotonic()
    try:
        got = sb.kv_prefetch(f"http://127.0.0.1:{peer.port}/kv/export",
                             [3 + (13 * i) % 250 for i in range(40)])
    finally:
        elapsed = time.monotonic() - t0
        peer.close()
    assert elapsed < 2.5
    assert got["failed"] and got["blocks"] == 0
    assert b.kv_handoff.failures == fails + 1


def test_corrupt_import_is_refused_and_counted(pair):
    (_, _, _), (b, _, pb) = pair
    fails = b.kv_handoff.failures
    status, raw = _request(pb, "POST", "/kv/import", raw=b"NOTMAGIC-xyz")
    assert status == 400
    assert "magic" in json.loads(raw)["error"]["message"]
    assert b.kv_handoff.failures == fails + 1


# ---------------------------------------------------------------------------
# the wire against the JAX package
# ---------------------------------------------------------------------------


def test_exported_frames_decode_bit_identically_in_jax_and_back(pair):
    (a, _, pa), _ = pair
    prompt = [3 + (11 * i) % 250 for i in range(40)]
    _greedy(a, prompt, 1)
    _wait_matchable(a.host_kv_cache, prompt + [0], 32)
    status, wire = _request(pa, "POST", "/kv/export",
                            {"prompt_ids": prompt + [0]})
    assert status == 200
    port_frames = kt.decode_stream(wire)
    jax_frames = jax_kt.decode_stream(wire)
    assert len(port_frames) == len(jax_frames) == 2
    for p, j in zip(port_frames, jax_frames):
        assert p.tokens == j.tokens and p.key == j.key
        assert p.k.tobytes() == j.k.tobytes()
        assert p.v.tobytes() == j.v.tobytes()
    # the JAX package's export of the same blocks lands in a port cache
    jcache = JaxHostKVCache(1 << 24, block_tokens=BT)
    k = np.concatenate([f.k for f in jax_frames], axis=1)
    v = np.concatenate([f.v for f in jax_frames], axis=1)
    jcache.insert_sequence(prompt[:32], k, v)
    jwire = b"".join(jax_kt.export_frames(jcache, prompt + [0]))
    assert jwire == wire
    dst = HostKVCache(1 << 24, block_tokens=BT)
    assert kt.import_frames(dst, kt.decode_stream(jwire))[0] == 2
    gk, _ = dst.gather_prefix(prompt + [0], 32)
    assert gk.tobytes() == k.tobytes()


@pytest.mark.parametrize("int8", [False, True])
def test_encode_block_stream_and_prepare_import_match_jax(int8):
    rng = np.random.default_rng(int8)
    tokens = list(range(3 * BT))
    k = rng.standard_normal((2, 3 * BT, 2, 4)).astype(np.float32)
    v = rng.standard_normal((2, 3 * BT, 2, 4)).astype(np.float32)
    pc = HostKVCache(1 << 24, block_tokens=BT, int8=int8)
    jc = JaxHostKVCache(1 << 24, block_tokens=BT, int8=int8)
    pc.insert_sequence(tokens, k, v)
    jc.insert_sequence(tokens, k, v)
    have = frozenset(pc.prefix_keys(tokens + [1])[:1])
    pblocks = pc.export_blocks(tokens + [1])
    jblocks = jc.export_blocks(tokens + [1])
    pframes = [kt.encode_block(b, have) for b in pblocks]
    jframes = [jax_kt.encode_block(b, have) for b in jblocks]
    assert pframes == jframes
    assert [c for _, c in pframes] == [False, True, True]
    wire = b"".join(kt.encode_stream(f for f, _ in pframes))
    assert wire == b"".join(jax_kt.encode_stream(f for f, _ in jframes))
    # the chain export by tail key is the same run as by prompt
    tail = pblocks[-1]["key"]
    assert [b["key"] for b in pc.export_chain(tail)] == [
        b["key"] for b in jc.export_chain(tail)
    ] == [b["key"] for b in pblocks]
    assert pc.export_chain("zz") == [] and pc.export_chain("00" * 32) == []
    # into a fresh cache of the other tier
    ptok, pprep, pbytes = kt.prepare_import(
        HostKVCache(1 << 24, block_tokens=BT, int8=not int8),
        kt.decode_stream(wire),
    )
    jtok, jprep, jbytes = jax_kt.prepare_import(
        JaxHostKVCache(1 << 24, block_tokens=BT, int8=not int8),
        jax_kt.decode_stream(wire),
    )
    assert ptok == jtok and pbytes == jbytes and pprep.keys() == jprep.keys()
    for i in pprep:
        for got, want in zip(pprep[i][:2], jprep[i][:2]):
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="block_tokens"):
        kt.prepare_import(HostKVCache(1 << 24, block_tokens=8),
                          kt.decode_stream(wire))


# ---------------------------------------------------------------------------
# the fleet fabric
# ---------------------------------------------------------------------------


def test_conversation_chain_and_summary_match_jax():
    msgs = [{"role": "system", "content": "be brief"},
            {"role": "user", "content": "hi"}, "raw"]
    chain = conversation_chain("m", msgs)
    assert chain == jax_conversation_chain("m", msgs)
    rng = np.random.default_rng(0)
    tokens = list(range(3 * BT + 5))
    k = rng.standard_normal((2, len(tokens), 2, 4)).astype(np.float32)
    pc, jc = HostKVCache(1 << 24, block_tokens=BT), JaxHostKVCache(
        1 << 24, block_tokens=BT)
    pc.insert_sequence(tokens, k, k)
    jc.insert_sequence(tokens, k, k)
    pidx, jidx = ConvIndex(), JaxConvIndex()
    for idx in (pidx, jidx):
        idx.record(chain, tokens)
        idx.record(conversation_chain("m", ["other"]), [9] * 40)
    assert pidx.summary(pc) == jidx.summary(jc)
    sharing = {chain[0]: 3}
    assert pidx.apply_sharing(pc, sharing) == jidx.apply_sharing(
        jc, sharing) == 3


def test_summary_reports_a_served_chat_and_pull_lands_its_chain(pair):
    (a, _, pa), (b, _, pb) = pair
    msgs = [{"role": "user", "content": "tell me about the fabric " * 3}]
    status, _ = _request(pa, "POST", "/v1/chat/completions", {
        "messages": msgs, "max_tokens": 4, "temperature": 0,
    })
    assert status == 200
    chain = conversation_chain("tiny-prefill", msgs)
    deadline = time.time() + 20
    while time.time() < deadline:
        status, raw = _request(pa, "POST", "/kv/summary", {})
        entry = json.loads(raw)["keys"].get(chain[-1])
        if entry and entry["tail"]:
            break
        time.sleep(0.05)
    assert status == 200 and entry["blocks"] >= 2, raw
    status, raw = _request(pa, "GET", "/kv/summary")
    assert status == 200 and chain[-1] in json.loads(raw)["keys"]
    ok_before = _prefetch(pb)["ok"]
    status, raw = _request(pb, "POST", "/kv/pull", {
        "source": _export_url(pa), "tail_key": entry["tail"],
    })
    assert status == 202 and json.loads(raw) == {"accepted": True}
    deadline = time.time() + 20
    while _prefetch(pb)["ok"] == ok_before and time.time() < deadline:
        time.sleep(0.05)
    assert _prefetch(pb)["ok"] == ok_before + 1
    assert b.host_kv_cache.export_chain(entry["tail"])
    status, _ = _request(pb, "POST", "/kv/pull", {"source": "x"})
    assert status == 400


def _prefetch(port):
    _, raw = _request(port, "GET", "/metrics")
    samples, _ = parse_exposition(raw.decode())
    return {
        s.labels["result"]: s.value for s in samples
        if s.name == "gpustack_kv_prefetch_total"
    }


# ---------------------------------------------------------------------------
# observability
# ---------------------------------------------------------------------------


def test_handoff_metrics_promtext_valid_and_health(pair):
    (a, _, pa), (b, _, pb) = pair
    _, raw = _request(pa, "GET", "/metrics")
    text = raw.decode()
    samples, types = parse_exposition(text)
    assert_well_formed(text)
    check_histograms(samples, types)
    for family, kind in (
        ("gpustack_kv_handoff_bytes_total", "counter"),
        ("gpustack_kv_handoff_blocks_total", "counter"),
        ("gpustack_kv_handoff_failures_total", "counter"),
        ("gpustack_kv_handoff_seconds", "histogram"),
        ("gpustack_kv_prefetch_total", "counter"),
        ("gpustack_kv_cache_hits", "counter"),
        ("gpustack_kv_cache_bytes", "gauge"),
    ):
        assert types[family] == kind, family
    out = [s for s in samples if s.name == "gpustack_kv_handoff_bytes_total"
           and s.labels["direction"] == "out"]
    assert out[0].value == a.kv_handoff.bytes_out > 0
    h = json.loads(_request(pa, "GET", "/healthz")[1])
    assert h["kv_role"] == "prefill"
    assert h["kv_handoff"]["bytes_out"] > 0
    assert json.loads(_request(pb, "GET", "/healthz")[1])["kv_role"] == (
        "decode"
    )


def test_worker_normalizes_the_port_kv_families(pair):
    from gpustack_tpu.worker.metrics_map import normalize_engine_metrics

    (_, _, pa), _ = pair
    text = _request(pa, "GET", "/metrics")[1].decode()
    normalized = "\n".join(
        normalize_engine_metrics(text, {"instance_id": "7"})
    )
    for name in ("kv_cache_hits", "kv_cache_misses",
                 "kv_cache_prefix_tokens_reused", "kv_cache_host_bytes"):
        assert f"gpustack_tpu:{name}" in normalized


def test_repeated_completion_prefix_hits_the_cache(pair):
    """The second identical completion reuses the first one's blocks: one
    prefix hit of at least two 16-token blocks (the JAX test reads the
    same count off its trace's ``kv_prefix_hit`` event)."""
    (a, _, pa), _ = pair
    body = {"prompt": "the quick brown fox jumps over the lazy dog " * 2,
            "max_tokens": 4, "temperature": 0}
    blocks = a.health()["kv_cache_blocks"]
    assert _request(pa, "POST", "/v1/completions", body)[0] == 200
    deadline = time.time() + 20
    while a.health()["kv_cache_blocks"] <= blocks and time.time() < deadline:
        time.sleep(0.05)
    h0 = a.health()
    assert _request(pa, "POST", "/v1/completions", body)[0] == 200
    h1 = a.health()
    assert h1["kv_cache_prefix_hits"] == h0["kv_cache_prefix_hits"] + 1
    assert (h1["kv_cache_prefix_tokens_reused"]
            - h0["kv_cache_prefix_tokens_reused"]) >= 32


def test_kv_role_is_checked_and_parsed():
    assert build_parser().parse_args(["--kv-role", "decode"]).kv_role == (
        "decode"
    )
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--kv-role", "relay"])
    cfg = dataclasses.replace(get_config("tiny"), dtype="float32")
    with pytest.raises(ValueError, match="kv_role"):
        LLMEngine(cfg, {}, device="cpu", kv_role="relay")
