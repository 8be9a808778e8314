"""The PyTorch port's audio server (stdlib, port 0) against the JAX audio
server (aiohttp's test client, as ``tests/engine/test_audio_server.py``
drives it): the same requests, byte for byte, to both, on the same fp32
weights carried across with ``params_from_numpy``; bodies and status codes
must agree (transcripts identical, synthesized PCM within a few LSB).
"""

import asyncio
import contextlib
import dataclasses
import http.client
import io
import json
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpustack_tpu.engine.audio_server import AudioEngine as JaxAudioEngine
from gpustack_tpu.engine.audio_server import AudioServer as JaxAudioServer
from gpustack_tpu.models import tts as jtts
from gpustack_tpu.models import whisper as jwhisper
from gpustack_tpu_torch.engine.audio_server import (  # analysis: ignore[metrics-drift]
    AudioEngine,
    AudioServer,
    build_audio_engine_from_args,
    build_parser,
    parse_multipart,
)
from gpustack_tpu_torch.engine.weights import params_from_numpy  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models import tts, whisper  # analysis: ignore[metrics-drift]

BOUNDARY = "port-test-boundary-7f3a"


def _wav_bytes(seconds=0.3, freq=330):
    rate = 16000
    t = np.arange(int(seconds * rate)) / rate
    x = (np.sin(2 * np.pi * freq * t) * 0.4 * 32767).astype(np.int16)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(rate)
        wf.writeframes(x.tobytes())
    return buf.getvalue()


def _multipart(fields):
    """[(name, bytes, filename or None)] → (body, content type)."""
    out = bytearray()
    for name, value, filename in fields:
        out += f"--{BOUNDARY}\r\n".encode()
        disp = f'form-data; name="{name}"'
        if filename:
            disp += f'; filename="{filename}"'
        out += f"Content-Disposition: {disp}\r\n".encode()
        if filename:
            out += b"Content-Type: audio/wav\r\n"
        out += b"\r\n" + value + b"\r\n"
    out += f"--{BOUNDARY}--\r\n".encode()
    return bytes(out), f"multipart/form-data; boundary={BOUNDARY}"


@contextlib.contextmanager
def _fp32_jax_cache():
    """The JAX decode loop always makes a bf16 cache; an fp32 model needs
    fp32 (the JAX package is not edited)."""
    create = jwhisper.DecCache.create
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jwhisper.DecCache, "create", staticmethod(
            lambda c, batch, dtype=None: create(c, batch, jnp.float32)))
        yield


@pytest.fixture(scope="module")
def servers():
    wcfg = dataclasses.replace(
        jwhisper.WHISPER_PRESETS["tiny-whisper"], dtype="float32"
    )
    wnp = jax.tree.map(
        lambda a: np.asarray(a, np.float32),
        jwhisper.init_whisper_params(wcfg, jax.random.key(0), jnp.float32),
    )
    tcfg = jtts.TTS_PRESETS["tiny-tts"]
    tnp = jax.tree.map(lambda a: np.asarray(a, np.float32),
                       jtts.init_tts_params(tcfg, jax.random.key(0)))
    jax_side = {
        "stt": (JaxAudioEngine, (wcfg, jax.tree.map(jnp.asarray, wnp))),
        "tts": (JaxAudioEngine, (tcfg, jax.tree.map(jnp.asarray, tnp))),
    }
    port_wcfg = dataclasses.replace(
        whisper.WHISPER_PRESETS["tiny-whisper"], dtype="float32"
    )
    port = {
        "stt": AudioServer(AudioEngine(
            port_wcfg, params_from_numpy(wnp, "cpu")), model_name="tiny-stt"),
        "tts": AudioServer(AudioEngine(
            tts.TTS_PRESETS["tiny-tts"], params_from_numpy(tnp, "cpu"),
            modality="tts"), model_name="tiny-tts"),
    }
    ports = {k: s.start("127.0.0.1", 0) for k, s in port.items()}
    yield jax_side, ports
    for s in port.values():
        s.shutdown()


def _port_call(port, method, path, body=None, ctype="application/json"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(method, path, body=body,
                     headers={"Content-Type": ctype} if body is not None
                     else {})
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


def _jax_calls(jax_side, modality, calls):
    """Run [(method, path, body, ctype)] against a fresh JAX server (an
    aiohttp app binds to one loop) and return [(status, ctype, body)]."""
    from aiohttp.test_utils import TestClient, TestServer

    cls, (cfg, params) = jax_side[modality]
    name = "tiny-stt" if modality == "stt" else "tiny-tts"

    async def run():
        server = JaxAudioServer(
            cls(cfg, params, modality=modality), model_name=name
        )
        client = TestClient(TestServer(server.app))
        await client.start_server()
        out = []
        try:
            for method, path, body, ctype in calls:
                if method == "GET":
                    r = await client.get(path)
                else:
                    r = await client.post(path, data=body,
                                          headers={"Content-Type": ctype})
                out.append((r.status, r.headers["Content-Type"],
                            await r.read()))
        finally:
            await client.close()
        return out

    with _fp32_jax_cache():
        return asyncio.run(run())


def _both(servers, modality, calls):
    jax_side, ports = servers
    want = _jax_calls(jax_side, modality, calls)
    got = [_port_call(ports[modality], m, p, b, c) for m, p, b, c in calls]
    return got, want


def _same_json(got, want, drop=()):
    g, w = json.loads(got), json.loads(want)
    for k in drop:
        g.pop(k, None)
        w.pop(k, None)
    assert g == w


def test_transcriptions_translations_health_metrics(servers):
    file_body, ct = _multipart([("file", _wav_bytes(), "a.wav"),
                                ("model", b"tiny-stt", None)])
    text_body, _ = _multipart([("file", _wav_bytes(0.5, 440), "a.wav"),
                               ("response_format", b"text", None)])
    lang_body, _ = _multipart([("file", _wav_bytes(), "a.wav"),
                               ("language", b"fr", None)])
    calls = [
        ("POST", "/v1/audio/transcriptions", file_body, ct),
        ("POST", "/v1/audio/transcriptions", text_body, ct),
        ("POST", "/v1/audio/translations", file_body, ct),
        ("POST", "/v1/audio/transcriptions", lang_body, ct),
        ("GET", "/healthz", None, None),
        ("GET", "/metrics", None, None),
    ]
    got, want = _both(servers, "stt", calls)
    assert [g[0] for g in got] == [w[0] for w in want] == [
        200, 200, 200, 400, 200, 200]
    for i in (0, 2):
        assert got[i][1] == want[i][1] == "application/json; charset=utf-8"
        _same_json(got[i][2], want[i][2], drop=("id", "latency_ms"))
        g = json.loads(got[i][2])
        assert g["id"].startswith("transcr-") and g["latency_ms"] >= 0
    assert json.loads(got[0][2])["object"] == "audio.transcription"
    assert json.loads(got[2][2])["object"] == "audio.translation"
    assert got[1][1] == want[1][1] and got[1][2] == want[1][2]
    for i in (3, 4):
        assert got[i][2] == want[i][2]
    assert got[5][2] == want[5][2]
    assert b"gpustack_tpu_audio_requests_total 3\n" in got[5][2]
    assert b"gpustack_tpu_audio_seconds_total " in got[5][2]


def test_transcription_refusals(servers):
    no_file, ct = _multipart([("model", b"tiny-stt", None)])
    empty_file, _ = _multipart([("file", b"", "a.wav")])
    bad_wav, _ = _multipart([("file", b"not-a-wav", "a.wav")])
    calls = [
        ("POST", "/v1/audio/transcriptions", b'{"nope": 1}',
         "application/json"),
        ("POST", "/v1/audio/transcriptions", no_file, ct),
        ("POST", "/v1/audio/transcriptions", empty_file, ct),
        ("POST", "/v1/audio/transcriptions", bad_wav, ct),
        ("POST", "/v1/audio/speech", b'{"input": "hi"}', "application/json"),
    ]
    got, want = _both(servers, "stt", calls)
    for g, w in zip(got, want):
        assert g[0] == w[0] == 400
        assert g[2] == w[2], (g, w)
    assert b"missing 'file' part" in got[1][2]
    assert b"not a TTS model" in got[4][2]


def test_speech_matches_jax(servers):
    calls = [
        ("POST", "/v1/audio/speech", json.dumps(
            {"model": "tiny-tts", "input": "hello world", "voice": "alloy"}
        ).encode(), "application/json"),
        ("POST", "/v1/audio/speech", json.dumps(
            {"input": "hello", "response_format": "pcm", "speed": 2}
        ).encode(), "application/json"),
        ("GET", "/healthz", None, None),
        ("GET", "/metrics", None, None),
    ]
    got, want = _both(servers, "tts", calls)
    assert [g[0] for g in got] == [w[0] for w in want] == [200] * 4
    assert got[0][1] == want[0][1] == "audio/wav"
    assert got[0][2][:44] == want[0][2][:44]          # the RIFF header
    for i, skip in ((0, 44), (1, 0)):
        g = np.frombuffer(got[i][2][skip:], np.int16).astype(int)
        w = np.frombuffer(want[i][2][skip:], np.int16).astype(int)
        assert len(g) == len(w) > 0
        assert np.abs(g - w).max() <= 4
    assert got[1][1] == want[1][1] == "application/octet-stream"
    assert got[2][2] == want[2][2]
    assert got[3][2] == want[3][2]


def test_speech_refusals(servers):
    wav_body, ct = _multipart([("file", _wav_bytes(), "a.wav")])
    calls = [
        ("POST", "/v1/audio/speech", b"{}", "application/json"),
        ("POST", "/v1/audio/speech", b"not json", "application/json"),
        ("POST", "/v1/audio/speech", b'{"input": "x", "speed": "fast"}',
         "application/json"),
        ("POST", "/v1/audio/speech", b'{"input": "x", "speed": 9}',
         "application/json"),
        ("POST", "/v1/audio/speech",
         b'{"input": "x", "response_format": "opus"}', "application/json"),
        ("POST", "/v1/audio/speech", json.dumps(
            {"input": "x" * 80}).encode(), "application/json"),
        ("POST", "/v1/audio/transcriptions", wav_body, ct),
    ]
    got, want = _both(servers, "tts", calls)
    for g, w in zip(got, want):
        assert g[0] == w[0] == 400
        assert g[2] == w[2], (g, w)
    assert b"not an STT model" in got[-1][2]


def test_parse_multipart_and_engine_from_args(tmp_path):
    body, ct = _multipart([("file", b"\r\n--x\r\nraw\x00bytes", "a.wav"),
                           ("language", b"en", None)])
    assert parse_multipart(body, ct) == {
        "file": b"\r\n--x\r\nraw\x00bytes", "language": b"en"}
    with pytest.raises(ValueError, match="boundary"):
        parse_multipart(body, "multipart/form-data")
    args = build_parser().parse_args(
        ["--preset", "tiny-tts", "--device", "cpu", "--port", "0"])
    eng = build_audio_engine_from_args(args)
    assert eng.modality == "tts" and eng.cfg.name == "tiny-tts"
    # a TTS checkpoint dir: config.json names a preset, params.npz beside
    jcfg = jtts.TTS_PRESETS["tiny-tts"]
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            key = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, key)
            else:
                flat[key] = np.asarray(v, np.float32)

    walk(jtts.init_tts_params(jcfg, jax.random.key(3)), "")
    np.savez(tmp_path / "params.npz", **flat)
    (tmp_path / "config.json").write_text(
        json.dumps({"model_type": "tts", "preset": "tiny-tts"}))
    args = build_parser().parse_args(
        ["--model-dir", str(tmp_path), "--device", "cpu"])
    eng = build_audio_engine_from_args(args)
    assert eng.modality == "tts"
    np.testing.assert_array_equal(
        eng.params["enc"]["wq"].numpy(), flat["enc/wq"])
    args = build_parser().parse_args(
        ["--preset", "tiny-whisper", "--device", "cpu"])
    eng = build_audio_engine_from_args(args)
    assert eng.modality == "stt"
    assert eng.params["conv1"].shape == (64, 16, 3)
