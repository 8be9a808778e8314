"""The image and audio servers with a tokenizer directory but no
``transformers`` (the card's machine has none): the port's ``ImageEngine``
(a diffusers-shaped directory, ``tokenizer/tokenizer_config.json``) and
``AudioEngine`` (a Whisper-shaped one, ``tokenizer_config.json``) log the
failure and build with the byte tokenizer, as the JAX engines do, and
serve what the JAX servers serve: the same prompt ids, the same
transcription bodies, the same ``/healthz`` and refusal bodies. The chat
server's tokenizer loading still raises, in both packages."""

import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpustack_tpu.engine.audio_server import AudioEngine as JaxAudioEngine
from gpustack_tpu.engine.image_server import ImageEngine as JaxImageEngine
from gpustack_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from gpustack_tpu.models.diffusion import DIFFUSION_PRESETS as JAX_DIFFUSION
from gpustack_tpu_torch.engine.audio_server import AudioEngine, AudioServer  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.image_server import ImageEngine, ImageServer  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.tokenizer import (  # analysis: ignore[metrics-drift]
    ByteTokenizer,
    load_tokenizer,
)
from gpustack_tpu_torch.engine.weights import params_from_numpy  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models import diffusion  # analysis: ignore[metrics-drift]


def _load(name):
    path = os.path.join(os.path.dirname(__file__), f"test_torch_{name}.py")
    spec = importlib.util.spec_from_file_location(f"_f5_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


IMG, AUD = _load("image_server"), _load("audio_server")


@pytest.fixture
def no_transformers(monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)


@pytest.fixture
def diffusers_dir(tmp_path):
    (tmp_path / "tokenizer").mkdir()
    (tmp_path / "tokenizer" / "tokenizer_config.json").write_text("{}")
    return str(tmp_path)


@pytest.fixture
def whisper_dir(tmp_path):
    (tmp_path / "tokenizer_config.json").write_text("{}")
    return str(tmp_path)


def test_image_engine_falls_back_to_bytes(no_transformers, diffusers_dir):
    tree = IMG.H.jax_tree("tiny")
    cfg = diffusion.DIFFUSION_PRESETS["tiny-diffusion"]
    port = ImageEngine(cfg, params_from_numpy(tree, "cpu"), diffusers_dir)
    want = JaxImageEngine(JAX_DIFFUSION["tiny-diffusion"],
                          jax.tree.map(jnp.asarray, tree), diffusers_dir)
    assert isinstance(port.tokenizer, ByteTokenizer)
    assert isinstance(want.tokenizer, JaxByteTokenizer)
    for prompt in ("a lighthouse at dusk", ""):
        np.testing.assert_array_equal(
            np.asarray(port._tokens(prompt, port.tokenizer)).reshape(-1),
            np.asarray(want._tokens(prompt, want.tokenizer)).reshape(-1))
    server = ImageServer(port, model_name=IMG.NAME)
    p = server.start("127.0.0.1", 0)
    try:
        status, _, raw = IMG._call(p, "POST", IMG.GEN, json.dumps(
            {"prompt": "a lighthouse", "steps": 2, "seed": 3}).encode())
        assert status == 200 and len(IMG._pngs(raw)) == 1
        calls = [("GET", "/healthz", None),
                 ("POST", IMG.GEN, json.dumps({"prompt": ""}).encode())]
        got = [IMG._call(p, m, path, b) for m, path, b in calls]
    finally:
        server.shutdown()
    # a fresh JAX server has served nothing: compare before-counts
    want_calls = IMG._jax_calls(tree, calls)
    health_got, health_want = json.loads(got[0][2]), json.loads(
        want_calls[0][2])
    assert health_got["requests"] == health_want["requests"] + 1
    health_got.pop("requests"), health_want.pop("requests")
    health_got.pop("images"), health_want.pop("images")
    assert health_got == health_want
    assert got[1][0] == want_calls[1][0] == 400
    assert got[1][2] == want_calls[1][2]


def test_audio_engine_falls_back_to_bytes(no_transformers, whisper_dir):
    import dataclasses

    from gpustack_tpu.models import whisper as jwhisper
    from gpustack_tpu_torch.models import whisper  # analysis: ignore[metrics-drift]

    wcfg = dataclasses.replace(jwhisper.WHISPER_PRESETS["tiny-whisper"],
                               dtype="float32")
    wnp = jax.tree.map(lambda a: np.asarray(a, np.float32),
                       jwhisper.init_whisper_params(
                           wcfg, jax.random.key(0), jnp.float32))
    port_cfg = dataclasses.replace(whisper.WHISPER_PRESETS["tiny-whisper"],
                                   dtype="float32")
    port = AudioEngine(port_cfg, params_from_numpy(wnp, "cpu"), whisper_dir)
    jeng = JaxAudioEngine(wcfg, jax.tree.map(jnp.asarray, wnp), whisper_dir)
    assert isinstance(port.tokenizer, ByteTokenizer)
    assert isinstance(jeng.tokenizer, JaxByteTokenizer)
    body, ct = AUD._multipart([("file", AUD._wav_bytes(), "a.wav")])
    calls = [("POST", "/v1/audio/transcriptions", body, ct),
             ("GET", "/healthz", None, None)]
    server = AudioServer(port, model_name="tiny-stt")
    p = server.start("127.0.0.1", 0)
    try:
        got = [AUD._port_call(p, m, path, b, c) for m, path, b, c in calls]
    finally:
        server.shutdown()
    jax_side = {"stt": (lambda c, params, modality: JaxAudioEngine(
        c, params, whisper_dir, modality), (wcfg, jax.tree.map(
            jnp.asarray, wnp)))}
    want = AUD._jax_calls(jax_side, "stt", calls)
    assert [g[0] for g in got] == [w[0] for w in want] == [200, 200]
    AUD._same_json(got[0][2], want[0][2], drop=("id", "latency_ms"))
    assert got[1][2] == want[1][2]


def test_chat_tokenizer_still_raises(no_transformers, whisper_dir):
    from gpustack_tpu.engine.tokenizer import load_tokenizer as jax_load

    for load in (load_tokenizer, jax_load):
        with pytest.raises(ImportError):
            load(whisper_dir)
