"""Text to speech in the PyTorch port (``models/tts.py``) against the JAX
package on ``tiny-tts``: the mel in fp32 within 1e-5 on one JAX init
carried across with ``params_from_numpy``, frame counts identical; the host
vocoder, WAV writer and voice map bit for bit.
"""

import dataclasses
import io
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpustack_tpu.models import tts as jtts
from gpustack_tpu_torch.engine.weights import params_from_numpy  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models import tts  # analysis: ignore[metrics-drift]


@pytest.fixture(scope="module")
def fp32_model():
    cfg = tts.TTS_PRESETS["tiny-tts"]
    jcfg = jtts.TTS_PRESETS["tiny-tts"]
    np_params = jax.tree.map(
        lambda a: np.asarray(a, np.float32),
        jtts.init_tts_params(jcfg, jax.random.key(0)),
    )
    # a duration head of positive weights: the init's predicts one frame
    # a token; this one spans several, so speed moves the count and a
    # long input overruns the frame budget
    np_params["dur_w2"] = np.abs(np_params["dur_w2"])
    return (jcfg, jax.tree.map(jnp.asarray, np_params), cfg,
            params_from_numpy(np_params, "cpu"))


@pytest.mark.parametrize("n_ids,voice,speed", [
    (1, 0, 1.0), (11, 3, 1.0), (40, 7, 0.5), (64, 1, 1.5),
])
def test_synthesize_mel_fp32(fp32_model, n_ids, voice, speed):
    jcfg, jparams, cfg, params = fp32_model
    rng = np.random.default_rng(n_ids)
    ids = rng.integers(1, 257, n_ids).tolist()
    padded = ids + [0] * (cfg.max_text_len - n_ids)
    jmel, jn, jraw = jax.jit(
        lambda p, i, n, v, s: jtts.synthesize_mel(p, jcfg, i, n, v, s)
    )(jparams, jnp.asarray(padded, jnp.int32), jnp.int32(n_ids),
      jnp.int32(voice), jnp.float32(speed))
    mel, n, raw = tts.synthesize_mel(
        params, cfg, torch.tensor(padded), n_ids, voice, speed
    )
    assert int(raw) == int(jraw) and int(n) == int(jn)
    assert int(n) > n_ids                     # tokens span several frames
    np.testing.assert_allclose(mel.numpy(), np.asarray(jmel), rtol=1e-5,
                               atol=1e-5)


def test_griffin_lim_and_wav_bit_for_bit():
    for name in ("tiny-tts", "tts-base"):
        cfg, jcfg = tts.TTS_PRESETS[name], jtts.TTS_PRESETS[name]
        mel = np.random.default_rng(1).standard_normal(
            (23, cfg.n_mels)).astype(np.float32) * 0.3
        pcm = tts.griffin_lim(mel, cfg, n_iter=5)
        np.testing.assert_array_equal(pcm, jtts.griffin_lim(mel, jcfg, 5))
        assert tts.pcm_to_wav_bytes(pcm, cfg.sample_rate) == (
            jtts.pcm_to_wav_bytes(pcm, jcfg.sample_rate)
        )
        with wave.open(io.BytesIO(tts.pcm_to_wav_bytes(pcm, 16000))) as wf:
            assert wf.getnframes() == len(pcm)


def test_voice_index_and_presets_as_jax():
    for name in ("tiny-tts", "tts-base"):
        cfg, jcfg = tts.TTS_PRESETS[name], jtts.TTS_PRESETS[name]
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert (cfg.head_dim, cfg.d_model, cfg.num_kv_heads,
                cfg.kv_cache_bytes_per_token(), cfg.weight_bytes()) == (
            jcfg.head_dim, jcfg.d_model, jcfg.num_kv_heads,
            jcfg.kv_cache_bytes_per_token(), jcfg.weight_bytes())
        for voice in (None, "", "alloy", "shimmer", "nova", "3", "17",
                      "custom-voice", "ünïcode"):
            assert tts.voice_index(voice, cfg) == jtts.voice_index(voice, jcfg)


def test_synthesize_pcm_and_refusals(fp32_model):
    jcfg, jparams, cfg, params = fp32_model
    ids = list(b"hello world")
    np.testing.assert_allclose(
        tts.synthesize(params, cfg, ids, voice=2, speed=1.5),
        jtts.synthesize(jparams, jcfg, ids, voice=2, speed=1.5),
        rtol=1e-4, atol=1e-4,
    )
    cases = [
        ([], "empty input"),
        ([5] * (cfg.max_text_len + 1), "text budget"),
        (np.random.default_rng(64).integers(1, 257, cfg.max_text_len)
         .tolist(), "frames but this model's budget"),
    ]
    for bad, words in cases:
        with pytest.raises(ValueError, match=words):
            tts.synthesize(params, cfg, bad, speed=0.25)
        with pytest.raises(ValueError, match=words):
            jtts.synthesize(jparams, jcfg, bad, speed=0.25)
