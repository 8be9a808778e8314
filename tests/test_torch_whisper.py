"""Speech to text in the PyTorch port (``models/audio.py``,
``models/whisper.py``, ``engine/weights.load_whisper_params``) against the
JAX package on ``tiny-whisper``.

The audio frontend is numpy in both packages and must agree bit for bit;
the model runs in fp32 on one JAX init carried across with
``params_from_numpy`` (1e-5), and greedy ids must be identical.
"""

import dataclasses
import io
import json
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from gpustack_tpu.engine.weights import (
    load_whisper_params as jax_load_whisper_params,
)
from gpustack_tpu.models import audio as jaudio
from gpustack_tpu.models import whisper as jwhisper
from gpustack_tpu_torch.engine.weights import (  # analysis: ignore[metrics-drift]
    load_whisper_params,
    params_from_numpy,
)
from gpustack_tpu_torch.models import audio, whisper  # analysis: ignore[metrics-drift]


def _wav(x: np.ndarray, rate: int, width: int, channels: int = 1) -> bytes:
    if width == 1:
        pcm = (x * 127 + 128).astype(np.uint8)
    elif width == 2:
        pcm = (x * 32767).astype(np.int16)
    else:
        pcm = (x * (2**31 - 1)).astype(np.int32)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as wf:
        wf.setnchannels(channels)
        wf.setsampwidth(width)
        wf.setframerate(rate)
        wf.writeframes(pcm.tobytes())
    return buf.getvalue()


def _speechlike(seconds: float, rate: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * rate)) / rate
    x = 0.3 * np.sin(2 * np.pi * 220 * t) * np.sin(2 * np.pi * 3 * t)
    return (x + 0.05 * rng.standard_normal(len(t))).clip(-1, 1)


@pytest.mark.parametrize("rate,width,channels", [
    (16000, 2, 1), (16000, 1, 1), (16000, 4, 1), (8000, 2, 1),
    (44100, 2, 2),
])
def test_decode_wav_bit_for_bit(rate, width, channels):
    x = _speechlike(0.5, rate, seed=rate + width)
    if channels == 2:
        x = np.stack([x, x[::-1]], -1).reshape(-1)
    data = _wav(x, rate, width, channels)
    want = jaudio.decode_wav(data)
    got = audio.decode_wav(data)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_mels,n_fft", [(16, 400), (80, 400), (128, 400),
                                          (20, 256)])
def test_mel_filterbank_bit_for_bit(n_mels, n_fft):
    np.testing.assert_array_equal(
        audio.mel_filterbank(n_mels, n_fft), jaudio.mel_filterbank(n_mels, n_fft)
    )


@pytest.mark.parametrize("seconds", [0.3, 2.5])
def test_log_mel_and_features_bit_for_bit(seconds):
    x = _speechlike(seconds, 16000, seed=7).astype(np.float32)
    np.testing.assert_array_equal(
        audio.log_mel(x, 80, chunk_seconds=3), jaudio.log_mel(x, 80, 3)
    )
    for name in ("tiny-whisper", "whisper-large-v3"):
        jcfg = jwhisper.WHISPER_PRESETS[name]
        cfg = whisper.WHISPER_PRESETS[name]
        assert audio.mel_frames_for(cfg) == jaudio.mel_frames_for(jcfg)
        np.testing.assert_array_equal(
            audio.features_for_model(x, cfg),
            jaudio.features_for_model(x, jcfg),
        )


def test_config_from_hf_whisper():
    hf = {
        "_name_or_path": "openai/whisper-large-v3", "vocab_size": 51866,
        "num_mel_bins": 128, "d_model": 1280, "encoder_layers": 32,
        "decoder_layers": 32, "encoder_attention_heads": 20,
        "max_source_positions": 1500, "max_target_positions": 448,
        "eos_token_id": 50257, "decoder_start_token_id": 50258,
    }
    got = dataclasses.asdict(whisper.config_from_hf_whisper(hf))
    assert got == dataclasses.asdict(jwhisper.config_from_hf_whisper(hf))
    assert got == dataclasses.asdict(
        dataclasses.replace(whisper.WHISPER_PRESETS["whisper-large-v3"],
                            name="openai/whisper-large-v3")
    )
    for name, cfg in whisper.WHISPER_PRESETS.items():
        jcfg = jwhisper.WHISPER_PRESETS[name]
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert (cfg.head_dim, cfg.num_kv_heads, cfg.num_experts,
                cfg.kv_cache_bytes_per_token(), cfg.weight_bytes(8)) == (
            jcfg.head_dim, jcfg.num_kv_heads, jcfg.num_experts,
            jcfg.kv_cache_bytes_per_token(), jcfg.weight_bytes(8))
    short = {k: hf[k] for k in ("vocab_size", "d_model", "encoder_layers",
                                "decoder_layers", "encoder_attention_heads")}
    assert dataclasses.asdict(
        whisper.config_from_hf_whisper(short, name="w")
    ) == dataclasses.asdict(jwhisper.config_from_hf_whisper(short, name="w"))


@pytest.fixture(scope="module")
def fp32_model():
    jcfg = dataclasses.replace(
        jwhisper.WHISPER_PRESETS["tiny-whisper"], dtype="float32"
    )
    jparams = jwhisper.init_whisper_params(
        jcfg, jax.random.key(0), dtype=jnp.float32
    )
    # the init's biases are zeros: draw them, so a misplaced one shows
    rng = np.random.default_rng(0)
    np_params = jax.tree.map(np.asarray, jparams)
    for side in ("enc_layers", "dec_layers"):
        for k, v in np_params[side].items():
            if k.startswith(("b", "xb")) or k.endswith("_b"):
                np_params[side][k] = rng.standard_normal(v.shape).astype(
                    np.float32) * 0.1
    for k in ("conv1_b", "conv2_b", "enc_ln_b", "dec_ln_b"):
        np_params[k] = rng.standard_normal(np_params[k].shape).astype(
            np.float32) * 0.1
    jparams = jax.tree.map(jnp.asarray, np_params)
    cfg = dataclasses.replace(
        whisper.WHISPER_PRESETS["tiny-whisper"], dtype="float32"
    )
    mel = jaudio.features_for_model(
        _speechlike(0.8, 16000, seed=3).astype(np.float32), jcfg
    )
    return jcfg, jparams, cfg, params_from_numpy(np_params, "cpu"), mel


def test_encode_cross_kv_decode_step_fp32(fp32_model):
    jcfg, jparams, cfg, params, mel = fp32_model
    assert params["conv1"].shape == (cfg.d_model, cfg.num_mel_bins, 3)
    jenc = jwhisper.encode(jparams, jcfg, jnp.asarray(mel)[None])
    enc = whisper.encode(params, cfg, torch.from_numpy(mel)[None])
    np.testing.assert_allclose(enc.numpy(), np.asarray(jenc), rtol=1e-5,
                               atol=1e-5)
    jxk, jxv = jwhisper.cross_kv(jparams, jcfg, jenc)
    xk, xv = whisper.cross_kv(params, cfg, enc)
    np.testing.assert_allclose(xk.numpy(), np.asarray(jxk), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(xv.numpy(), np.asarray(jxv), rtol=1e-5,
                               atol=1e-5)
    jcache = jwhisper.DecCache.create(jcfg, 1, jnp.float32)
    cache = whisper.DecCache.create(cfg, 1, torch.float32)
    for pos, tok in enumerate([cfg.decoder_start_token_id, 17, 250, 3]):
        jlogits, jcache = jwhisper.decode_step(
            jparams, jcfg, jnp.asarray([[tok]], jnp.int32), jnp.int32(pos),
            jxk, jxv, jcache,
        )
        logits, cache = whisper.decode_step(
            params, cfg, torch.tensor([[tok]]), pos, xk, xv, cache
        )
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("prompt_ids,max_tokens", [((), 0), ((5, 9), 6)])
def test_greedy_transcribe_ids_identical(fp32_model, prompt_ids, max_tokens,
                                        monkeypatch):
    jcfg, jparams, cfg, params, mel = fp32_model
    # the JAX loop always makes a bf16 cache; an fp32 model needs fp32
    create = jwhisper.DecCache.create
    monkeypatch.setattr(jwhisper.DecCache, "create", staticmethod(
        lambda c, batch, dtype=None: create(c, batch, jnp.float32)))
    want = jwhisper.greedy_transcribe(jparams, jcfg, mel, prompt_ids,
                                      max_tokens)
    got = whisper.greedy_transcribe(params, cfg, mel, prompt_ids, max_tokens)
    assert got == want
    assert len(got) > 0


def _hf_whisper_tensors(np_params, cfg):
    """The JAX tree under HF Whisper names (torch layouts)."""
    out = {
        "model.encoder.conv1.weight": np_params["conv1"].transpose(2, 1, 0),
        "model.encoder.conv1.bias": np_params["conv1_b"],
        "model.encoder.conv2.weight": np_params["conv2"].transpose(2, 1, 0),
        "model.encoder.conv2.bias": np_params["conv2_b"],
        "model.encoder.layer_norm.weight": np_params["enc_ln"],
        "model.encoder.layer_norm.bias": np_params["enc_ln_b"],
        "model.encoder.embed_positions.weight": np.zeros(
            (cfg.max_source_positions, cfg.d_model), np.float32),
        "model.decoder.embed_tokens.weight": np_params["tok_embed"],
        "model.decoder.embed_positions.weight": np_params["pos_embed"],
        "model.decoder.layer_norm.weight": np_params["dec_ln"],
        "model.decoder.layer_norm.bias": np_params["dec_ln_b"],
    }
    names = {
        "ln1": "self_attn_layer_norm.weight",
        "ln1_b": "self_attn_layer_norm.bias",
        "ln2": "final_layer_norm.weight", "ln2_b": "final_layer_norm.bias",
        "w_up": "fc1.weight", "b_up": "fc1.bias",
        "w_down": "fc2.weight", "b_down": "fc2.bias",
        "lnx": "encoder_attn_layer_norm.weight",
        "lnx_b": "encoder_attn_layer_norm.bias",
    }
    for tag, attn in (("", "self_attn"), ("x", "encoder_attn")):
        names.update({
            f"{tag}wq": f"{attn}.q_proj.weight", f"{tag}bq": f"{attn}.q_proj.bias",
            f"{tag}wk": f"{attn}.k_proj.weight",
            f"{tag}wv": f"{attn}.v_proj.weight", f"{tag}bv": f"{attn}.v_proj.bias",
            f"{tag}wo": f"{attn}.out_proj.weight", f"{tag}bo": f"{attn}.out_proj.bias",
        })
    for side, key in (("encoder", "enc_layers"), ("decoder", "dec_layers")):
        for leaf, stacked in np_params[key].items():
            for i, t in enumerate(stacked):
                out[f"model.{side}.layers.{i}.{names[leaf]}"] = (
                    t.T if t.ndim == 2 else t
                )
    return {k: np.ascontiguousarray(v, np.float32) for k, v in out.items()}


def test_load_whisper_params_tree_as_jax(fp32_model, tmp_path):
    jcfg, jparams, cfg, _, _ = fp32_model
    np_params = jax.tree.map(np.asarray, jparams)
    save_file(_hf_whisper_tensors(np_params, cfg),
              str(tmp_path / "model.safetensors"))
    (tmp_path / "config.json").write_text(json.dumps({
        "model_type": "whisper", "vocab_size": cfg.vocab_size,
        "num_mel_bins": cfg.num_mel_bins, "d_model": cfg.d_model,
        "encoder_layers": cfg.encoder_layers,
        "decoder_layers": cfg.decoder_layers,
        "encoder_attention_heads": cfg.num_heads,
        "max_source_positions": cfg.max_source_positions,
        "max_target_positions": cfg.max_target_positions,
    }))
    want = jax_load_whisper_params(jcfg, str(tmp_path))
    got = load_whisper_params(cfg, str(tmp_path), "cpu")
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    got_leaves = dict(
        (jax.tree_util.keystr(p), v)
        for p, v in jax.tree_util.tree_flatten_with_path(
            got, is_leaf=lambda x: isinstance(x, torch.Tensor))[0]
    )
    assert len(got_leaves) == len(flat_want)
    for path, leaf in flat_want:
        key = jax.tree_util.keystr(path)
        t = got_leaves[key]
        assert t.dtype == torch.bfloat16, key
        arr = t.float().numpy()
        if key in ("['conv1']", "['conv2']"):
            arr = arr.transpose(2, 1, 0)
        np.testing.assert_array_equal(arr, np.asarray(leaf, np.float32), key)
