"""Functional text-to-speech model (FastSpeech-class, non-autoregressive).

The port of ``gpustack_tpu/models/tts.py``:

  text ids [Tb] ──► encoder (pre-RMSNorm transformer) ──► durations [Tb]
        │                                              │
        └──► length-regulate (``searchsorted`` over cumulative
             durations on a static [F] frame grid) ──► frame decoder
             (transformer) ──► log-mel [F, n_mels]

on the device in plain torch (the blocks are XLA in JAX), then the host
vocoder: Griffin-Lim in numpy (a copy of JAX's, with its own
``default_rng(0)``). Voices are a learned embedding added to the encoder
input; ``speed`` scales the predicted durations.
"""

from __future__ import annotations

import dataclasses
import io
import math
import wave
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gpustack_tpu_torch.models.audio import mel_filterbank

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TTSConfig:
    name: str = "tts"
    vocab_size: int = 258          # byte tokenizer (engine/tokenizer.py)
    dim: int = 256
    enc_layers: int = 4
    dec_layers: int = 4
    num_heads: int = 4
    n_mels: int = 80
    n_voices: int = 8
    max_text_len: int = 256        # token bucket (static)
    max_frames: int = 1024         # frame bucket (static)
    max_duration: int = 16         # frames a single token may span
    sample_rate: int = 16000
    n_fft: int = 400
    hop: int = 160

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads

    @property
    def d_model(self) -> int:
        return self.dim

    # scheduler-calculator contract, copied with the config (the same duck
    # type as WhisperConfig / ModelConfig): budgets for placement math
    @property
    def num_kv_heads(self) -> int:
        return self.num_heads

    @property
    def num_experts(self) -> int:
        return 0

    def kv_cache_bytes_per_token(self, bits: int = 16) -> int:
        return 0                   # non-autoregressive: no KV cache

    def param_count(self) -> int:
        per_layer = 4 * self.dim * self.dim + 8 * self.dim * self.dim
        return (
            self.vocab_size * self.dim
            + self.n_voices * self.dim
            + (self.enc_layers + self.dec_layers) * per_layer
            + self.max_frames * self.dim          # frame_pos
            + self.dim * self.dim + self.dim      # duration head
            + self.dim * self.n_mels
            + 2 * self.dim
        )

    def weight_bytes(self, bits: int = 16) -> int:
        return self.param_count() * bits // 8


TTS_PRESETS = {
    "tts-base": TTSConfig(name="tts-base"),
    "tiny-tts": TTSConfig(
        name="tiny-tts", dim=32, enc_layers=2, dec_layers=2, num_heads=2,
        n_mels=20, max_text_len=64, max_frames=128, n_fft=256, hop=64,
    ),
}


def init_tts_params(
    cfg: TTSConfig, generator: torch.Generator, device=None
) -> Params:
    """Random init on ``device`` (the generator's device) from
    ``generator``: the JAX shapes and scales (fp32 draws rounded to bf16,
    fp32 norm gains); not the same numbers."""
    device = torch.device(device) if device is not None else generator.device

    def w(*shape, scale=None):
        scale = scale or (1.0 / math.sqrt(shape[-1]))
        out = torch.randn(
            shape, generator=generator, dtype=torch.float32, device=device
        )
        return out.mul_(scale).to(torch.bfloat16)

    def stack(layers: int) -> Dict[str, torch.Tensor]:
        D = cfg.dim
        return {
            "wq": w(layers, D, D),
            "wk": w(layers, D, D),
            "wv": w(layers, D, D),
            "wo": w(layers, D, D),
            "w1": w(layers, D, 4 * D),
            "w2": w(layers, 4 * D, D),
            "ln1": torch.ones(layers, D, device=device),
            "ln2": torch.ones(layers, D, device=device),
        }

    D, H = cfg.dim, cfg.n_mels
    return {
        "tok_emb": w(cfg.vocab_size, D, scale=0.02),
        "voice_emb": w(cfg.n_voices, D, scale=0.02),
        "enc": stack(cfg.enc_layers),
        "dur_w1": w(D, D),
        "dur_w2": w(D, 1, scale=0.1),
        "frame_pos": w(cfg.max_frames, D, scale=0.02),
        "dec": stack(cfg.dec_layers),
        "ln_out": torch.ones(D, device=device),
        "mel_head": w(D, H),
    }


def _rms(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-6):
    n = x.float()
    n = n * torch.rsqrt((n * n).mean(-1, keepdim=True) + eps)
    return (n * g).to(x.dtype)


def _gelu(x):
    return F.gelu(x, approximate="tanh")     # jax.nn.gelu's default


def _block_stack(x, blocks, cfg: TTSConfig, mask):
    """A non-causal transformer stack over its stacked layers. ``mask``:
    [T, T] additive fp32 (0 / -inf on padded keys)."""
    nh, hd = cfg.num_heads, cfg.head_dim
    scale = 1.0 / math.sqrt(hd)
    for i in range(blocks["wq"].shape[0]):
        h = _rms(x, blocks["ln1"][i])
        q = (h @ blocks["wq"][i]).reshape(-1, nh, hd)
        k = (h @ blocks["wk"][i]).reshape(-1, nh, hd)
        v = (h @ blocks["wv"][i]).reshape(-1, nh, hd)
        att = torch.einsum("qhd,khd->hqk", q, k) * scale
        # adding 0 or -inf is exact in any dtype: JAX adds in bf16
        att = torch.softmax((att + mask[None]).float(), -1).to(x.dtype)
        o = torch.einsum("hqk,khd->qhd", att, v).reshape(-1, cfg.dim)
        x = x + o @ blocks["wo"][i]
        h = _rms(x, blocks["ln2"][i])
        x = x + _gelu(h @ blocks["w1"][i]) @ blocks["w2"][i]
    return x


def frame_owners(cum: torch.Tensor, cfg: TTSConfig) -> torch.Tensor:
    """Length regulation on the static frame grid: frame j belongs to the
    first token whose cumulative duration ``cum`` exceeds j (``[F]``
    token indices, the last token past the end)."""
    grid = torch.arange(cfg.max_frames, dtype=torch.float32, device=cum.device)
    owner = torch.searchsorted(cum, grid, right=True)
    return torch.clamp(owner, max=cfg.max_text_len - 1)


def synthesize_mel(
    params: Params, cfg: TTSConfig, token_ids: torch.Tensor,
    true_len: int, voice: int, speed: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Padded ids [max_text_len] on the device → (log-mel [max_frames,
    n_mels] fp32, n_frames, raw_frames) as device tensors; all shapes
    static, nothing read back to the host."""
    T, Fr = cfg.max_text_len, cfg.max_frames
    device = token_ids.device
    tok_mask = torch.arange(T, device=device) < true_len          # [T]

    x = params["tok_emb"][token_ids] + params["voice_emb"][voice]
    zero = torch.zeros((), device=device)
    ninf = torch.full((), -math.inf, device=device)
    attn_mask = torch.where(tok_mask[None, :], zero, ninf).expand(T, T)
    x = _block_stack(x, params["enc"], cfg, attn_mask)

    # durations: positive frame counts per real token, scaled by 1/speed
    h = _gelu(x @ params["dur_w1"])
    log_d = (h @ params["dur_w2"])[:, 0].float()
    # a true division (a host scalar divisor would be a reciprocal product)
    speed_t = torch.full_like(log_d, speed)
    dur = torch.clip(torch.exp(log_d) / speed_t, 1.0, cfg.max_duration)
    dur = torch.where(tok_mask, dur, zero)
    cum = torch.cumsum(dur, 0)                                    # [T]
    raw_frames = torch.round(cum[-1]).to(torch.int32)
    n_frames = torch.clamp(raw_frames, max=Fr)

    owner = frame_owners(cum, cfg)
    frames = x[owner] + params["frame_pos"]
    frame_mask = torch.arange(Fr, device=device) < n_frames
    dec_mask = torch.where(frame_mask[None, :], zero, ninf).expand(Fr, Fr)
    y = _block_stack(frames, params["dec"], cfg, dec_mask)
    mel = _rms(y, params["ln_out"]) @ params["mel_head"]          # [F, n_mels]
    return mel.float(), n_frames, raw_frames


def griffin_lim(
    mel: np.ndarray, cfg: TTSConfig, n_iter: int = 30,
) -> np.ndarray:
    """Host vocoder: log-mel [F, n_mels] → float32 PCM.

    Mel → linear magnitude via the filterbank pseudo-inverse, then
    classic Griffin-Lim phase recovery over numpy STFT/ISTFT."""
    fb = mel_filterbank(cfg.n_mels, cfg.n_fft)        # [n_mels, bins]
    inv = np.linalg.pinv(fb)                          # [bins, n_mels]
    power = np.power(10.0, mel * 4.0 - 4.0)           # undo log scaling
    mag = np.sqrt(np.maximum(inv @ power.T, 1e-10))   # [bins, F]

    n_fft, hop = cfg.n_fft, cfg.hop
    window = np.hanning(n_fft + 1)[:-1].astype(np.float32)
    frames = mag.shape[1]
    length = hop * (frames - 1) + n_fft

    def istft(spec):
        x = np.zeros(length, np.float32)
        norm = np.zeros(length, np.float32)
        ytmp = np.fft.irfft(spec, n=n_fft, axis=0).real.astype(np.float32)
        for t in range(frames):
            s = t * hop
            x[s: s + n_fft] += ytmp[:, t] * window
            norm[s: s + n_fft] += window * window
        return x / np.maximum(norm, 1e-8)

    def stft(x):
        idx = (
            np.arange(n_fft)[None, :] + hop * np.arange(frames)[:, None]
        )
        xp = np.pad(x, (0, max(0, idx.max() + 1 - len(x))))
        return np.fft.rfft(xp[idx] * window, axis=1).T    # [bins, F]

    rng = np.random.default_rng(0)
    angles = np.exp(
        2j * np.pi * rng.random((mag.shape[0], frames))
    )
    for _ in range(n_iter):
        audio = istft(mag * angles)
        spec = stft(audio)
        angles = spec / np.maximum(np.abs(spec), 1e-8)
    audio = istft(mag * angles)
    peak = np.max(np.abs(audio))
    if peak > 0:
        audio = audio / peak * 0.9
    return audio.astype(np.float32)


def synthesize(
    params: Params, cfg: TTSConfig, token_ids, *,
    voice: int = 0, speed: float = 1.0,
) -> np.ndarray:
    """Text token ids → float32 PCM at ``cfg.sample_rate``, on the params'
    device then the host vocoder.

    Raises ValueError on empty input, input past the text bucket, or an
    utterance whose predicted duration exceeds the frame budget: the
    caller turns these into 400s rather than shipping truncated audio."""
    ids = list(token_ids)
    true_len = len(ids)
    if true_len == 0:
        raise ValueError("empty input text")
    if true_len > cfg.max_text_len:
        raise ValueError(
            f"input of {true_len} tokens exceeds this model's text "
            f"budget of {cfg.max_text_len}; shorten the input"
        )
    device = params["tok_emb"].device
    padded = torch.tensor(
        ids + [0] * (cfg.max_text_len - true_len), dtype=torch.int64
    ).to(device)
    with torch.no_grad():
        mel, n_frames, raw_frames = synthesize_mel(
            params, cfg, padded, true_len, voice % cfg.n_voices,
            max(0.25, min(4.0, speed)),
        )
    if int(raw_frames) > cfg.max_frames:
        raise ValueError(
            f"utterance needs {int(raw_frames)} frames but this model's "
            f"budget is {cfg.max_frames}; shorten the input or raise "
            f"speed"
        )
    n = int(n_frames)
    return griffin_lim(mel[:n].cpu().numpy(), cfg)


def pcm_to_wav_bytes(audio: np.ndarray, sample_rate: int) -> bytes:
    """float32 PCM [-1, 1] → 16-bit mono WAV bytes (stdlib only)."""
    pcm16 = (np.clip(audio, -1.0, 1.0) * 32767).astype(np.int16)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(sample_rate)
        wf.writeframes(pcm16.tobytes())
    return buf.getvalue()


# OpenAI voice names → voice-embedding indices (stable mapping so the
# same name always selects the same learned voice)
OPENAI_VOICES = {
    "alloy": 0, "echo": 1, "fable": 2, "onyx": 3,
    "nova": 4, "shimmer": 5,
}


def voice_index(name: Optional[str], cfg: TTSConfig) -> int:
    if not name:
        return 0
    if name in OPENAI_VOICES:
        return OPENAI_VOICES[name] % cfg.n_voices
    try:
        return int(name) % cfg.n_voices
    except ValueError:
        # unknown names hash stably onto the table
        return sum(name.encode()) % cfg.n_voices
