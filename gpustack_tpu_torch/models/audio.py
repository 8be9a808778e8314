"""Audio frontend: WAV decoding + Whisper-convention log-mel features.

The port's own copy of ``gpustack_tpu/models/audio.py`` (numpy and the
stdlib ``wave``; no torch): 16 kHz input, 25 ms Hann window / 10 ms hop
STFT, Slaney mel filterbank, log10 clamped to (max - 8), scaled to
roughly [-1, 1].
"""

from __future__ import annotations

import io
import wave

import numpy as np

SAMPLE_RATE = 16000
N_FFT = 400
HOP = 160
CHUNK_SECONDS = 30


def decode_wav(data: bytes) -> np.ndarray:
    """WAV bytes -> mono float32 [-1, 1] at 16 kHz (naive resample)."""
    with wave.open(io.BytesIO(data)) as wf:
        rate = wf.getframerate()
        n = wf.getnframes()
        width = wf.getsampwidth()
        channels = wf.getnchannels()
        raw = wf.readframes(n)
    if width == 2:
        x = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, np.int32).astype(np.float32) / 2**31
    elif width == 1:
        x = (
            np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0
        ) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width {width}")
    if channels > 1:
        x = x.reshape(-1, channels).mean(axis=1)
    if rate != SAMPLE_RATE:
        # linear interpolation resample — adequate for speech features
        target_len = int(round(len(x) * SAMPLE_RATE / rate))
        x = np.interp(
            np.linspace(0, len(x) - 1, target_len),
            np.arange(len(x)),
            x,
        ).astype(np.float32)
    return x


def mel_filterbank(n_mels: int, n_fft: int = N_FFT) -> np.ndarray:
    """Slaney-convention mel filterbank [n_mels, n_fft//2 + 1].

    Matches librosa.filters.mel defaults (Slaney mel scale — linear below
    1 kHz — and Slaney area normalization), which is what Whisper
    checkpoints were trained against; an HTK/unnormalized bank shifts
    per-band log energies by 1-2 orders of magnitude and feeds the
    encoder out-of-distribution features.
    """

    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        mel = f * 3.0 / 200.0
        log_region = f >= 1000.0
        mel = np.where(
            log_region,
            15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / np.log(6.4) * 27.0,
            mel,
        )
        return mel

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        f = m * 200.0 / 3.0
        log_region = m >= 15.0
        return np.where(
            log_region, 1000.0 * np.exp(np.log(6.4) * (m - 15.0) / 27.0), f
        )

    fmax = SAMPLE_RATE / 2
    fftfreqs = np.linspace(0, fmax, n_fft // 2 + 1)
    mel_f = mel_to_hz(
        np.linspace(hz_to_mel(0.0), hz_to_mel(fmax), n_mels + 2)
    )
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    fb = np.maximum(0.0, np.minimum(lower, upper))
    # Slaney norm: each triangle integrates to ~constant energy
    fb *= (2.0 / (mel_f[2: n_mels + 2] - mel_f[:n_mels]))[:, None]
    return fb.astype(np.float32)


def log_mel(
    audio: np.ndarray, n_mels: int, chunk_seconds: int = CHUNK_SECONDS
) -> np.ndarray:
    """float32 PCM -> [frames, n_mels]; padded/truncated to the fixed
    chunk length (static shapes for the jitted encoder)."""
    target = chunk_seconds * SAMPLE_RATE
    if len(audio) < target:
        audio = np.pad(audio, (0, target - len(audio)))
    else:
        audio = audio[:target]
    # centered STFT (reflect pad n_fft/2 each side, drop the final
    # frame): 30 s -> exactly 3000 frames, the Whisper recipe
    audio = np.pad(audio, (N_FFT // 2, N_FFT // 2), mode="reflect")
    window = np.hanning(N_FFT + 1)[:-1].astype(np.float32)
    n_frames = (len(audio) - N_FFT) // HOP + 1
    idx = (
        np.arange(N_FFT)[None, :] + HOP * np.arange(n_frames)[:, None]
    )
    frames = audio[idx] * window
    spec = np.abs(np.fft.rfft(frames, axis=1)) ** 2        # [T, F]
    spec = spec[:-1]                                       # drop last
    mel = spec @ mel_filterbank(n_mels).T                  # [T, n_mels]
    log_spec = np.log10(np.maximum(mel, 1e-10))
    log_spec = np.maximum(log_spec, log_spec.max() - 8.0)
    return ((log_spec + 4.0) / 4.0).astype(np.float32)


def mel_frames_for(cfg) -> int:
    """Frames the encoder expects: conv stride 2 halves the time axis."""
    return cfg.max_source_positions * 2


def features_for_model(audio: np.ndarray, cfg) -> np.ndarray:
    """PCM -> mel features sized exactly for ``cfg`` ([2*S_pos, n_mels])."""
    frames = mel_frames_for(cfg)
    # chunk length that yields `frames` frames at the standard hop
    seconds = max(1, int(np.ceil((frames * HOP + N_FFT) / SAMPLE_RATE)))
    mel = log_mel(audio, cfg.num_mel_bins, chunk_seconds=seconds)
    if mel.shape[0] < frames:
        mel = np.pad(mel, ((0, frames - mel.shape[0]), (0, 0)))
    return mel[:frames]
