"""Functional Whisper-class speech-to-text model (encoder-decoder).

The port of ``gpustack_tpu/models/whisper.py``: per-layer weights stacked
on a leading [L] axis (a Python loop over layers where JAX scans), a mel
input padded to ``max_source_positions * 2`` frames, the decoder one step
at a time over a preallocated self-attention KV cache written in place,
bf16 products with fp32 softmax and normalisation statistics.

The attention is plain torch, as it is XLA in JAX (``_mha``): the encoder
over 1500 frames is not causal, so the flash kernel does not serve it.
``greedy_transcribe`` reads one argmax a token on the host, as JAX does.

Layout difference from JAX: the two conv weights are ``[Cout, Cin, K]``
(``F.conv1d``'s, and HF's), where JAX keeps HIO ``[K, Cin, Cout]``; the
tree is transposed once when it is carried across or drawn, never per
call.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, Any]

_NEG = -1e30        # JAX's masked score (not -inf)


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    name: str = "whisper"
    vocab_size: int = 51866
    num_mel_bins: int = 128
    d_model: int = 1280
    encoder_layers: int = 32
    decoder_layers: int = 32
    num_heads: int = 20
    max_source_positions: int = 1500   # encoder frames after conv stride 2
    max_target_positions: int = 448
    eos_token_id: int = 50257
    decoder_start_token_id: int = 50258
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    # calculator-facing surface, copied with the config (the JAX package's
    # scheduler/calculator.py treats audio models through the same claim
    # math; whisper shards poorly and fits one chip: tp=1 via num_kv_heads)
    @property
    def num_kv_heads(self) -> int:
        return 1

    @property
    def num_experts(self) -> int:
        return 0

    def kv_cache_bytes_per_token(self, bits: int = 16) -> int:
        # decoder self-attn K+V per position (cross-attn K/V is per
        # request, amortized into overhead)
        return self.decoder_layers * 2 * self.d_model * bits // 8

    def param_count(self) -> int:
        d, v = self.d_model, self.vocab_size
        enc = self.encoder_layers * (4 * d * d + 8 * d * d)   # attn + mlp
        dec = self.decoder_layers * (8 * d * d + 8 * d * d)   # self+cross+mlp
        embed = v * d + self.max_target_positions * d
        conv = 3 * self.num_mel_bins * d + 3 * d * d
        return enc + dec + embed + conv

    def weight_bytes(self, bits: int = 16) -> int:
        return self.param_count() * bits // 8


WHISPER_PRESETS: Dict[str, WhisperConfig] = {
    "whisper-large-v3": WhisperConfig(name="whisper-large-v3"),
    "whisper-small": WhisperConfig(
        name="whisper-small",
        vocab_size=51865,
        num_mel_bins=80,
        d_model=768,
        encoder_layers=12,
        decoder_layers=12,
        num_heads=12,
    ),
    "tiny-whisper": WhisperConfig(
        name="tiny-whisper",
        vocab_size=384,
        num_mel_bins=16,
        d_model=64,
        encoder_layers=2,
        decoder_layers=2,
        num_heads=4,
        max_source_positions=32,
        max_target_positions=32,
        eos_token_id=1,
        decoder_start_token_id=2,
    ),
}


def config_from_hf_whisper(cfg: Dict[str, Any], name: str = "") -> WhisperConfig:
    """Map an HF WhisperConfig dict (config.json) onto WhisperConfig."""
    return WhisperConfig(
        name=name or cfg.get("_name_or_path", "whisper"),
        vocab_size=cfg["vocab_size"],
        num_mel_bins=cfg.get("num_mel_bins", 80),
        d_model=cfg["d_model"],
        encoder_layers=cfg["encoder_layers"],
        decoder_layers=cfg["decoder_layers"],
        num_heads=cfg["encoder_attention_heads"],
        max_source_positions=cfg.get("max_source_positions", 1500),
        max_target_positions=cfg.get("max_target_positions", 448),
        eos_token_id=cfg.get("eos_token_id", 50257),
        decoder_start_token_id=cfg.get("decoder_start_token_id", 50258),
    )


def _compute_dtype(cfg: WhisperConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_whisper_params(
    cfg: WhisperConfig, generator: torch.Generator,
    dtype: torch.dtype = torch.bfloat16, device=None,
) -> Params:
    """Random init on ``device`` (the generator's device) from
    ``generator``: the JAX shapes and scales (fp32 draws rounded to
    ``dtype``), the conv weights as ``[Cout, Cin, K]``; not the same
    numbers."""
    device = torch.device(device) if device is not None else generator.device
    d = cfg.d_model

    def w(*shape, scale=None):
        scale = scale if scale is not None else 1.0 / math.sqrt(shape[-2])
        out = torch.randn(
            shape, generator=generator, dtype=torch.float32, device=device
        )
        return out.mul_(scale).to(dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def layers(L: int, cross: bool) -> Dict[str, torch.Tensor]:
        out = {
            "ln1": ones(L, d), "ln1_b": zeros(L, d),
            "wq": w(L, d, d), "bq": zeros(L, d),
            "wk": w(L, d, d),
            "wv": w(L, d, d), "bv": zeros(L, d),
            "wo": w(L, d, d), "bo": zeros(L, d),
            "ln2": ones(L, d), "ln2_b": zeros(L, d),
            "w_up": w(L, d, 4 * d), "b_up": zeros(L, 4 * d),
            "w_down": w(L, 4 * d, d, scale=1 / math.sqrt(4 * d)),
            "b_down": zeros(L, d),
        }
        if cross:
            out.update({
                "lnx": ones(L, d), "lnx_b": zeros(L, d),
                "xwq": w(L, d, d), "xbq": zeros(L, d),
                "xwk": w(L, d, d),
                "xwv": w(L, d, d), "xbv": zeros(L, d),
                "xwo": w(L, d, d), "xbo": zeros(L, d),
            })
        return out

    def conv(k, cin, cout):
        # drawn HIO as in JAX (scale 1/sqrt(Cin)), stored [Cout, Cin, K]
        return w(k, cin, cout).permute(2, 1, 0).contiguous()

    return {
        "conv1": conv(3, cfg.num_mel_bins, d),
        "conv1_b": zeros(d),
        "conv2": conv(3, d, d),
        "conv2_b": zeros(d),
        "enc_layers": layers(cfg.encoder_layers, cross=False),
        "enc_ln": ones(d),
        "enc_ln_b": zeros(d),
        "tok_embed": w(cfg.vocab_size, d, scale=0.02),
        "pos_embed": w(cfg.max_target_positions, d, scale=0.02),
        "dec_layers": layers(cfg.decoder_layers, cross=True),
        "dec_ln": ones(d),
        "dec_ln_b": zeros(d),
    }


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _ln(x, w, b, eps: float = 1e-5):
    """LayerNorm with fp32 statistics, rounded to x's dtype BEFORE the
    affine (JAX's order)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


def _heads(x, n: int):  # [B, T, D] -> [B, T, H, hd]
    B, T, D = x.shape
    return x.reshape(B, T, n, D // n)


def _mha(q, k, v, scale: float, mask=None):
    """q/k/v: [B, T, H, hd]; scores rounded to q's dtype, then an fp32
    softmax; masked scores are -1e30. Returns [B, Tq, D]."""
    scores = torch.einsum("bthd,bshd->bhts", q, k).float() * scale
    if mask is not None:
        scores = torch.where(mask, scores, _NEG)
    weights = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhts,bshd->bthd", weights, v)
    B, T = out.shape[0], out.shape[1]
    return out.reshape(B, T, -1)


def sinusoids(length: int, channels: int, device=None) -> torch.Tensor:
    """Whisper's fixed sinusoidal encoder positions (fp32)."""
    log_timescale = math.log(10000) / (channels // 2 - 1)
    inv = torch.exp(
        -log_timescale
        * torch.arange(channels // 2, dtype=torch.float32, device=device)
    )
    scaled = (
        torch.arange(length, dtype=torch.float32, device=device)[:, None]
        * inv[None, :]
    )
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1)


def _conv1d(x, w, b, stride: int):
    """x [B, T, Cin], w [Cout, Cin, K]: SAME padding (Whisper's
    Conv1d(kernel=3, padding=1)); the bias is added after the rounded
    convolution, as in JAX."""
    y = F.conv1d(x.transpose(1, 2), w, stride=stride, padding=1)
    return y.transpose(1, 2) + b


def _gelu(x):
    return F.gelu(x, approximate="tanh")     # jax.nn.gelu's default


def encode(params: Params, cfg: WhisperConfig, mel: torch.Tensor):
    """mel [B, frames, n_mels] (frames = 2 * max_source_positions) ->
    encoder states [B, max_source_positions, D]."""
    dtype = _compute_dtype(cfg)
    x = mel.to(dtype)
    x = _gelu(_conv1d(x, params["conv1"], params["conv1_b"], 1))
    x = _gelu(_conv1d(x, params["conv2"], params["conv2_b"], 2))
    x = x + sinusoids(x.shape[1], cfg.d_model, x.device).to(dtype)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    lps = params["enc_layers"]
    for i in range(cfg.encoder_layers):
        lp = {k: t[i] for k, t in lps.items()}
        h = _ln(x, lp["ln1"], lp["ln1_b"])
        q = _heads(h @ lp["wq"] + lp["bq"], cfg.num_heads)
        k = _heads(h @ lp["wk"], cfg.num_heads)
        v = _heads(h @ lp["wv"] + lp["bv"], cfg.num_heads)
        x_mid = x + _mha(q, k, v, scale) @ lp["wo"] + lp["bo"]
        h2 = _ln(x_mid, lp["ln2"], lp["ln2_b"])
        mlp = _gelu(h2 @ lp["w_up"] + lp["b_up"])
        x = x_mid + mlp @ lp["w_down"] + lp["b_down"]
    return _ln(x, params["enc_ln"], params["enc_ln_b"])


@dataclasses.dataclass
class DecCache:
    """Decoder KV cache: self-attn K/V [L, B, S, H, hd], written in place."""

    k: torch.Tensor
    v: torch.Tensor

    @staticmethod
    def create(cfg: WhisperConfig, batch: int, dtype=torch.bfloat16,
               device=None) -> "DecCache":
        shape = (
            cfg.decoder_layers, batch, cfg.max_target_positions,
            cfg.num_heads, cfg.head_dim,
        )
        return DecCache(
            torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device),
        )


def cross_kv(
    params: Params, cfg: WhisperConfig, enc_states: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project encoder states to per-layer cross-attn K/V ONCE per
    utterance (``[L, B, S_enc, H, hd]`` each), not in every decode
    step."""
    dl = params["dec_layers"]
    L = cfg.decoder_layers
    B, S, D = enc_states.shape
    k = enc_states[None] @ dl["xwk"][:, None]                # [L, B, S, D]
    v = enc_states[None] @ dl["xwv"][:, None] + dl["xbv"][:, None, None]
    shape = (L, B, S, cfg.num_heads, cfg.head_dim)
    return k.reshape(shape), v.reshape(shape)


def decode_step(
    params: Params,
    cfg: WhisperConfig,
    tokens: torch.Tensor,     # [B, 1] int
    position: int,
    xk: torch.Tensor,         # [L, B, S_enc, H, hd] from cross_kv
    xv: torch.Tensor,
    cache: DecCache,
) -> Tuple[torch.Tensor, DecCache]:
    """One decode step at ``position`` (the cache is written in place);
    returns (logits [B, vocab] fp32, cache)."""
    dtype = _compute_dtype(cfg)
    x = params["tok_embed"][tokens[:, 0]].to(dtype)
    x = x + params["pos_embed"][position].to(dtype)
    x = x[:, None, :]                                     # [B, 1, D]
    scale = 1.0 / math.sqrt(cfg.head_dim)
    S = cfg.max_target_positions
    mask = (torch.arange(S, device=x.device) <= position)[None, None, None, :]
    lps = params["dec_layers"]
    for i in range(cfg.decoder_layers):
        lp = {k: t[i] for k, t in lps.items()}
        h = _ln(x, lp["ln1"], lp["ln1_b"])
        q = _heads(h @ lp["wq"] + lp["bq"], cfg.num_heads)
        k = _heads(h @ lp["wk"], cfg.num_heads)
        v = _heads(h @ lp["wv"] + lp["bv"], cfg.num_heads)
        cache.k[i, :, position] = k[:, 0]
        cache.v[i, :, position] = v[:, 0]
        x_mid = x + _mha(q, cache.k[i], cache.v[i], scale, mask) @ lp[
            "wo"] + lp["bo"]
        hx = _ln(x_mid, lp["lnx"], lp["lnx_b"])
        xq = _heads(hx @ lp["xwq"] + lp["xbq"], cfg.num_heads)
        x_mid = x_mid + _mha(xq, xk[i], xv[i], scale) @ lp["xwo"] + lp["xbo"]
        h2 = _ln(x_mid, lp["ln2"], lp["ln2_b"])
        mlp = _gelu(h2 @ lp["w_up"] + lp["b_up"])
        x = x_mid + mlp @ lp["w_down"] + lp["b_down"]
    x = _ln(x, params["dec_ln"], params["dec_ln_b"])
    logits = x @ params["tok_embed"].T
    return logits[:, 0].float(), cache


def greedy_transcribe(
    params: Params,
    cfg: WhisperConfig,
    mel: np.ndarray,          # [frames, n_mels]
    prompt_ids: Tuple[int, ...] = (),
    max_tokens: int = 0,
) -> list:
    """Greedy decode one utterance on the params' device; returns the
    generated token ids."""
    max_tokens = max_tokens or cfg.max_target_positions
    device = params["tok_embed"].device
    with torch.no_grad():
        enc = encode(
            params, cfg, torch.as_tensor(mel, dtype=torch.float32)[None].to(
                device)
        )
        xk, xv = cross_kv(params, cfg, enc)
        cache = DecCache.create(cfg, 1, _compute_dtype(cfg), device)
        ids = [cfg.decoder_start_token_id, *prompt_ids]
        out = []
        # feed the forced prompt, then generate
        token = ids[0]
        for pos in range(
            min(cfg.max_target_positions - 1, len(ids) - 1 + max_tokens)
        ):
            logits, cache = decode_step(
                params, cfg,
                torch.tensor([[token]], dtype=torch.int64, device=device),
                pos, xk, xv, cache,
            )
            if pos + 1 < len(ids):
                token = ids[pos + 1]        # forced prompt token
                continue
            token = int(torch.argmax(logits[0]))
            if token == cfg.eos_token_id:
                break
            out.append(token)
    return out
