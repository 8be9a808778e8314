"""Vectorized token samplers (the port of ``gpustack_tpu/engine/sampling.py``).

All sampling state is per-slot tensors of shape ``[B]`` on the model's
device, so one ``sample`` call serves a heterogeneous continuous batch.
Besides the sampled token, :func:`sample` returns the token's logprob and
the top-``TOPLP`` (id, logprob) candidates for the OpenAI ``logprobs``
fields; logprobs are exact, normalized by the full-vocab logsumexp.

Noise: the JAX sampler draws Gumbel noise from threefry keys. Here every
noise value is a counter-based hash of (stream, position, candidate rank)
computed on the device — no host round trip and no per-row generator. A
seeded row's stream derives from its OpenAI ``seed`` alone, so it replays
identically; an unseeded row's stream derives from the step key (drawn by
the engine from a seeded ``torch.Generator``) and its row index. The two
frameworks therefore draw different noise from the same seed: greedy
tokens and every logprob agree with JAX, sampled tokens agree only in
distribution.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

# Sampling never looks past the top CAND candidates (exact for greedy and
# for top_k <= CAND; pure temperature sampling is truncated to the top-64).
CAND = 64
# Top-logprob candidates returned per step (OpenAI caps top_logprobs at 20).
TOPLP = 20
# logit_bias entries per request, applied to the FULL logits before ranking.
MAX_BIAS = 64


def _i64(c: int) -> int:
    """An unsigned 64-bit constant as the signed value torch stores."""
    return c - (1 << 64) if c >= (1 << 63) else c


_GOLDEN = _i64(0x9E3779B97F4A7C15)
_M1 = _i64(0xBF58476D1CE4E5B9)
_M2 = _i64(0x94D049BB133111EB)
_SEEDED_SALT = 0x5EED


def _srl(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int64 (torch's >> is arithmetic)."""
    return (x >> n) & ((1 << (64 - n)) - 1)


def _mix(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer on int64 tensors (multiplication wraps)."""
    x = x + _GOLDEN
    x = (x ^ _srl(x, 30)) * _M1
    x = (x ^ _srl(x, 27)) * _M2
    return x ^ _srl(x, 31)


def gumbel_noise(
    streams: torch.Tensor, positions: torch.Tensor, n: int
) -> torch.Tensor:
    """[B, n] standard Gumbel noise from int64 ``streams`` [B] and
    ``positions`` [B]: a pure function of its inputs, on their device."""
    cols = torch.arange(n, device=streams.device, dtype=torch.int64)
    x = _mix(_mix(streams ^ _mix(positions.to(torch.int64)))[:, None] ^ cols)
    u = (_srl(x, 40).to(torch.float32) + 0.5) / float(1 << 24)   # (0, 1)
    return -torch.log(-torch.log(u))


@dataclasses.dataclass
class SamplingState:
    """Per-slot sampling parameters, shape ``[B]`` each (updated in place).

    ``temperature == 0`` selects greedy decoding for that slot.
    ``top_k == 0`` / ``top_p == 1`` disable the respective filters.
    ``seeded`` rows draw noise from ``(seed, position)`` only."""

    temperature: torch.Tensor  # f32 [B]
    top_k: torch.Tensor        # i64 [B]
    top_p: torch.Tensor        # f32 [B]
    seed: torch.Tensor         # i64 [B]
    seeded: torch.Tensor       # bool [B]
    bias_ids: torch.Tensor     # i64 [B, MAX_BIAS] (-1 = unused slot)
    bias_vals: torch.Tensor    # f32 [B, MAX_BIAS]

    @staticmethod
    def create(batch: int, device) -> "SamplingState":
        return SamplingState(
            temperature=torch.zeros(batch, device=device),
            top_k=torch.zeros(batch, dtype=torch.int64, device=device),
            top_p=torch.ones(batch, device=device),
            seed=torch.zeros(batch, dtype=torch.int64, device=device),
            seeded=torch.zeros(batch, dtype=torch.bool, device=device),
            bias_ids=torch.full(
                (batch, MAX_BIAS), -1, dtype=torch.int64, device=device
            ),
            bias_vals=torch.zeros(batch, MAX_BIAS, device=device),
        )

    def rows(self, start: int, n: int) -> "SamplingState":
        """Rows ``start .. start + n - 1`` (views): one ``dp`` group's
        slots."""
        return SamplingState(*(
            getattr(self, f.name)[start:start + n]
            for f in dataclasses.fields(self)
        ))

    def set_slot(
        self, slot: int, temperature: float, top_k: int, top_p: float,
        seed: int = 0, seeded: bool = False,
        logit_bias: Optional[Dict[int, float]] = None,
    ) -> None:
        ids, vals = bias_lists(logit_bias)
        self.temperature[slot] = float(temperature)
        self.top_k[slot] = int(top_k)
        self.top_p[slot] = float(top_p)
        self.seed[slot] = int(seed)
        self.seeded[slot] = bool(seeded)
        dev = self.bias_ids.device
        self.bias_ids[slot] = torch.tensor(ids, dtype=torch.int64, device=dev)
        self.bias_vals[slot] = torch.tensor(
            vals, dtype=torch.float32, device=dev
        )


def bias_lists(logit_bias) -> Tuple[list, list]:
    """{token_id: bias} → fixed-width (ids, vals) lists (-1 = unused)."""
    ids = [-1] * MAX_BIAS
    vals = [0.0] * MAX_BIAS
    if logit_bias:
        for j, (tid, bias) in enumerate(list(logit_bias.items())[:MAX_BIAS]):
            ids[j] = int(tid)
            vals[j] = float(bias)
    return ids, vals


def _row_streams(
    state: SamplingState, key: int, row0: int = 0
) -> torch.Tensor:
    """Seeded rows: a stream from their seed only; unseeded rows: from the
    step key and row index (``row0`` the first row's slot), so identical
    concurrent prompts diverge."""
    B = state.seed.shape[0]
    rows = torch.arange(row0, row0 + B, device=state.seed.device,
                        dtype=torch.int64)
    step = _mix(_mix(torch.full_like(rows, _i64(key % (1 << 64)))) ^ rows)
    seeded = _mix(state.seed ^ _SEEDED_SALT)
    return torch.where(state.seeded, seeded, step)


def sample(
    logits: torch.Tensor,                    # [B, V] f32
    state: SamplingState,
    key: int = 0,
    positions: Optional[torch.Tensor] = None,  # [B]; seeded rows need it
    row0: int = 0,                           # slot of row 0
):
    """Sample one token per row honoring per-row temperature/top-k/top-p,
    seeds and logit bias. Row i draws slot ``row0 + i``'s noise (a ``dp``
    group's rows, as in the whole batch). Returns ``(tokens i64[B],
    token_logprob f32[B], top_ids i64[B, TOPLP], top_logprobs f32[B,
    TOPLP])``."""
    B, V = logits.shape
    valid = state.bias_ids >= 0
    bias_cols = state.bias_ids.clamp(0, V - 1)
    bias_vals = torch.where(
        valid, state.bias_vals, torch.zeros_like(state.bias_vals)
    )
    logits = logits.float().scatter_add(1, bias_cols, bias_vals)
    n = min(CAND, V)
    top_logits, top_idx = torch.topk(logits, n, dim=-1)   # descending

    temp = state.temperature.clamp_min(1e-6)[:, None]
    scaled = top_logits / temp

    # top-k: mask candidates at rank >= k
    k = torch.where(
        state.top_k > 0, state.top_k.clamp_max(n), torch.full_like(state.top_k, n)
    )
    rank = torch.arange(n, device=logits.device)[None, :]
    neg_inf = torch.tensor(float("-inf"), device=logits.device)
    masked = torch.where(rank >= k[:, None], neg_inf, scaled)

    # top-p over the sorted candidates: keep the smallest prefix reaching p
    probs = torch.softmax(scaled, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < state.top_p[:, None]
    masked = torch.where(keep, masked, neg_inf)

    if positions is None:
        positions = torch.zeros(B, dtype=torch.int64, device=logits.device)
    noise = gumbel_noise(_row_streams(state, key, row0), positions, n)
    choice = torch.argmax(masked + noise, dim=-1)
    choice = torch.where(
        state.temperature > 0, choice, torch.zeros_like(choice)
    )
    tokens = torch.gather(top_idx, 1, choice[:, None])[:, 0]

    lse = torch.logsumexp(logits, dim=-1)
    token_logprob = torch.gather(top_logits, 1, choice[:, None])[:, 0] - lse
    m = min(TOPLP, n)
    return tokens, token_logprob, top_idx[:, :m], top_logits[:, :m] - lse[:, None]
