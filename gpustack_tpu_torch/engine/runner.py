"""Model execution on one device: prefill, insert, decode.

The port of ``gpustack_tpu/engine/runner.py`` for a single card (no mesh):

- one resident **decode batch** of ``max_slots`` rows over a shared KV
  cache; ``decode_step`` advances every slot one token per call;
- **prefill** runs per request at a power-of-two bucketed length into a
  scratch cache; **insert** copies the prompt KV into the slot's rows. Pad
  positions are harmless: a slot's decode write at position p lands
  before any query attends p;
- all sequencing state (last token, position, active mask) lives **on the
  device** and is updated in place, so the decode loop never waits on the
  host; the engine fetches sampled tokens a few steps behind;
- a slot deactivates on the device when it reaches ``max_seq_len``.

PyTorch runs eagerly, so there are no per-shape compilations to cache:
the buckets bound the set of prefill shapes the kernel sees.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence, Tuple

import torch

from gpustack_tpu_torch.engine.sampling import SamplingState, sample
from gpustack_tpu_torch.models.config import ModelConfig
from gpustack_tpu_torch.models.transformer import (
    KVCache,
    check_supported,
    forward,
    lm_head,
)


@dataclasses.dataclass
class DecodeState:
    """Device-resident continuous-batch state (updated in place)."""

    cache: KVCache
    last_tokens: torch.Tensor   # i64 [B] — token to feed next step
    positions: torch.Tensor     # i64 [B] — next write position (== seq len)
    active: torch.Tensor        # bool [B]
    sampling: SamplingState

    @staticmethod
    def create(
        cfg: ModelConfig, batch: int, max_len: int, device
    ) -> "DecodeState":
        return DecodeState(
            cache=KVCache.create(cfg, batch, max_len, device),
            last_tokens=torch.zeros(batch, dtype=torch.int64, device=device),
            positions=torch.zeros(batch, dtype=torch.int64, device=device),
            active=torch.zeros(batch, dtype=torch.bool, device=device),
            sampling=SamplingState.create(batch, device),
        )


class ModelRunner:
    """Owns the params and the prefill/insert/decode ops for one model."""

    def __init__(
        self,
        cfg: ModelConfig,
        params: Dict[str, Any],
        device: torch.device,
        max_slots: int = 8,
        max_seq_len: int = 1024,
        prefill_buckets: Tuple[int, ...] = (),
    ):
        check_supported(cfg)
        self.cfg = cfg
        self.params = params
        self.device = torch.device(device)
        self.max_slots = max_slots
        self.max_seq_len = max_seq_len
        if not prefill_buckets:
            b, buckets = 32, []
            while b < max_seq_len:
                buckets.append(b)
                b *= 2
            buckets.append(max_seq_len)
            prefill_buckets = tuple(buckets)
        self.prefill_buckets = tuple(sorted(set(prefill_buckets)))

    # -- state ------------------------------------------------------------

    def new_state(self) -> DecodeState:
        return DecodeState.create(
            self.cfg, self.max_slots, self.max_seq_len, self.device
        )

    # -- prefill ----------------------------------------------------------

    def bucket_for(self, length: int) -> int:
        for b in self.prefill_buckets:
            if length <= b:
                return b
        raise ValueError(
            f"prompt length {length} exceeds max bucket "
            f"{self.prefill_buckets[-1]}"
        )

    def attn_impl_for(self, bucket: int) -> str:
        """Prefill attention per bucket: the hand-written flash kernel for
        EVERY bucket on the card, the plain version on the CPU. (The JAX
        runner's >= 1024 threshold is a TPU reason — the XLA score tensor;
        on the card the alternative would be the plain version, which the
        main path must not take.)"""
        return "flash" if self.device.type == "cuda" else "plain"

    def prefill(self, token_ids: Sequence[int], true_len: int):
        """Run prefill at the bucket for ``true_len``. ``token_ids`` must be
        padded to the bucket length already (any pad id). Returns
        ``(last_logits [V] fp32, k, v [L, Tb, H, hd])``."""
        Tb = len(token_ids)
        if Tb not in self.prefill_buckets:
            raise ValueError(f"{Tb} is not a bucket {self.prefill_buckets}")
        if not 0 < true_len <= Tb:
            raise ValueError(f"true_len {true_len} outside 1..{Tb}")
        tokens = torch.tensor(
            [list(token_ids)], dtype=torch.int64, device=self.device
        )
        positions = torch.arange(Tb, device=self.device)[None, :]
        cache = KVCache.create(self.cfg, 1, Tb, self.device)
        hidden, cache = forward(
            self.params, self.cfg, tokens, positions, cache,
            return_hidden=True, attn_impl=self.attn_impl_for(Tb),
        )
        # logits for the one position the sampler reads, not all Tb rows
        last = lm_head(self.params, self.cfg, hidden[0, true_len - 1])
        return last, cache.k[:, 0], cache.v[:, 0]

    # -- sampling ---------------------------------------------------------

    def sample_first(
        self, last_logits, temperature, top_k, top_p, seed, seeded,
        position: int, key: int, logit_bias=None,
    ):
        """Sample the first generated token from a prefill's last-position
        logits through the same sampler as decode."""
        st = SamplingState.create(1, self.device)
        st.set_slot(0, temperature, top_k, top_p, seed, seeded, logit_bias)
        pos = torch.tensor([position], dtype=torch.int64, device=self.device)
        return sample(last_logits[None, :], st, key, pos)

    # -- insert -----------------------------------------------------------

    def insert(
        self, state: DecodeState, k, v, slot: int, true_len: int,
        first_token, temperature: float, top_k: int, top_p: float,
        seed: int = 0, seeded: bool = False, logit_bias=None,
    ) -> DecodeState:
        """Copy a prefill's KV into ``slot`` and activate it (in place).
        ``first_token`` may be an int or a one-element device tensor."""
        Tb = k.shape[1]
        if Tb > self.max_seq_len:
            raise ValueError(f"prefill width {Tb} > max_seq_len")
        state.cache.k[:, slot, :Tb] = k
        state.cache.v[:, slot, :Tb] = v
        if isinstance(first_token, torch.Tensor):
            state.last_tokens[slot] = first_token.reshape(())
        else:
            state.last_tokens[slot] = int(first_token)
        state.positions[slot] = int(true_len)
        state.active[slot] = True
        state.sampling.set_slot(
            slot, temperature, top_k, top_p, seed, seeded, logit_bias
        )
        return state

    def deactivate(self, state: DecodeState, slot: int) -> DecodeState:
        state.active[slot] = False
        return state

    def slot_kv(self, state: DecodeState, slot: int, width: int):
        """Copies of a slot's KV rows ``[:width]``."""
        return (
            state.cache.k[:, slot, :width].clone(),
            state.cache.v[:, slot, :width].clone(),
        )

    # -- decode -----------------------------------------------------------

    def decode_step(self, state: DecodeState, key: int):
        """One decode step (in place). Returns ``(state, (tokens [B],
        token_logprob [B], top_ids [B, TOPLP], top_logprobs [B, TOPLP]))``
        as fresh device tensors the caller may hold across later steps."""
        tokens = state.last_tokens[:, None]
        positions = state.positions[:, None]
        logits, _ = forward(
            self.params, self.cfg, tokens, positions, state.cache,
        )
        out = sample(logits[:, 0], state.sampling, key, state.positions)
        sampled = out[0]
        # inactive slots keep feeding their last token at a frozen
        # position; their writes stay in their own rows, invisible to any
        # later tenant through the causal mask
        state.last_tokens.copy_(
            torch.where(state.active, sampled, state.last_tokens)
        )
        at_capacity = state.positions + 1 >= self.max_seq_len
        state.positions.copy_(torch.where(
            state.active,
            (state.positions + 1).clamp_max(self.max_seq_len - 1),
            state.positions,
        ))
        state.active &= ~at_capacity
        return state, out


def greedy_reference(
    params, cfg: ModelConfig, prompt_ids, n: int, device
) -> list:
    """Greedy generation by repeated full forward (no cache): the slow but
    plainly correct oracle the tests and the chip smoke hold the engine to."""
    ids = list(prompt_ids)
    out = []
    for _ in range(n):
        toks = torch.tensor([ids], dtype=torch.int64, device=device)
        pos = torch.arange(len(ids), device=device)[None, :]
        logits, _ = forward(params, cfg, toks, pos)
        nxt = int(torch.argmax(logits[0, -1]))
        out.append(nxt)
        ids.append(nxt)
    return out
