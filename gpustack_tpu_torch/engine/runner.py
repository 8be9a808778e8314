"""Model execution on one device: prefill, insert, decode.

The port of ``gpustack_tpu/engine/runner.py`` for a single card (no mesh):

- one resident **decode batch** of ``max_slots`` rows over a shared KV
  cache; ``decode_step`` advances every slot one token per call;
- **prefill** runs per request at a power-of-two bucketed length into a
  scratch cache; **prefill_with_prefix** continues one from a prefix on
  the device (a host KV cache hit, or a chunked prefill's earlier
  chunks); **insert** copies the prompt KV into the slot's rows. Pad
  positions are harmless: a slot's decode write at position p lands
  before any query attends p;
- all sequencing state (last token, position, active mask) lives **on the
  device** and is updated in place, so the decode loop never waits on the
  host; the engine fetches sampled tokens a few steps behind;
- a slot deactivates on the device when it reaches ``max_seq_len``;
- **speculation**: ``verify_step`` checks a block of proposals per slot in
  one forward and accepts the longest greedy-matching prefix plus a bonus
  token; a draft model's runner catches up with ``ingest_step`` and
  rewinds its proposals with ``snapshot_sequence``/``restore_sequence``;
- **embed**: one cacheless forward over a padded batch, mean-pooled and
  l2-normalised.

PyTorch runs eagerly, so there are no per-shape compilations to cache:
the buckets bound the set of prefill shapes the kernel sees.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence, Tuple

import torch

from gpustack_tpu_torch.engine.sampling import SamplingState, sample
from gpustack_tpu_torch.engine.weights import params_to_device
from gpustack_tpu_torch.models.config import ModelConfig
from gpustack_tpu_torch.models.transformer import (
    KVCache,
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
        self.cfg = cfg
        self.device = torch.device(device)
        # int8 QuantW leaves go to the device as they are, never widened
        self.params = params_to_device(params, self.device)
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

    def prefill_with_prefix(
        self, prefix_k, prefix_v, prefix_len: int,
        suffix_ids: Sequence[int], suffix_true_len: int, total_bucket: int,
    ):
        """Continue a prefill from a prefix already on the device (a host
        cache hit, or the chunks done so far): seed a scratch cache of
        ``total_bucket`` rows with ``prefix_k/v`` ``[L, Pb, H, hd]`` and
        run the suffix (pre-padded to a bucket ``Tsb``) at positions
        ``prefix_len + j``. Prefix rows at or above ``prefix_len`` are pad:
        the suffix overwrites them, or they sit above every query and the
        causal mask hides them. The attention follows the TOTAL width
        (on the card: the flash kernel with ``q_offset = prefix_len``,
        ``T = Tsb``, ``S = total_bucket``). Returns ``(last_logits [V]
        fp32 of suffix row suffix_true_len - 1, k, v [L, total_bucket, H,
        hd])``.

        Bounds: the suffix block must fit inside ``total_bucket``
        (``prefix_len + Tsb <= total_bucket``); the engine's guards trim
        the prefix so it always does, and a call that breaks it raises
        here instead of writing past the cache."""
        Pb = prefix_k.shape[1]
        Tsb = len(suffix_ids)
        if Tsb not in self.prefill_buckets:
            raise ValueError(f"{Tsb} is not a bucket {self.prefill_buckets}")
        if total_bucket not in self.prefill_buckets:
            raise ValueError(f"total width {total_bucket} is not a bucket")
        if not 0 < prefix_len <= Pb <= total_bucket:
            raise ValueError(
                f"prefix of {prefix_len} tokens in {Pb} rows does not fit "
                f"{total_bucket}"
            )
        if prefix_len + Tsb > total_bucket:
            raise ValueError(
                f"suffix block {prefix_len}+{Tsb} overflows {total_bucket}"
            )
        if not 0 < suffix_true_len <= Tsb:
            raise ValueError(
                f"suffix_true_len {suffix_true_len} outside 1..{Tsb}"
            )
        cache = KVCache.create(self.cfg, 1, total_bucket, self.device)
        cache.k[:, 0, :Pb] = prefix_k
        cache.v[:, 0, :Pb] = prefix_v
        tokens = torch.tensor(
            [list(suffix_ids)], dtype=torch.int64, device=self.device
        )
        positions = (
            prefix_len + torch.arange(Tsb, device=self.device)
        )[None, :]
        hidden, cache = forward(
            self.params, self.cfg, tokens, positions, cache,
            return_hidden=True, attn_impl=self.attn_impl_for(total_bucket),
            q_offset=prefix_len,
        )
        last = lm_head(self.params, self.cfg, hidden[0, suffix_true_len - 1])
        return last, cache.k[:, 0], cache.v[:, 0]

    # -- embeddings -------------------------------------------------------

    def embed(self, batch_token_ids, true_lens) -> torch.Tensor:
        """Mean-pooled, l2-normalised fp32 hidden states ``[N, D]`` from
        one batched cacheless forward. ``batch_token_ids`` is ``[N][Tb]``,
        every row pre-padded to one bucket ``Tb``; the batch is padded to
        a power of two with empty rows (true length 0, pooled to zero) so
        the kernel sees a bounded set of shapes. On the card the attention
        is the flash kernel (``attn_impl_for``), as for every prefill."""
        Tb = len(batch_token_ids[0])
        if Tb not in self.prefill_buckets:
            raise ValueError(f"{Tb} is not a bucket {self.prefill_buckets}")
        N = len(batch_token_ids)
        Nb = 1
        while Nb < N:
            Nb *= 2
        padded = [list(r) for r in batch_token_ids] + [[0] * Tb] * (Nb - N)
        lens = list(true_lens) + [0] * (Nb - N)
        tokens = self._ids_on_device(padded)
        positions = torch.arange(Tb, device=self.device)[None, :].expand(
            Nb, Tb
        )
        hidden, _ = forward(
            self.params, self.cfg, tokens, positions, return_hidden=True,
            attn_impl=self.attn_impl_for(Tb),
        )
        lens_t = self._ids_on_device(lens)
        mask = (positions < lens_t[:, None])[..., None].float()
        pooled = (hidden * mask).sum(dim=1) / mask.sum(dim=1).clamp_min(1.0)
        norm = pooled.norm(dim=-1, keepdim=True)
        return (pooled / norm.clamp_min(1e-9))[:N]

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
        ``k``/``v`` are a bucket wide, or ``total_bucket`` wide after a
        continuation prefill; rows past ``true_len`` are pad that decode
        overwrites before any query reads it. ``first_token`` may be an int
        or a one-element device tensor."""
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

    def _ids_on_device(self, ids) -> torch.Tensor:
        """Token ids (host or device) as int64 on the device. A host
        tensor goes through pinned memory without blocking: a pageable
        copy to the card synchronises the stream, which would stall the
        dispatch-ahead pipeline on every speculative step."""
        if isinstance(ids, torch.Tensor) and ids.device.type != "cpu":
            return ids.long()
        host = torch.as_tensor(ids, dtype=torch.int64)
        if self.device.type != "cuda":
            return host
        return host.pin_memory().to(self.device, non_blocking=True)

    def _block_positions(self, state: DecodeState, P: int) -> torch.Tensor:
        """``[B, P]`` positions of a block fed from each row's position."""
        return state.positions[:, None] + torch.arange(
            P, device=self.device
        )[None, :]

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

    # -- draft-model support ---------------------------------------------

    def ingest_step(self, state: DecodeState, tokens, counts) -> DecodeState:
        """Ingest already-accepted tokens into the cache (the draft's
        catch-up), in place. ``tokens`` ``[B, P]`` (pad arbitrary),
        ``counts`` ``[B]``. The state invariant is decode's and verify's
        ``(pos, last)``: KV complete below ``pos``, ``last`` not yet fed.
        So the block fed is ``[last, tokens[0 .. P-2]]``, after which
        ``pos += counts`` (capped at ``max_seq_len - 1``) and ``last``
        becomes each row's final ingested token; rows with count 0 keep
        both. Pad positions land above the new position, hidden by the
        causal mask until overwritten. The JAX forward's logits are
        discarded, so this one stops at the hidden states."""
        tokens = self._ids_on_device(tokens)
        counts = self._ids_on_device(counts)
        P = tokens.shape[1]
        fed = torch.cat([state.last_tokens[:, None], tokens[:, : P - 1]], 1)
        forward(
            self.params, self.cfg, fed, self._block_positions(state, P),
            state.cache, return_hidden=True, clamp_writes=True,
        )
        last_idx = (counts - 1).clamp_min(0)
        new_last = tokens.gather(1, last_idx[:, None])[:, 0]
        state.last_tokens.copy_(
            torch.where(counts > 0, new_last, state.last_tokens)
        )
        state.positions.copy_(
            (state.positions + counts).clamp_max(self.max_seq_len - 1)
        )
        return state

    def snapshot_sequence(self, state: DecodeState):
        """Copies of ``(positions, last_tokens)``: restore them after a
        proposal run to rewind the draft (its cache entries above the
        restored positions are masked out)."""
        return state.positions.clone(), state.last_tokens.clone()

    def restore_sequence(self, state: DecodeState, snap) -> DecodeState:
        positions, last_tokens = snap
        state.positions.copy_(positions)
        state.last_tokens.copy_(last_tokens)
        return state

    # -- speculative decoding (greedy verify) -----------------------------

    def verify_step(self, state: DecodeState, proposals):
        """Greedy speculative verification (in place).

        ``proposals`` ``[B, P]`` (host or device): the first P-1 entries
        are candidate continuations, the last is padding, so one shape
        serves propose-and-bonus. Feeds ``[last, p_0 .. p_{P-2}]`` at P
        positions; per row the longest matching proposal prefix is
        accepted plus one bonus token from the model's own argmax chain.
        Returns ``(state, tokens [B, P], produced [B])``:
        ``tokens[b, :produced[b]]`` are the new tokens (1..P per active
        row, 0 for an inactive one).

        Callers keep ``position + P < max_seq_len`` for every active row
        (the engine falls back to plain decode near capacity): the block's
        KV write is contiguous. An inactive row's block is clamped inside
        the cache, as the JAX write is."""
        proposals = self._ids_on_device(proposals)
        P = proposals.shape[1]
        fed = torch.cat(
            [state.last_tokens[:, None], proposals[:, : P - 1]], 1
        )
        logits, _ = forward(
            self.params, self.cfg, fed, self._block_positions(state, P),
            state.cache, clamp_writes=True,
        )
        greedy = logits.argmax(dim=-1)                          # [B, P]
        match = (proposals[:, : P - 1] == greedy[:, : P - 1]).long()
        n_accept = match.cumprod(dim=1).sum(dim=1)              # 0..P-1
        produced = torch.where(state.active, n_accept + 1, 0)
        new_last = greedy.gather(1, n_accept[:, None])[:, 0]
        state.last_tokens.copy_(
            torch.where(state.active, new_last, state.last_tokens)
        )
        state.positions.copy_(torch.where(
            state.active,
            (state.positions + produced).clamp_max(self.max_seq_len - 1),
            state.positions,
        ))
        state.active &= ~(state.positions + 1 >= self.max_seq_len)
        return state, greedy, produced


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
