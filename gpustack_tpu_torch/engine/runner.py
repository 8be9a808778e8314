"""Model execution on one device, or one rank of a mesh: prefill, insert,
decode.

The port of ``gpustack_tpu/engine/runner.py``:

- one resident **decode batch** of ``max_slots`` rows over a shared KV
  cache; ``decode_step`` advances every slot one token per call;
- **prefill** runs per request at a power-of-two bucketed length into a
  scratch cache; **prefill_with_prefix** continues one from a prefix on
  the device (a host KV cache hit, or a chunked prefill's earlier
  chunks); **prefill_with_embeds** splices a VLM prompt's image
  embeddings in; **insert** copies the prompt KV into the slot's rows. Pad
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
  l2-normalised (over a mesh: on every rank of the first ``dp`` group;
  under ``sp`` a ring prefill, each rank's pooled sums reduced over the
  group).

- **a mesh** (``plan`` and ``mesh``, one process per GPU): the params
  are the rank's shard, the KV cache holds the rank's KV heads
  (``SpecLayout.cache``), the slot state is whole on every rank
  (``SpecLayout.slot_state``), and every forward is the sharded one
  (``models.transformer``). After each decode step rank 0's sampled
  tokens are broadcast to every rank on the device, with no host read, so
  the ranks' slot states cannot part even where a tie would break
  differently. Every rank runs the same calls in the same order (the
  leader's command channel, ``engine/multihost.py``).
- **sequence parallelism** (``plan.sp > 1``, the JAX runner's
  ``sp_mode``): the KV cache is sequence-sharded for the whole
  generation, each rank holding ``max_seq_len / sp`` positions of every
  slot (``SpecLayout(long_context=True).cache``). A prefill from zero
  splits its bucket's tokens over ``sp`` (every layer but attention runs
  on the rank's own tokens; the attention is the ring,
  ``ops/ring_attention.py``) and returns the rank's block of the bucket's
  K/V; the last position's hidden row comes from the rank that holds it.
  A continuation chunk, a decode step and a verify or ingest block run
  their tokens whole on every rank against the sharded cache (the merged
  attention; a block's write masked to the owning rank on the device).
  ``insert`` moves each prefill block's K/V to the ranks that own those
  cache positions, point to point over the ``sp`` group, planned from
  host integers alone (:class:`KVLayout`: a bucket's blocks, the decode
  cache's segments, the host tier's stripes). Only buckets that divide
  over ``sp`` are kept.
- **data parallelism** (``plan.dp > 1``, the JAX layout's ``P(None,
  'dp', ...)`` cache): ``dp`` groups, each a copy of the model over its
  ``sp x ep x tp`` ranks, and group ``g`` holds the cache rows of slots
  ``g·B/dp .. (g+1)·B/dp - 1``; the slot vectors stay whole on every rank.
  A prefill that names its slot runs on the owning group only, and rank 0
  receives its first-token logits from the group's first rank (a prefill
  that names none runs on every group, as GSPMD runs a batch of one);
  ``insert`` writes K/V on the owning group only. A decode step forwards
  each group's rows on that group and gathers the sampled rows (tokens
  and logprobs, one world all-gather on the device) into every rank's
  whole vectors. A verify step runs each group's rows the same way and
  gathers its accepted tokens; a host-tier store (``kv_store``) sends the
  owning group's K/V rows to every other group's ranks at the same heads,
  so each rank's host tier holds every block.
- **the host KV tier and speculation over a mesh**: ``slot_kv`` copies
  the rank's heads of a slot's rows (under ``sp`` its segment's part of
  them); ``kv_store`` gives what the rank's tier keeps (under ``sp`` its
  stripes of each block, moved from any layout, with each block's amax
  reduced over the group for an int8 tier); a hit's stripes move once
  into the scratch cache of ``prefill_with_prefix``; ``verify_step``
  broadcasts rank 0's accepted tokens (a draft's proposals first, when
  they are rank 0's alone), as decode broadcasts its sampled ones;
  ``tier_op`` and ``kv_adopt`` are the leader's hooks for naming the
  tier's changes and hits to its followers (no-ops here,
  ``multihost.BroadcastingRunner``).
- **the vision path over a mesh**: a VLM prompt's image rows are rank
  0's (its server runs the tower); ``prefill_with_embeds`` uploads only
  the rows under the mask and broadcasts them to every rank on the
  device, and each rank splices those that fall in the tokens it runs.

PyTorch runs eagerly, so there are no per-shape compilations to cache:
the buckets bound the set of prefill shapes the kernel sees.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from gpustack_tpu_torch.engine.sampling import SamplingState, sample
from gpustack_tpu_torch.engine.weights import params_to_device
from gpustack_tpu_torch.models.config import ModelConfig
from gpustack_tpu_torch.models.transformer import (
    KVCache,
    forward,
    lm_head,
)
from gpustack_tpu_torch.parallel.mesh import Mesh, MeshPlan
from gpustack_tpu_torch.parallel.sharding import SpecLayout


@dataclasses.dataclass(frozen=True)
class KVLayout:
    """Where the positions of a sequence-sharded K/V lie over the ``sp``
    ranks, from host integers alone: ``width`` (the global width) gives
    contiguous segments of ``width / sp`` positions, segment ``i`` on the
    rank at ``sp`` index ``i`` (a bucket's blocks, the decode cache's
    segments); ``block`` gives the host tier's stripes
    (``parallel.mesh.kv_stripe``): rows ``[lo_i, hi_i)`` of each block of
    ``block`` tokens on index ``i``, block ``b``'s at the rank's rows
    from ``b·(hi_i - lo_i)``."""

    width: int = 0
    block: int = 0

    def pieces(self, n: int, sp: int):
        """``[(first position, end, sp index, first row)]`` tiling
        positions ``0 .. n-1`` in order."""
        if self.width:
            w = self.width // sp
            return [(i * w, min((i + 1) * w, n), i, 0)
                    for i in range(sp) if i * w < n]
        bt, out = self.block, []
        for b in range(-(-n // bt)):
            for i in range(sp):
                lo, hi = i * bt // sp, (i + 1) * bt // sp
                if b * bt + lo < min(b * bt + hi, n):
                    out.append((b * bt + lo, min(b * bt + hi, n), i,
                                b * (hi - lo)))
        return out


def _layout_runs(src: KVLayout, dst: KVLayout, n: int, sp: int):
    """``(position, count, src index, src row, dst index, dst row)`` for
    each run of positions ``0 .. n-1`` that is contiguous in both
    layouts, in position order."""
    a, b = src.pieces(n, sp), dst.pieces(n, sp)
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if lo < hi:
            out.append((lo, hi - lo, a[i][2], a[i][3] + lo - a[i][0],
                        b[j][2], b[j][3] + lo - b[j][0]))
        if a[i][1] == hi:
            i += 1
        if b[j][1] == hi:
            j += 1
    return out


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
        cfg: ModelConfig, batch: int, max_len: int, device, tp: int = 1,
        cache_rows: Optional[int] = None,
    ) -> "DecodeState":
        """``cache_rows``: the cache's rows where they are fewer than the
        batch's (a ``dp`` group's slots)."""
        return DecodeState(
            cache=KVCache.create(cfg, cache_rows or batch, max_len, device,
                                 tp),
            last_tokens=torch.zeros(batch, dtype=torch.int64, device=device),
            positions=torch.zeros(batch, dtype=torch.int64, device=device),
            active=torch.zeros(batch, dtype=torch.bool, device=device),
            sampling=SamplingState.create(batch, device),
        )


class ModelRunner:
    """Owns the params and the prefill/insert/decode ops for one model
    (or, with a multi-rank ``mesh``, for this rank's shard of it)."""

    # the engine may hand insert() a first token still on the device
    # (its dispatch-ahead admission); a leader's BroadcastingRunner may not
    supports_async_insert = True
    # why the replica's command channel failed ("" : it has not)
    channel_error = ""
    # the diagnostics.RoutingTape a check's "routing_record" probe put on
    # this rank (checks only; the serving path never sets it)
    routing_tape = None
    # this rank's host KV tier, which the engine attaches for the checks
    # of diagnostics.probe ("kv_tier", "kv_block")
    host_tier = None

    def __init__(
        self,
        cfg: ModelConfig,
        params: Dict[str, Any],
        device: torch.device,
        max_slots: int = 8,
        max_seq_len: int = 1024,
        prefill_buckets: Tuple[int, ...] = (),
        plan: Optional[MeshPlan] = None,
        mesh: Optional[Mesh] = None,
    ):
        self.cfg = cfg
        self.device = torch.device(device)
        self.plan = plan or (mesh.plan if mesh is not None else MeshPlan())
        if self.plan.chips > 1 and (
            mesh is None or mesh.plan != self.plan
        ):
            raise ValueError(
                f"plan {self.plan} needs this rank's mesh of that plan"
            )
        # None on one card: the forward then runs no collective
        self.mesh = mesh if self.plan.chips > 1 else None
        self.tp = self.plan.tp
        # the replica's layout as one inspectable object (/healthz)
        self.sp = self.plan.sp
        self.sp_mode = self.sp > 1
        if self.sp_mode:
            if self.plan.dp != 1:
                raise ValueError(
                    "sp>1 serving requires dp=1 (one sequence-sharded "
                    f"replica); got plan {self.plan}"
                )
            if max_seq_len % self.sp:
                raise ValueError(
                    f"plan {self.plan}: max_seq_len {max_seq_len} must "
                    f"divide evenly over sp={self.sp}"
                )
        self.dp = self.plan.dp
        if max_slots % self.dp:
            raise ValueError(
                f"plan {self.plan}: max_slots {max_slots} must divide "
                f"evenly over dp={self.dp}"
            )
        # this rank's dp group's slots: rows row0 .. row0 + rows - 1
        self.rows = max_slots // self.dp
        self.row0 = self.rows * (self.mesh.dp_rank if self.dp > 1 else 0)
        self.layout = SpecLayout(long_context=self.sp_mode)
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
        if self.sp_mode:
            prefill_buckets = tuple(
                b for b in prefill_buckets if b % self.sp == 0
            )
            if not prefill_buckets:
                raise ValueError(
                    f"plan {self.plan}: no prefill bucket divides over "
                    f"sp={self.sp}"
                )
        self.prefill_buckets = tuple(sorted(set(prefill_buckets)))
        # verify steps run, and the proposals they accepted (a device
        # count, read by diagnostics.probe only)
        self.spec_steps = 0
        self.spec_accepted = torch.zeros((), dtype=torch.int64,
                                         device=self.device)

    # -- state ------------------------------------------------------------

    def new_state(self) -> DecodeState:
        """The decode batch's state; under ``sp`` its cache holds this
        rank's ``max_seq_len / sp`` positions of every slot, under ``dp``
        its group's slots' rows."""
        return DecodeState.create(
            self.cfg, self.max_slots, self.max_seq_len // self.sp,
            self.device, self.tp, cache_rows=self.rows,
        )

    def _cache(self, rows: int) -> KVCache:
        """A scratch cache of one row, ``rows`` long (the rank's heads)."""
        return KVCache.create(self.cfg, 1, rows, self.device, self.tp)

    def _refuse_dp(self, what: str) -> None:
        """Refuse an op that needs every slot's cache rows on this rank
        (a ``dp`` group holds its own slots' rows)."""
        if self.dp > 1:
            raise ValueError(f"{what} is not supported under plan {self.plan}")

    # -- data parallelism -------------------------------------------------

    def _runs(self, slot: Optional[int]) -> bool:
        """Whether this rank's ``dp`` group runs a prefill for ``slot``
        (the owning group; every group for ``slot`` None)."""
        return self.dp == 1 or slot is None or slot // self.rows == (
            self.mesh.dp_rank)

    def _to_leader(self, last, slot: Optional[int]):
        """A prefill's first-token logits on rank 0 as well: the owning
        group's first rank sends them when another group holds rank 0.
        Returns this rank's logits (None on a rank whose group did not run
        the prefill, rank 0 apart)."""
        if self.dp == 1 or slot is None:
            return last
        if last is None and self.mesh.rank == 0:
            last = torch.empty(self.cfg.vocab_size, dtype=torch.float32,
                               device=self.device)
        if last is not None:
            self.mesh.send_to_leader_(last, slot // self.rows)
        return last

    def _gather_rows(self, out):
        """A decode step's sampled rows of every ``dp`` group (tokens,
        logprobs, top ids and logprobs) whole on every rank, in one
        gather: packed as float64, which holds int64 ids below 2^53 and
        every float32 exactly."""
        tokens, lp, top_ids, top_lps = out
        m = top_ids.shape[1]
        whole = self.mesh.gather_dp_rows(torch.cat([
            tokens[:, None].double(), lp[:, None].double(),
            top_ids.double(), top_lps.double(),
        ], 1))
        return (whole[:, 0].long(), whole[:, 1].float(),
                whole[:, 2:2 + m].long(), whole[:, 2 + m:].float())

    # -- sequence parallelism ---------------------------------------------

    def _sp_last_hidden(self, hidden, true_len: int) -> torch.Tensor:
        """The hidden row of position ``true_len - 1`` of a ring prefill,
        from the ``sp`` rank whose block holds it, on every rank."""
        T = hidden.shape[1]
        owner, row = divmod(true_len - 1, T)
        last = hidden[0, row].clone()
        return self.mesh.broadcast_sp_(last, owner)

    def _sp_move(self, src_k, src_v, src: KVLayout, dst_k, dst_v,
                 dst: KVLayout, n: int) -> None:
        """Copy positions ``0 .. n-1`` of a sequence-sharded K/V laid out
        as ``src`` (``src_k``/``src_v`` ``[L, rows, H, hd]``, this rank's
        rows) into one laid out as ``dst`` (``dst_k``/``dst_v``, this
        rank's). Each run of positions goes from the rank whose source
        rows hold it to the rank whose destination rows do: a local copy,
        or one message a pair of ranks (every run between them packed in
        position order), point to point over the ``sp`` group. The plan
        follows from the host integers alone, the same on every rank."""
        r = self.mesh.sp_rank
        sends, recvs = {}, {}
        for _, m, s_i, s_row, d_i, d_row in _layout_runs(src, dst, n,
                                                           self.sp):
            if s_i == d_i == r:
                dst_k[:, d_row:d_row + m] = src_k[:, s_row:s_row + m]
                dst_v[:, d_row:d_row + m] = src_v[:, s_row:s_row + m]
            elif s_i == r:
                sends.setdefault(d_i, []).append((s_row, m))
            elif d_i == r:
                recvs.setdefault(s_i, []).append((d_row, m))
        out = [(torch.stack([
            torch.cat([t[:, a:a + m] for a, m in runs], 1)
            for t in (src_k, src_v)]), d_i) for d_i, runs in sends.items()]
        inc = [(torch.empty(
            (2, dst_k.shape[0], sum(m for _, m in runs), *dst_k.shape[2:]),
            dtype=dst_k.dtype, device=dst_k.device), s_i)
            for s_i, runs in recvs.items()]
        for req in self.mesh.sp_p2p(out, inc):
            req.wait()
        for (buf, s_i) in inc:
            at = 0
            for d_row, m in recvs[s_i]:
                dst_k[:, d_row:d_row + m] = buf[0, :, at:at + m]
                dst_v[:, d_row:d_row + m] = buf[1, :, at:at + m]
                at += m

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
        main path must not take.) Under ``sp``: the ring, whose blocks run
        the kernel's LSE mode on the card."""
        if self.sp_mode:
            return "ring"
        return "flash" if self.device.type == "cuda" else "plain"

    def prefill(self, token_ids: Sequence[int], true_len: int,
                slot: Optional[int] = None):
        """Run prefill at the bucket for ``true_len``. ``token_ids`` must be
        padded to the bucket length already (any pad id). Returns
        ``(last_logits [V] fp32, k, v [L, Tb, H, hd])``. Under ``dp`` a
        ``slot`` makes it the owning group's alone: another group's ranks
        return ``(None, None, None)``, rank 0 the logits."""
        if not self._runs(slot):
            return self._to_leader(None, slot), None, None
        Tb = len(token_ids)
        if Tb not in self.prefill_buckets:
            raise ValueError(f"{Tb} is not a bucket {self.prefill_buckets}")
        if not 0 < true_len <= Tb:
            raise ValueError(f"true_len {true_len} outside 1..{Tb}")
        if self.sp_mode:
            return self._sp_prefill(token_ids, true_len)
        tokens = torch.tensor(
            [list(token_ids)], dtype=torch.int64, device=self.device
        )
        positions = torch.arange(Tb, device=self.device)[None, :]
        cache = self._cache(Tb)
        hidden, cache = forward(
            self.params, self.cfg, tokens, positions, cache,
            return_hidden=True, attn_impl=self.attn_impl_for(Tb),
            mesh=self.mesh,
        )
        # logits for the one position the sampler reads, not all Tb rows
        last = self._head(hidden[0, true_len - 1])
        return self._to_leader(last, slot), cache.k[:, 0], cache.v[:, 0]

    def _sp_prefill(self, token_ids: Sequence[int], true_len: int,
                    image=None):
        """:meth:`prefill` under ``sp``: this rank's ``Tb / sp`` tokens
        through the ring (``image``: the prompt's image rows and mask,
        :meth:`_image_rows`, spliced where they fall in those tokens).
        Returns ``(last_logits [V] fp32, k, v [L, Tb / sp, H, hd])``, the
        K/V of this rank's block of positions."""
        T = len(token_ids) // self.sp
        start = self.mesh.sp_rank * T
        tokens = torch.tensor(
            [list(token_ids[start:start + T])], dtype=torch.int64,
            device=self.device,
        )
        positions = start + torch.arange(T, device=self.device)[None, :]
        hidden, cache = forward(
            self.params, self.cfg, tokens, positions, self._cache(T),
            return_hidden=True, attn_impl="ring", mesh=self.mesh,
            embeds_override=(None if image is None
                             else self._splice(*image, start, T)),
        )
        last = self._head(self._sp_last_hidden(hidden, true_len))
        return last, cache.k[:, 0], cache.v[:, 0]

    def _head(self, hidden: torch.Tensor) -> torch.Tensor:
        return lm_head(self.params, self.cfg, hidden, self.mesh)

    def prefill_with_embeds(
        self, token_ids: Sequence[int], true_len: int, embeds, mask,
        slot: Optional[int] = None,
    ):
        """Like :meth:`prefill`, with per-token embedding overrides (a VLM
        prompt, ``models/vlm.py``): ``embeds`` fp32, bucket-padded ``[Tb,
        D]`` or the prompt's own ``[true_len, D]`` (padding them would
        copy ``[Tb, D]`` on the host for rows never read), and ``mask``
        ``[Tb]`` bool, bucket-padded (numpy or host tensors). Only the
        rows under the mask go to the card, through pinned
        memory without blocking, as :meth:`_ids_on_device` sends ids, and
        are spliced there. One fused forward with a fresh cache, through
        the flash kernel on the card at every bucket. Returns
        ``(last_logits [V] fp32, k, v [L, Tb, H, hd])``.

        Over a mesh ``embeds`` is rank 0's alone (None on every other
        rank, which gets the ``mask`` from the leader's op): its rows
        reach every rank in one world broadcast on the device
        (:meth:`_image_rows`), and the prefill then runs as
        :meth:`prefill` does on the plan. Under ``tp`` and ``ep`` every
        rank splices every row after the vocab-split lookup's
        all-reduce; under ``dp`` the ``slot``'s group alone runs it
        (another group's ranks drop the rows), its logits sent to rank 0;
        under ``sp`` each rank splices the rows that fall in its block of
        the ring."""
        Tb = len(token_ids)
        if Tb not in self.prefill_buckets:
            raise ValueError(f"{Tb} is not a bucket {self.prefill_buckets}")
        if not 0 < true_len <= Tb:
            raise ValueError(f"true_len {true_len} outside 1..{Tb}")
        image = self._image_rows(embeds, mask, Tb, true_len)
        if not self._runs(slot):
            return self._to_leader(None, slot), None, None
        if self.sp_mode:
            return self._sp_prefill(token_ids, true_len, image)
        tokens = self._ids_on_device([list(token_ids)])
        positions = torch.arange(Tb, device=self.device)[None, :]
        cache = self._cache(Tb)
        hidden, cache = forward(
            self.params, self.cfg, tokens, positions, cache,
            return_hidden=True, attn_impl=self.attn_impl_for(Tb),
            embeds_override=self._splice(*image, 0, Tb), mesh=self.mesh,
        )
        last = self._head(hidden[0, true_len - 1])
        return self._to_leader(last, slot), cache.k[:, 0], cache.v[:, 0]

    def _image_rows(self, embeds, mask, Tb: int, true_len: int):
        """``(rows [n, D] fp32 on the device, mask [Tb] bool on the
        host)``: the rows of ``embeds`` (``[Tb, D]`` or ``[true_len,
        D]``) under ``mask``, uploaded by the
        rank that holds them (rank 0, or this one process) and, over a
        mesh, broadcast from rank 0 to every rank on the device. Every
        rank knows ``n`` from the mask, so a rank without ``embeds``
        receives into a buffer of its own."""
        mask = torch.as_tensor(mask, dtype=torch.bool)
        D = self.cfg.hidden_size
        if self.mesh is None or self.mesh.rank == 0:
            embeds = torch.as_tensor(embeds, dtype=torch.float32)
            n = embeds.shape[0] if embeds.ndim else -1
            if (embeds.shape not in ((Tb, D), (true_len, D))
                    or mask.shape != (Tb,) or mask[n:].any()):
                raise ValueError(
                    f"embeds {tuple(embeds.shape)} / mask "
                    f"{tuple(mask.shape)} do not match bucket {Tb} (or "
                    f"true_len {true_len}) x {D}"
                )
            rows = embeds[mask[:n]]
            if self.device.type == "cuda":
                rows = rows.pin_memory().to(self.device, non_blocking=True)
        else:
            if mask.shape != (Tb,):
                raise ValueError(f"mask {tuple(mask.shape)} does not match "
                                 f"bucket {Tb}")
            rows = torch.empty((int(mask.sum()), D), dtype=torch.float32,
                               device=self.device)
        if self.mesh is not None and rows.shape[0]:
            self.mesh.broadcast_(rows)
        return rows, mask

    def _splice(self, rows, mask, start: int, T: int):
        """``forward``'s ``embeds_override`` for positions ``start ..
        start + T - 1`` of a prompt whose image rows (in position order)
        and mask :meth:`_image_rows` gave: ``(embeds [1, T, D], mask [1,
        T])`` on the device, the rows that fall in the span at their
        positions and zeros elsewhere. The positions and the span's rows
        follow from the host mask, so nothing is read back."""
        local = mask[start:start + T]
        first = int(mask[:start].sum())
        at = torch.nonzero(local).flatten()
        ov = torch.zeros((T, rows.shape[1]), dtype=torch.float32,
                         device=self.device)
        ov.index_copy_(0, self._ids_on_device(at),
                       rows[first:first + at.numel()])
        if self.device.type == "cuda":
            local = local.pin_memory().to(self.device, non_blocking=True)
        return ov[None], local[None]

    def prefill_with_prefix(
        self, prefix_k, prefix_v, prefix_len: int,
        suffix_ids: Sequence[int], suffix_true_len: int, total_bucket: int,
        slot: Optional[int] = None, prefix_block: int = 0,
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
        here instead of writing past the cache.

        Under ``sp`` the prefix is sequence-sharded (``[L, Pb / sp, H,
        hd]``, this rank's block: a chunk's output) and so are the
        returned K/V (``total_bucket / sp`` rows); the suffix runs whole on
        every rank against the sharded scratch cache (JAX's
        ``sp_cache_attention`` branch), no flash launch. ``prefix_block``
        > 0 under ``sp``: the prefix is instead the host tier's stripes of
        blocks of that many tokens (a hit's upload), moved once into the
        scratch cache. Under ``dp``, ``slot`` as for :meth:`prefill`."""
        if not self._runs(slot):
            return self._to_leader(None, slot), None, None
        striped = self.sp_mode and prefix_block > 0
        Pb = prefix_len if striped else prefix_k.shape[1] * self.sp
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
        cache = self._cache(total_bucket // self.sp)
        if self.sp_mode:
            self._sp_move(
                prefix_k, prefix_v,
                KVLayout(block=prefix_block) if striped else KVLayout(Pb),
                cache.k[:, 0], cache.v[:, 0], KVLayout(total_bucket),
                prefix_len)
        else:
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
            return_hidden=True,
            attn_impl=(
                "sp_cache" if self.sp_mode
                else self.attn_impl_for(total_bucket)
            ),
            q_offset=prefix_len, mesh=self.mesh,
        )
        last = self._head(hidden[0, suffix_true_len - 1])
        return self._to_leader(last, slot), cache.k[:, 0], cache.v[:, 0]

    # a chunked prefill (engine._advance_chunk) is a prefill, then
    # continuations; a leader's BroadcastingRunner names each step to its
    # followers, which keep the chunk's K/V apart from one-shot prefills
    def prefill_chunk(self, token_ids: Sequence[int], true_len: int,
                      slot: Optional[int] = None):
        return self.prefill(token_ids, true_len, slot)

    def prefill_continue_chunk(
        self, k, v, start: int, token_ids: Sequence[int], true_len: int,
        total_bucket: int, slot: Optional[int] = None, prefix_block: int = 0,
    ):
        return self.prefill_with_prefix(
            k, v, start, token_ids, true_len, total_bucket, slot,
            prefix_block,
        )

    def chunk_commit(self, slot: Optional[int] = None) -> None:
        """The chunk job completed (nothing to do on one process)."""

    def chunk_abort(self, slot: Optional[int] = None) -> None:
        """The chunk job was abandoned (nothing to do on one process)."""

    # -- the host KV tier over a mesh ---------------------------------------

    def kv_store(self, k, v, slot: Optional[int], total: int, store=None):
        """The K/V rows ``0 .. total - 1`` a host-tier store copies, on
        this rank, as ``(k, v, amax)``: as given (``amax`` None); under
        ``dp`` (``slot`` names the group that holds them) sent from the
        owning group's ranks to every other group's rank at the same
        heads, one broadcast over the ``dp`` group, so every rank's tier
        keeps every block and a hit serves a slot of any group (``k``/
        ``v`` are None on a rank of another group). Under ``sp`` this
        rank's stripes of the full blocks of ``total``
        (:class:`KVLayout`, ``block_rows`` rows a block), moved from a
        prefill's bucket layout, or from the decode cache's segments for
        ``store["src"] == "slot"`` (:meth:`slot_kv`); for an int8 tier
        also each block's amax over its whole tokens, per layer and head
        (fp32 ``[2, L, blocks, H]``, one all-reduce MAX over the group,
        exact), which :meth:`HostKVCache.insert_sequence` quantises
        with. ``store`` names the store to a leader's followers
        (``multihost.BroadcastingRunner``)."""
        if self.sp_mode:
            return self._sp_kv_store(k, v, total, (store or {}).get("src"))
        if self.dp == 1:
            return k, v, None
        if k is not None:
            kv = torch.stack([k[:, :total], v[:, :total]])
        else:
            like = self._cache(1).k
            L, _, _, H, hd = like.shape
            kv = torch.empty((2, L, total, H, hd), dtype=like.dtype,
                             device=self.device)
        self.mesh.broadcast_dp_(kv, slot // self.rows)
        return kv[0], kv[1], None

    def _sp_kv_store(self, k, v, total: int, src: Optional[str]):
        tier = self.host_tier
        bt = tier.block_tokens
        blocks = total // bt
        lo, hi = tier.stripe
        L, _, H, hd = k.shape
        out_k, out_v = (torch.empty((L, blocks * (hi - lo), H, hd),
                                    dtype=k.dtype, device=self.device)
                        for _ in range(2))
        width = (self.max_seq_len if src == "slot"
                 else k.shape[1] * self.sp)
        self._sp_move(k, v, KVLayout(width), out_k, out_v,
                      KVLayout(block=bt), blocks * bt)
        if not tier.int8 or not blocks:
            return out_k, out_v, None
        amax = torch.zeros((2, L, blocks, H), dtype=torch.float32,
                           device=self.device)
        if hi > lo:
            for i, t in enumerate((out_k, out_v)):
                amax[i] = t.view(L, blocks, hi - lo, H, hd).abs().amax(
                    dim=(2, 4)).float()
        return out_k, out_v, self.mesh.all_reduce_sp(amax, op="max")

    def tier_op(self, cache, fn, make_op):
        """Run a change of the host tier (``fn()``); a leader names it to
        its followers (``multihost.BroadcastingRunner``)."""
        return fn()

    def kv_adopt(self, gather_id: int, slot: Optional[int]) -> None:
        """A hit's gathered prefix is about to seed ``slot``'s prefill
        (nothing to do on one process)."""

    # -- embeddings -------------------------------------------------------

    def embed(self, batch_token_ids, true_lens) -> torch.Tensor:
        """Mean-pooled, l2-normalised fp32 hidden states ``[N, D]`` from
        one batched cacheless forward. ``batch_token_ids`` is ``[N][Tb]``,
        every row pre-padded to one bucket ``Tb``; the batch is padded to
        a power of two with empty rows (true length 0, pooled to zero) so
        the kernel sees a bounded set of shapes. On the card the attention
        is the flash kernel (``attn_impl_for``), as for every prefill.
        Under ``dp`` the first group runs the batch (rank 0's: the vectors
        are where the leader reads them), another group's slots untouched.
        Under ``sp`` the batch is a ring prefill (:meth:`_sp_embed`). None
        on every rank but 0."""
        if not self._runs(0):
            return None
        Tb = len(batch_token_ids[0])
        if Tb not in self.prefill_buckets:
            raise ValueError(f"{Tb} is not a bucket {self.prefill_buckets}")
        N = len(batch_token_ids)
        Nb = 1
        while Nb < N:
            Nb *= 2
        padded = [list(r) for r in batch_token_ids] + [[0] * Tb] * (Nb - N)
        lens = list(true_lens) + [0] * (Nb - N)
        if self.sp_mode:
            return self._sp_embed(padded, lens, N)
        tokens = self._ids_on_device(padded)
        positions = torch.arange(Tb, device=self.device)[None, :].expand(
            Nb, Tb
        )
        hidden, _ = forward(
            self.params, self.cfg, tokens, positions, return_hidden=True,
            attn_impl=self.attn_impl_for(Tb), mesh=self.mesh,
        )
        if self.mesh is not None and self.mesh.rank:
            return None              # rank 0 pools, as on one card
        lens_t = self._ids_on_device(lens)
        mask = (positions < lens_t[:, None])[..., None].float()
        pooled = (hidden * mask).sum(dim=1) / mask.sum(dim=1).clamp_min(1.0)
        norm = pooled.norm(dim=-1, keepdim=True)
        return (pooled / norm.clamp_min(1e-9))[:N]

    def _sp_embed(self, padded, lens, N: int):
        """:meth:`embed` under ``sp`` (JAX's GSPMD embedding): each rank
        takes its ``Tb / sp`` positions of every row through the ring, in
        a scratch cache of that many rows, and sums its rows under each
        row's length; the sums and counts are added over the group in one
        all-reduce, and rank 0 normalises."""
        Nb, T = len(padded), len(padded[0]) // self.sp
        start = self.mesh.sp_rank * T
        tokens = self._ids_on_device([r[start:start + T] for r in padded])
        positions = (start + torch.arange(T, device=self.device))[
            None, :].expand(Nb, T)
        hidden, _ = forward(
            self.params, self.cfg, tokens, positions,
            KVCache.create(self.cfg, Nb, T, self.device, self.tp),
            return_hidden=True, attn_impl="ring", mesh=self.mesh,
        )
        lens_t = self._ids_on_device(lens)
        mask = (positions < lens_t[:, None])[..., None].float()
        part = self.mesh.all_reduce_sp(torch.cat(
            [(hidden * mask).sum(dim=1), mask.sum(dim=1)], dim=1))
        if self.mesh.rank:
            return None
        pooled = part[:, :-1] / part[:, -1:].clamp_min(1.0)
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
        or a one-element device tensor. Under ``sp``, ``k``/``v`` are this
        rank's block of the prefill's positions, and positions ``0 ..
        true_len-1`` move to the ranks whose cache segments own them
        (:meth:`_sp_move`). Under ``dp`` only the owning group's ranks
        write K/V (into their row ``slot - row0``); every rank sets the
        slot's vectors."""
        if self._runs(slot):
            Tb = k.shape[1] * self.sp
            if Tb > self.max_seq_len:
                raise ValueError(f"prefill width {Tb} > max_seq_len")
            row = slot - self.row0
            if self.sp_mode:
                self._sp_move(k, v, KVLayout(Tb), state.cache.k[:, row],
                              state.cache.v[:, row],
                              KVLayout(self.max_seq_len), int(true_len))
            else:
                state.cache.k[:, row, :Tb] = k
                state.cache.v[:, row, :Tb] = v
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
        """Copies of a slot's KV rows ``[:width]`` (this rank's heads);
        under ``sp`` this rank's part of them (its segment's rows below
        ``width``: ``kv_store`` takes them as the decode cache's
        layout); under ``dp`` ``(None, None)`` on a rank whose group does
        not hold the slot."""
        if not self._runs(slot):
            return None, None
        row = slot - self.row0
        if self.sp_mode:
            seg = self.max_seq_len // self.sp
            width = max(0, min(seg, width - self.mesh.sp_rank * seg))
        return (
            state.cache.k[:, row, :width].clone(),
            state.cache.v[:, row, :width].clone(),
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
        as fresh device tensors the caller may hold across later steps.
        Under ``dp`` the forward and the sampler take this group's rows
        and the outputs are gathered whole."""
        rows = slice(self.row0, self.row0 + self.rows)
        logits, _ = forward(
            self.params, self.cfg, state.last_tokens[rows, None],
            state.positions[rows, None], state.cache,
            attn_impl="sp_cache" if self.sp_mode else "plain",
            mesh=self.mesh,
        )
        sampling = (state.sampling if self.dp == 1
                    else state.sampling.rows(self.row0, self.rows))
        out = sample(logits[:, 0], sampling, key, state.positions[rows],
                     row0=self.row0)
        if self.dp > 1:
            # every group's rows on every rank, on the device
            out = self._gather_rows(out)
        elif self.mesh is not None:
            # rank 0's tokens on every rank, on the device
            self.mesh.broadcast_(out[0])
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
        discarded, so this one stops at the hidden states. Under ``sp``
        the block runs whole on every rank against the sharded cache, as
        a verify block does; refused under ``dp``."""
        self._refuse_dp("draft ingestion")
        tokens = self._ids_on_device(tokens)
        counts = self._ids_on_device(counts)
        P = tokens.shape[1]
        fed = torch.cat([state.last_tokens[:, None], tokens[:, : P - 1]], 1)
        forward(
            self.params, self.cfg, fed, self._block_positions(state, P),
            state.cache, return_hidden=True, clamp_writes=True,
            attn_impl="sp_cache" if self.sp_mode else "plain",
            mesh=self.mesh,
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

    def verify_step(self, state: DecodeState, proposals,
                    shared: bool = False):
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
        the cache, as the JAX write is.

        Over a mesh: ``shared`` proposals are rank 0's alone (a draft's,
        on rank 0's card): every rank takes them in one broadcast on the
        device. The accepted tokens and counts are rank 0's, broadcast on
        the device (under ``dp`` each group's rows, from its first rank,
        gathered), so no rank's acceptance parts from the leader's at a
        near-tie. Under ``dp`` the forward runs the group's rows; under
        ``sp`` the block runs whole on every rank against the sharded
        cache, each position written by the rank that owns it (a block
        may cross a segment's end) before the attention merges."""
        proposals = self._ids_on_device(proposals)
        if shared and self.mesh is not None:
            self.mesh.broadcast_(proposals)
        P = proposals.shape[1]
        rows = slice(self.row0, self.row0 + self.rows)
        mine = proposals[rows]
        fed = torch.cat(
            [state.last_tokens[rows, None], mine[:, : P - 1]], 1
        )
        logits, _ = forward(
            self.params, self.cfg, fed,
            self._block_positions(state, P)[rows], state.cache,
            clamp_writes=True,
            attn_impl="sp_cache" if self.sp_mode else "plain",
            mesh=self.mesh,
        )
        greedy = logits.argmax(dim=-1)                          # [B, P]
        match = (mine[:, : P - 1] == greedy[:, : P - 1]).long()
        n_accept = match.cumprod(dim=1).sum(dim=1)              # 0..P-1
        produced = torch.where(state.active[rows], n_accept + 1, 0)
        if self.mesh is not None:
            whole = self.mesh.gather_dp_rows(
                torch.cat([greedy, produced[:, None]], 1))
            greedy, produced = whole[:, :P], whole[:, P]
            n_accept = (produced - 1).clamp_min(0)
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
        self.spec_steps += 1
        self.spec_accepted += (produced - 1).clamp_min(0).sum()
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
