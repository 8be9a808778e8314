"""Host-RAM KV cache: block-granular radix prefix reuse.

The port's copy of ``gpustack_tpu/engine/kv_host_cache.py``. A prompt
sharing a prefix with a previously served sequence (system prompts, agent
loops, multi-turn chat) re-uploads the cached K/V for the shared run and
prefills only its suffix.

KV is split into fixed-size token **blocks** (default 256,
``kv_block_tokens``) deduplicated across requests in a radix trie keyed on
rolling block hashes — ``child_key = sha256(parent_key ||
block_token_bytes)`` — so a lookup is O(prompt_len / block) hash-map
probes. Eviction is leaf-only: an interior block is referenced by its
children (``refs``), so a hot shared system-prompt block survives while
cold per-conversation suffixes evict. Sequences are inserted at request
finish (prompt + generated tokens), which is what makes turn N+1 of a
conversation hit the blocks turn N decoded.

Arrays are numpy on the host; bf16 K/V are ``uint16`` bit patterns
(``host_bf16``). The opt-in ``int8`` tier quantizes each block with a
per-block scale (amax per layer × head within the block) computed on
float32 widened exactly from the stored values, and dequantizes back to
the stored dtype with round-to-nearest-even — bit for bit what the JAX
cache stores and returns for the same K/V.

On a multi-GPU replica each rank keeps a cache of its own (its KV heads
of every block) and rank 0's is the authority: ``lead()`` makes a cache
journal every change it makes (a block attached, evicted, spilled, a
spill file dropped) so the leader can name them to its followers, and
``follow()`` makes a cache that never evicts or spills on its own: it
applies a leader's journal (``replay``) and gathers by the leader's word
(``follower_gather``). The scales being per layer × head, a rank's int8
block is bit for bit the slice at its heads of the block one process
would store. Under ``sp`` a rank keeps its ``stripe`` of each block's
tokens as well (``parallel.mesh.kv_stripe``: rows ``[lo, hi)`` of every
block, so a rank's K/V of a sequence are its stripes one block after
another): its int8 scales are the whole block's, from the amax the
``sp`` ranks reduced on the card (``amax`` of :meth:`insert_sequence`
and :meth:`replay`), so its ``q`` is bit for bit the stripe of the block
one process would store. A handoff moves whole blocks: an export reads
each rank's part of the named blocks (``export_blocks`` or
``export_chain`` on the leader, ``named_blocks`` on a follower) and the
leader joins them; an import keeps each rank's part (``import_blocks``
of its parts on the leader, journalled; ``replay`` with the scattered
``prepared`` blocks on a follower).
"""

from __future__ import annotations

import hashlib
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from gpustack_tpu_torch.engine.host_bf16 import (
    bf16_bits_to_f32,
    f32_to_bf16_bits,
    is_bf16,
)

DEFAULT_BLOCK_TOKENS = 256


def _quantize_block(x: np.ndarray, amax: Optional[np.ndarray] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-block int8: scale = amax over (tokens, head_dim) per
    layer × head, so one outlier token degrades only its own block.
    ``amax`` (fp32 ``[L, 1, H, 1]``): the whole block's, where ``x`` is
    one ``sp`` stripe of it (the max is exact, so the scale is the one
    the whole block gives)."""
    x32 = bf16_bits_to_f32(x) if is_bf16(x.dtype) else np.asarray(
        x, np.float32
    )
    if amax is None:
        amax = np.max(np.abs(x32), axis=(1, 3), keepdims=True)
    scale = amax / 127.0
    scale = np.maximum(scale, 1e-8).astype(np.float32)
    q = np.clip(np.rint(x32 / scale), -127, 127).astype(np.int8)
    return q, scale


def _dequantize_block(q: np.ndarray, scale: np.ndarray, dtype) -> np.ndarray:
    x32 = q.astype(np.float32) * scale
    return f32_to_bf16_bits(x32) if is_bf16(dtype) else x32.astype(dtype)


class _Block:
    """One cached KV block: ``block_tokens`` tokens of one sequence.
    ``refs`` counts child blocks whose prefix this block is — a block with
    live children never evicts."""

    __slots__ = (
        "key", "tokens", "parent", "children", "refs",
        "k", "v", "k_scale", "v_scale", "dtype",
        "nbytes", "last_used", "touches", "sharing",
    )

    def __init__(self, key: bytes, tokens: Tuple[int, ...], parent):
        self.key = key
        self.tokens = tokens
        self.parent = parent
        self.children: Dict[bytes, "_Block"] = {}
        self.refs = 0
        self.k = self.v = None
        self.k_scale = self.v_scale = None
        self.dtype = None
        self.nbytes = 0
        self.last_used = 0
        self.touches = 0     # local reuse count (walk touches)
        self.sharing = 0     # replicas holding it (the KV directory's count)


# concurrency contract: the trie and its accounting are shared between the
# engine scheduler (match path) and the kv-copy executor (store/evict) —
# always under `_lock`; quantize/assemble/file I/O stay outside it (blocks
# are immutable once attached).
GUARDED_BY = {
    "_root": "_lock",
    "_blocks": "_lock",
    "_bytes": "_lock",
    "_tick": "_lock",
    "hits": "_lock",
    "misses": "_lock",
    "faultbacks": "_lock",
    "blocks_inserted": "_lock",
    "blocks_evicted": "_lock",
    # a leader's journal: appended under the caller's own serialization
    # (every mutating call of a leader's cache runs under the replica's
    # tier lock, ``BroadcastingRunner.tier_op``), taken there
    "journal": "BroadcastingRunner._tier_mu",
}

# sync-in-dispatch: the scheduler calls the match path every admit — trie
# probes and in-memory spill-index lookups only, no file I/O (fault-back
# and assembly run on the kv-copy executor via gather_prefix).
DISPATCH_SYNC_FREE = (
    "match_prefix_len", "peek_prefix_len", "_walk", "_disk_extension",
)


class HostKVCache:
    """Byte-bounded block-granular radix prefix cache in host RAM.

    Thread contract: ``match_prefix_len`` runs on the engine scheduler
    thread, ``insert_sequence``/``gather_prefix`` on the kv-copy executor.
    The lock guards only the trie walk and accounting."""

    def __init__(
        self,
        max_bytes: int,
        block_tokens: int = DEFAULT_BLOCK_TOKENS,
        int8: bool = False,
    ):
        if block_tokens <= 0:
            raise ValueError(f"block_tokens must be > 0: {block_tokens}")
        self.max_bytes = max_bytes
        self.block_tokens = int(block_tokens)
        self.int8 = bool(int8)
        self._root = _Block(b"", (), None)
        self._blocks: Dict[bytes, _Block] = {}
        self._bytes = 0
        self._tick = 0
        self._lock = threading.Lock()
        # optional disk spill tier (kv_spill.DiskKVSpill): eviction
        # victims spill instead of dropping; matches extend into disk
        # residency and fault back on gather
        self.spill = None
        self.hits = 0            # match_prefix_len calls matching >= 1 block
        self.misses = 0          # match_prefix_len calls matching nothing
        self.prefix_hits = 0     # matches the engine actually consumed
        self.prefix_tokens_reused = 0   # tokens the engine skipped prefilling
        self.blocks_inserted = 0
        self.blocks_evicted = 0
        self.faultbacks = 0      # disk blocks pulled back into RAM runs
        # multi-GPU roles (None/False on one process): a leader's journal
        # of changes, or a follower's "apply the leader's word only"
        self.journal: Optional[List[Tuple[str, Any]]] = None
        self.follower = False
        # under sp: the rows [lo, hi) of each block this rank keeps
        # (parallel.mesh.kv_stripe); None keeps every row
        self.stripe: Optional[Tuple[int, int]] = None

    @property
    def block_rows(self) -> int:
        """The K/V rows a block holds here (its stripe under ``sp``)."""
        if self.stripe is None:
            return self.block_tokens
        return self.stripe[1] - self.stripe[0]

    # ---- multi-GPU roles ------------------------------------------------

    def lead(self) -> None:
        """Journal every change from here on (rank 0 of a replica): a
        block attached (its index in the call's tokens), evicted, spilled;
        a spill file dropped. :meth:`take_journal` hands them over."""
        self.journal = []
        if self.spill is not None:
            self.spill.journal = self.journal

    def follow(self) -> None:
        """Never evict or spill on this cache's own account (a follower
        rank): it changes only as a leader's journal says."""
        self.follower = True
        if self.spill is not None:
            self.spill.follower = True

    def take_journal(self) -> List[Tuple[str, Any]]:
        """The changes since the last call, oldest first."""
        if self.journal is None:
            return []
        out = list(self.journal)
        self.journal.clear()
        return out

    def _note(self, kind: str, what) -> None:
        if self.journal is not None:
            self.journal.append((kind, what))

    def chain_keys(self, tokens) -> List[bytes]:
        """The chain key of each full block of ``tokens``."""
        bt = self.block_tokens
        keys, key = [], b""
        for b in range(len(tokens) // bt):
            key = self._child_key(key, tuple(tokens[b * bt:(b + 1) * bt]))
            keys.append(key)
        return keys

    def replay(self, events, token_ids, k=None, v=None,
               prepared=None, amax=None) -> List[str]:
        """Apply a leader's journal (a follower's cache): ``("attach",
        b)`` attaches block ``b`` of ``token_ids`` from ``k``/``v`` (this
        rank's K/V of the sequence, ``[L, T, H, hd]``, under ``sp`` its
        stripes, with ``amax`` as :meth:`insert_sequence` takes it: a
        store), from
        ``prepared[b]`` (this rank's heads of an imported block, in the
        tier's form) or, with neither, from this rank's spill tier (a
        restore); consecutive attaches are one attach call, as the leader
        made them.
        ``("evict", key)`` detaches a block, ``("spill", key)`` writes an
        evicted one to the spill tier, ``("unspill", key)`` drops a spill
        file. Returns the chain keys (hex) this rank could not apply: a
        block it lacks (the leader's next hit on it ends the replica,
        naming the key and the rank)."""
        tokens = tuple(int(t) for t in token_ids)
        lost: List[str] = []
        evicted: Dict[str, _Block] = {}
        i = 0
        while i < len(events):
            kind, what = events[i]
            if kind == "attach":
                run = []
                while i < len(events) and events[i][0] == "attach":
                    run.append(int(events[i][1]))
                    i += 1
                lost += self._replay_attach(tokens, run, k, v, prepared,
                                            amax)
                continue
            i += 1
            if kind == "evict":
                blk = self._detach(bytes.fromhex(what))
                if blk is None:
                    lost.append(what)
                else:
                    evicted[what] = blk
            elif kind == "spill":
                blk = evicted.get(what)
                if blk is None or self.spill is None:
                    lost.append(what)
                    continue
                from gpustack_tpu_torch.engine.kv_spill import (
                    encode_spill_frame,
                )

                if not self.spill.store(what, encode_spill_frame(blk)[1]):
                    lost.append(what)
            elif kind == "unspill":
                if self.spill is not None:
                    self.spill.remove(what)
            else:
                raise ValueError(f"unknown journal event {kind!r}")
        return lost

    def _replay_attach(self, tokens, run: List[int], k, v,
                       given=None, amax=None) -> List[str]:
        bt = self.block_tokens
        keys = self.chain_keys(tokens[: (max(run) + 1) * bt])
        prepared: Dict[int, Tuple] = {}
        lost: List[str] = []
        for b in run:
            if k is not None:
                prepared[b] = self._prepare(k, v, b, amax)
                continue
            if given is not None:
                if b in given:
                    prepared[b] = given[b]
                else:
                    lost.append(keys[b].hex())
                continue
            from gpustack_tpu_torch.engine.kv_transfer import _to_cache_tier

            key_hex = keys[b].hex()
            frame = self.spill.load(key_hex) if self.spill else None
            if frame is None or tuple(frame.tokens) != tokens[
                b * bt:(b + 1) * bt
            ]:
                lost.append(key_hex)
                break
            prepared[b] = _to_cache_tier(self, frame)
        if prepared:
            with self._lock:
                self._attach_prepared_locked(
                    tokens[: (max(prepared) + 1) * bt], max(prepared) + 1,
                    prepared,
                )
            if k is None and given is None:
                with self._lock:
                    self.faultbacks += len(prepared)
        return lost

    def _detach(self, key: bytes) -> Optional[_Block]:
        """Remove one leaf block (a leader's eviction)."""
        with self._lock:
            blk = self._blocks.get(key)
            if blk is None or blk.refs:
                return None
            del blk.parent.children[key]
            blk.parent.refs -= 1
            del self._blocks[key]
            self._bytes -= blk.nbytes
            self.blocks_evicted += 1
        return blk

    def follower_gather(self, prompt_ids, length: int):
        """A follower's side of a leader's hit: exactly ``length`` tokens
        of ``prompt_ids``' blocks as this rank holds them, ``(k, v)``, or
        the chain key (hex) of the first block it lacks. It never faults
        back on its own: the leader's journal has restored what the
        leader restored."""
        bt = self.block_tokens
        tokens = tuple(int(t) for t in prompt_ids[:length])
        keys = self.chain_keys(tokens)
        run = self._walk(tokens, length // bt, touch=True)
        if len(run) * bt < length:
            return keys[len(run)].hex()
        k = np.concatenate([self._block_k(b) for b in run], axis=1)
        v = np.concatenate([self._block_v(b) for b in run], axis=1)
        return k, v

    def block(self, key: bytes) -> Optional[_Block]:
        """The RAM-resident block under ``key`` (checks only)."""
        with self._lock:
            return self._blocks.get(key)

    def keys(self) -> List[str]:
        """Every RAM-resident chain key (hex), sorted (checks only)."""
        with self._lock:
            return sorted(k.hex() for k in self._blocks)

    def _child_key(self, parent_key: bytes, tokens) -> bytes:
        h = hashlib.sha256()
        h.update(parent_key)
        h.update(np.asarray(tokens, np.int32).tobytes())
        return h.digest()

    # ---- lookup ---------------------------------------------------------

    def _walk(self, prompt, max_blocks: int, touch: bool) -> List[_Block]:
        """Locked trie walk: the longest cached block run prefixing
        ``prompt``, at most ``max_blocks`` long. Each probe hashes one
        block and verifies the stored tokens (collision guard)."""
        bt = self.block_tokens
        run: List[_Block] = []
        with self._lock:
            node = self._root
            for b in range(max_blocks):
                block = prompt[b * bt : (b + 1) * bt]
                child = node.children.get(self._child_key(node.key, block))
                if child is None or child.tokens != block:
                    break
                run.append(child)
                node = child
            if touch and run:
                self._tick += 1
                for blk in run:
                    blk.last_used = self._tick
                    blk.touches += 1
        return run

    def _disk_extension(
        self, prompt, parent_key: bytes, start_b: int, max_blocks: int
    ) -> List[str]:
        """Hex chain keys of the contiguous DISK-resident continuation of
        a RAM run ending at ``parent_key`` (in-memory index lookups on the
        spill tier, never file I/O), bounded by what the RAM budget can
        hold after fault-back."""
        keys: List[str] = []
        spill = self.spill
        if spill is None:
            return keys
        bt = self.block_tokens
        key = parent_key
        budget = self.max_bytes - start_b * self._avg_block_bytes()
        for b in range(start_b, max_blocks):
            key = self._child_key(key, prompt[b * bt : (b + 1) * bt])
            key_hex = key.hex()
            size = spill.size(key_hex)
            if size <= 0 or size > budget:
                break
            budget -= size
            keys.append(key_hex)
        return keys

    def _avg_block_bytes(self) -> int:
        with self._lock:
            n = len(self._blocks)
            return (self._bytes // n) if n else 0

    def match_prefix_len(self, prompt_ids) -> int:
        """Length of the longest cached block run that is a proper prefix
        of ``prompt_ids`` — a multiple of ``block_tokens``, strictly less
        than ``len(prompt_ids)`` (at least one suffix token remains to
        prefill, which regenerates the last-position logits). Counts one
        hit or miss per call and touches the matched path's recency; no KV
        bytes move — callers trim the length against their bounds guards
        and then assemble only what they use via :meth:`gather_prefix`."""
        prompt = tuple(int(t) for t in prompt_ids)
        max_blocks = (len(prompt) - 1) // self.block_tokens
        run = self._walk(prompt, max_blocks, touch=True) if max_blocks > 0 \
            else []
        disk = self._disk_extension(
            prompt, run[-1].key if run else b"", len(run), max_blocks
        )
        with self._lock:
            if run or disk:
                self.hits += 1
            else:
                self.misses += 1
        return (len(run) + len(disk)) * self.block_tokens

    def peek_prefix_len(self, prompt_ids) -> int:
        """Like :meth:`match_prefix_len` but side-effect free (no
        counters, no recency touch)."""
        prompt = tuple(int(t) for t in prompt_ids)
        max_blocks = (len(prompt) - 1) // self.block_tokens
        if max_blocks <= 0:
            return 0
        run = self._walk(prompt, max_blocks, touch=False)
        disk = self._disk_extension(
            prompt, run[-1].key if run else b"", len(run), max_blocks
        )
        return (len(run) + len(disk)) * self.block_tokens

    def gather_prefix(
        self, prompt_ids, length: int
    ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Assemble (dequantize + concatenate) exactly ``length`` tokens of
        cached prefix KV. Returns None when the run is no longer fully
        resident (evicted since the length probe, or a spilled block
        failed to fault back); callers fall back to a cold prefill."""
        bt = self.block_tokens
        if length <= 0 or length % bt:
            return None
        prompt = tuple(int(t) for t in prompt_ids[:length])
        run = self._walk(prompt, length // bt, touch=True)
        if len(run) * bt < length:
            if not self._fault_back(prompt, length // bt):
                return None
            run = self._walk(prompt, length // bt, touch=True)
            if len(run) * bt < length:
                return None
        # assembly OUTSIDE the lock: block arrays are immutable once
        # attached (eviction only drops references)
        k = np.concatenate([self._block_k(b) for b in run], axis=1)
        v = np.concatenate([self._block_v(b) for b in run], axis=1)
        return k, v

    def _fault_back(self, prompt: Tuple[int, ...], n_blocks: int) -> bool:
        """Pull the first ``n_blocks`` of ``prompt`` that live only on the
        spill tier back into the RAM trie. A missing, corrupt, or
        content-mismatched spill file reads as False (cold prefill) —
        never a crash, never wrong bytes."""
        spill = self.spill
        if spill is None:
            return False
        from gpustack_tpu_torch.engine.kv_transfer import _to_cache_tier

        bt = self.block_tokens
        with self._lock:
            resident = set(self._blocks.keys())
        prepared: Dict[int, Tuple] = {}
        key = b""
        complete = True
        for b in range(n_blocks):
            block = prompt[b * bt : (b + 1) * bt]
            key = self._child_key(key, block)
            if key in resident:
                continue
            frame = spill.load(key.hex())
            if frame is None:
                complete = False
                break
            if tuple(frame.tokens) != block:
                # file content does not match its key: quarantine
                spill.note_corrupt()
                spill.remove(key.hex())
                complete = False
                break
            prepared[b] = _to_cache_tier(self, frame)
        if prepared:
            with self._lock:
                _, victims = self._attach_prepared_locked(
                    prompt[: n_blocks * bt], n_blocks, prepared
                )
                self.faultbacks += len(prepared)
            self._spill_victims(victims)
        return complete

    def prefix_keys(self, prompt_ids) -> List[str]:
        """Hex chain keys of the longest RAM-resident block run prefixing
        ``prompt_ids`` (side-effect free): what a puller declares as
        ``have`` so an exporter elides blocks it already holds."""
        prompt = tuple(int(t) for t in prompt_ids)
        max_blocks = (len(prompt) - 1) // self.block_tokens
        if max_blocks <= 0:
            return []
        return [
            b.key.hex()
            for b in self._walk(prompt, max_blocks, touch=False)
        ]

    def resident_keys(self, prompt_ids) -> Tuple[List[str], List[str]]:
        """``(ram_keys, disk_keys)`` of the longest resident block run
        prefixing ``prompt_ids`` across both tiers (side-effect free).
        ``prefix_keys`` stays RAM-only: it feeds the wire ``have`` dedup,
        and a skipped frame for a disk-resident block would end the
        import's run at the RAM trie's gap."""
        prompt = tuple(int(t) for t in prompt_ids)
        max_blocks = (len(prompt) - 1) // self.block_tokens
        if max_blocks <= 0:
            return [], []
        run = self._walk(prompt, max_blocks, touch=False)
        disk = self._disk_extension(
            prompt, run[-1].key if run else b"", len(run), max_blocks
        )
        return [b.key.hex() for b in run], disk

    def boost_sharing(self, keys_hex, count: int) -> int:
        """Record the fleet-wide sharing count the cluster directory
        reports for these chain keys: the eviction score divides by it,
        so a block many replicas hold (a shared system prompt) outlives
        cold per-conversation suffixes. Returns the blocks updated."""
        count = max(0, int(count))
        updated = 0
        with self._lock:
            for key_hex in keys_hex:
                try:
                    blk = self._blocks.get(bytes.fromhex(key_hex))
                except ValueError:
                    continue
                if blk is not None and blk.sharing < count:
                    blk.sharing = count
                    updated += 1
        return updated

    @staticmethod
    def _exported(run: List[_Block]) -> List[dict]:
        from gpustack_tpu_torch.engine.kv_transfer import _dtype_name

        return [
            {
                "key": b.key.hex(),
                "tokens": b.tokens,
                "k": b.k,
                "v": b.v,
                "k_scale": b.k_scale,
                "v_scale": b.v_scale,
                "dtype": _dtype_name(b.dtype),
                "nbytes": b.nbytes,
            }
            for b in run
        ]

    def export_chain(self, tail_key_hex: str) -> List[dict]:
        """The RAM-resident block chain ending at ``tail_key_hex`` (root
        to tail), in :meth:`export_blocks`' shape: the prefetch export,
        keyed by chain key because the puller has only the directory's
        summary, no token ids."""
        try:
            tail = bytes.fromhex(tail_key_hex)
        except ValueError:
            return []
        chain: List[_Block] = []
        with self._lock:
            node = self._blocks.get(tail)
            self._tick += 1
            while node is not None and node is not self._root:
                node.last_used = self._tick
                chain.append(node)
                node = node.parent
        chain.reverse()
        return self._exported(chain)

    def export_blocks(
        self, prompt_ids, max_blocks: int = 0
    ) -> List[dict]:
        """The matched block run for ``prompt_ids`` AS STORED (int8 tiers
        export quantized + scales), for ``kv_transfer.export_frames``."""
        prompt = tuple(int(t) for t in prompt_ids)
        limit = (len(prompt) - 1) // self.block_tokens
        if max_blocks > 0:
            limit = min(limit, max_blocks)
        if limit <= 0:
            return []
        return self._exported(self._walk(prompt, limit, touch=True))

    def named_blocks(self, keys_hex) -> Tuple[List[dict], int]:
        """This rank's RAM blocks under ``keys_hex``, in
        :meth:`export_blocks`' shape (a follower's side of a leader's
        export), and the index of the first key it lacks (-1: none)."""
        with self._lock:
            run = [self._blocks.get(bytes.fromhex(k)) for k in keys_hex]
        missing = next((i for i, b in enumerate(run) if b is None), -1)
        return self._exported(run[:missing] if missing >= 0 else run), \
            missing

    def import_blocks(self, token_ids, prepared: Dict[int, Tuple]) -> int:
        """Attach pre-converted blocks: ``prepared[b]`` is ``(k, v,
        scales|None, dtype, nbytes)`` for block index ``b`` of
        ``token_ids``. A gap — neither cached nor provided — ends the
        run."""
        tokens = tuple(int(t) for t in token_ids)
        n_blocks = len(tokens) // self.block_tokens
        if n_blocks <= 0:
            return 0
        with self._lock:
            inserted, victims = self._attach_prepared_locked(
                tokens, n_blocks, prepared
            )
        self._spill_victims(victims)
        return inserted

    def match_prefix(
        self, prompt_ids
    ) -> Optional[Tuple[np.ndarray, np.ndarray, int]]:
        """One-shot convenience (tests, small prompts): longest proper
        prefix run fully assembled. The engine uses the two-phase
        match_prefix_len → trim → gather_prefix flow instead."""
        matched = self.match_prefix_len(prompt_ids)
        if matched <= 0:
            return None
        got = self.gather_prefix(prompt_ids, matched)
        if got is None:
            return None
        return got[0], got[1], matched

    def _block_k(self, blk: _Block) -> np.ndarray:
        if blk.k_scale is None:
            return blk.k
        return _dequantize_block(blk.k, blk.k_scale, blk.dtype)

    def _block_v(self, blk: _Block) -> np.ndarray:
        if blk.v_scale is None:
            return blk.v
        return _dequantize_block(blk.v, blk.v_scale, blk.dtype)

    # ---- insert ---------------------------------------------------------

    def insert_sequence(self, token_ids, k, v, amax=None) -> int:
        """Split ``(k, v)`` (``[L, T, H, hd]`` with ``T >=
        len(token_ids)``; extra width is bucket padding) into full blocks
        and attach any that are not already cached. Existing blocks are
        touched (LRU recency), never re-stored. Returns the number of new
        blocks. Under ``sp`` (``stripe``) ``k``/``v`` are this rank's
        stripes, ``block_rows`` rows a block, and an int8 tier takes each
        block's whole amax from ``amax`` (fp32 ``[2, L, blocks, H]``: K's,
        then V's)."""
        tokens = tuple(int(t) for t in token_ids)
        bt = self.block_tokens
        n_blocks = len(tokens) // bt
        if n_blocks <= 0:
            return 0
        k = np.asarray(k)
        v = np.asarray(v)
        # walk under the lock FIRST to find where new blocks start, so the
        # quantize/copy work below runs only for the new suffix
        start = 0
        with self._lock:
            node = self._root
            for b in range(n_blocks):
                block = tokens[b * bt : (b + 1) * bt]
                child = node.children.get(self._child_key(node.key, block))
                if child is None or child.tokens != block:
                    break
                self._tick += 1
                child.last_used = self._tick
                node = child
                start += 1
        if start == n_blocks:
            return 0
        prepared = {b: self._prepare(k, v, b, amax)
                    for b in range(start, n_blocks)}
        with self._lock:
            inserted, victims = self._attach_prepared_locked(
                tokens, n_blocks, prepared
            )
        self._spill_victims(victims)
        return inserted

    def _prepare(self, k, v, b: int,
                 amax=None) -> Tuple[Any, Any, Any, Any, int]:
        """Block ``b`` of ``k``/``v`` (``block_rows`` rows a block) in this
        cache's tier: ``(k, v, scales|None, dtype, nbytes)``."""
        n = self.block_rows
        k, v = np.asarray(k), np.asarray(v)
        bk = k[:, b * n : (b + 1) * n]
        bv = v[:, b * n : (b + 1) * n]
        if self.int8:
            ak = av = None
            if amax is not None:
                ak, av = (amax[i][:, b][:, None, :, None] for i in (0, 1))
            qk, sk = _quantize_block(bk, ak)
            qv, sv = _quantize_block(bv, av)
            nbytes = qk.nbytes + qv.nbytes + sk.nbytes + sv.nbytes
            return qk, qv, (sk, sv), k.dtype, nbytes
        bk = np.ascontiguousarray(bk)
        bv = np.ascontiguousarray(bv)
        return bk, bv, None, k.dtype, bk.nbytes + bv.nbytes

    def _attach_prepared_locked(
        self, tokens: Tuple[int, ...], n_blocks: int,
        prepared: Dict[int, Tuple],
    ) -> Tuple[int, List[_Block]]:
        """Re-walk from the root (the trie may have changed since any
        earlier walk), touch existing blocks, attach prepared ones, and
        end the run at the first block that is neither."""
        bt = self.block_tokens
        inserted = 0
        node = self._root
        for b in range(n_blocks):
            block = tokens[b * bt : (b + 1) * bt]
            key = self._child_key(node.key, block)
            child = node.children.get(key)
            if child is not None and child.tokens == block:
                self._tick += 1
                child.last_used = self._tick
                node = child
                continue
            if b not in prepared:
                break
            bk, bv, scales, dtype, nbytes = prepared[b]
            if nbytes > self.max_bytes and not self.follower:
                break   # one block over the whole budget: stop here
            child = _Block(key, block, node)
            child.k, child.v = bk, bv
            if scales is not None:
                child.k_scale, child.v_scale = scales
            child.dtype = dtype
            child.nbytes = nbytes
            self._tick += 1
            child.last_used = self._tick
            node.children[key] = child
            node.refs += 1
            self._blocks[key] = child
            self._bytes += nbytes
            self.blocks_inserted += 1
            inserted += 1
            self._note("attach", b)
            node = child
        return inserted, self._evict_locked()

    def _eviction_score_locked(self, blk: _Block) -> float:
        """bytes × age / (1 + sharing + reuse): a large stale block evicts
        before a small one, a block many requests touched (or many
        replicas hold, ``boost_sharing``) survives past its raw recency.
        Highest score evicts first."""
        age = max(1, self._tick - blk.last_used + 1)
        reuse = blk.sharing + min(blk.touches, 8)
        return (blk.nbytes * age) / (1.0 + reuse)

    def _evict_locked(self) -> List[_Block]:
        """Detach worst-scoring leaf blocks until back under budget and
        return them — the caller spills them (file I/O happens OUTSIDE
        the trie lock). Leaf-only: ``refs > 0`` means children extend this
        block. A follower's cache never evicts on its own: its leader's
        journal names the victims (:meth:`replay`)."""
        victims: List[_Block] = []
        while (self._bytes > self.max_bytes and self._blocks
               and not self.follower):
            victim = None
            score = -1.0
            for blk in self._blocks.values():
                if blk.refs:
                    continue
                s = self._eviction_score_locked(blk)
                if s > score:
                    victim, score = blk, s
            if victim is None:
                break
            parent = victim.parent
            del parent.children[victim.key]
            parent.refs -= 1
            del self._blocks[victim.key]
            self._bytes -= victim.nbytes
            self.blocks_evicted += 1
            self._note("evict", victim.key.hex())
            victims.append(victim)
        return victims

    def _spill_victims(self, victims: List[_Block]) -> None:
        """Write evicted blocks to the disk tier (no-op without one),
        outside the trie lock. Blocks whose spill file already exists (a
        faulted-back copy re-evicting) skip the rewrite."""
        spill = self.spill
        if spill is None or not victims:
            return
        from gpustack_tpu_torch.engine.kv_spill import encode_spill_frame

        for blk in victims:
            key_hex = blk.key.hex()
            if spill.has(key_hex):
                continue
            spill.store(key_hex, encode_spill_frame(blk)[1])

    # ---- introspection --------------------------------------------------

    @property
    def entries(self) -> int:
        with self._lock:
            return len(self._blocks)

    @property
    def bytes_used(self) -> int:
        with self._lock:
            return self._bytes
