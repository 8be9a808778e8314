"""Disk spill tier under the host-RAM KV cache: one file per block.

The port's copy of ``gpustack_tpu/engine/kv_spill.py``. Blocks evicted
from host RAM spill to local disk instead of being dropped, keyed by the
same content-addressed chain keys the radix trie uses, so a later prompt
sharing the prefix faults the blocks back instead of re-prefilling. One
file is ``MAGIC + one frame`` of the KV frame codec (``kv_transfer``),
written tmp-then-rename so a crash never leaves a half-visible block. The
files are byte for byte those the JAX package writes for the same blocks.

Durability contract: this tier is a CACHE, not a store of record. Any
corruption — truncated file, bad magic, crc mismatch, unparseable meta —
degrades to a miss (the file is deleted and a counter bumps), never a
crash and never wrong bytes.

On a multi-GPU replica every rank spills to a directory of its own (the
default is per process; an explicit one gets a ``rank<r>`` subdirectory),
and only on the leader's word: a leader's tier journals each file it
drops (``journal``), and a follower's tier never evicts a file on its own
(``follower``).

Thread contract: all disk I/O (``store``/``load``) runs on the engine's
kv-copy executor; the in-memory index has its own lock so residency
probes (``has``/``size``) from the scheduler thread never touch files.
"""

from __future__ import annotations

import logging
import mmap
import os
import threading
from typing import Dict, List, Tuple

from gpustack_tpu_torch.engine.kv_transfer import (
    MAGIC,
    _dtype_name,
    decode_stream,
    encode_frame,
)

logger = logging.getLogger(__name__)

SPILL_SUFFIX = ".kvb"


# concurrency contract: the index and every counter are shared between the
# kv-copy executor (store/load) and scheduler/HTTP readers — always under
# `_mu`, never held across file I/O.
GUARDED_BY = {
    "_index": "_mu",
    "_bytes": "_mu",
    "_tick": "_mu",
    "blocks_spilled": "_mu",
    "blocks_loaded": "_mu",
    "bytes_spilled": "_mu",
    "bytes_loaded": "_mu",
    "corrupt": "_mu",
    "evictions": "_mu",
    "journal": "_mu",
}

# sync-in-dispatch: residency probes never touch the filesystem
DISPATCH_SYNC_FREE = ("has", "size")


class DiskKVSpill:
    """Byte-bounded one-file-per-block spill store. Construction
    re-indexes whatever blocks a previous engine life left in the same
    directory; every load re-verifies magic + crc."""

    def __init__(self, directory: str, max_bytes: int):
        self.directory = directory
        self.max_bytes = max(0, int(max_bytes))
        os.makedirs(directory, exist_ok=True)
        self._mu = threading.Lock()
        # key hex -> (file size, insertion tick); tick orders eviction
        self._index: Dict[str, Tuple[int, int]] = {}
        self._bytes = 0
        self._tick = 0
        self.blocks_spilled = 0
        self.blocks_loaded = 0          # fault-backs that verified clean
        self.bytes_spilled = 0
        self.bytes_loaded = 0
        self.corrupt = 0                # loads that degraded to a miss
        self.evictions = 0              # disk-budget evictions
        # multi-GPU roles (HostKVCache.lead/follow): the leader's journal,
        # which gets ("unspill", key) for every file dropped; a follower
        # drops files only when told
        self.journal = None
        self.follower = False
        self._scan()

    # ---- residency ------------------------------------------------------

    def has(self, key_hex: str) -> bool:
        with self._mu:
            return key_hex in self._index

    def size(self, key_hex: str) -> int:
        """Spilled file size; 0 when not resident."""
        with self._mu:
            entry = self._index.get(key_hex)
            return entry[0] if entry else 0

    @property
    def entries(self) -> int:
        with self._mu:
            return len(self._index)

    def keys(self) -> List[str]:
        """Every spilled chain key (hex), sorted."""
        with self._mu:
            return sorted(self._index)

    @property
    def bytes_used(self) -> int:
        with self._mu:
            return self._bytes

    # ---- spill (RAM -> disk) -------------------------------------------

    def store(self, key_hex: str, frame_bytes: bytes) -> bool:
        """Write one encoded block frame under its chain key, atomically;
        an OS error degrades to "not spilled" (the block was already
        evicted; losing the spill copy only costs a future re-prefill)."""
        if self.max_bytes <= 0:
            return False
        path = self._path(key_hex)
        tmp = path + ".tmp"
        try:
            with open(tmp, "wb") as f:
                f.write(MAGIC)
                f.write(frame_bytes)
            os.replace(tmp, path)
        except OSError as e:
            logger.warning("kv spill write failed for %s: %s", key_hex, e)
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return False
        size = len(frame_bytes) + len(MAGIC)
        with self._mu:
            prev = self._index.pop(key_hex, None)
            if prev is not None:
                self._bytes -= prev[0]
            self._tick += 1
            self._index[key_hex] = (size, self._tick)
            self._bytes += size
            self.blocks_spilled += 1
            if self.journal is not None:
                self.journal.append(("spill", key_hex))
            self.bytes_spilled += size
            doomed = self._collect_over_budget_locked()
        for victim in doomed:
            self._unlink(victim)
        return True

    # ---- fault-back (disk -> RAM) --------------------------------------

    def load(self, key_hex: str):
        """Read + verify one spilled block: the decoded
        ``kv_transfer.Frame`` or None. Any defect deletes the file, bumps
        ``corrupt`` (unless simply absent) and reads as a miss."""
        with self._mu:
            entry = self._index.get(key_hex)
        if entry is None:
            return None
        path = self._path(key_hex)
        try:
            with open(path, "rb") as f:
                try:
                    buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
                except (ValueError, OSError):
                    # empty or unmappable file: read() the (tiny) tail
                    buf = f.read()
                try:
                    frames = decode_stream(bytes(buf))
                finally:
                    if isinstance(buf, mmap.mmap):
                        buf.close()
        except FileNotFoundError:
            # raced an eviction: plain miss, not corruption
            with self._mu:
                self._drop_locked(key_hex)
            return None
        except (OSError, ValueError) as e:
            logger.warning(
                "kv spill block %s unreadable (%s); degrading to a miss",
                key_hex, e,
            )
            self._quarantine(key_hex)
            return None
        if len(frames) != 1 or frames[0].skipped or frames[0].k is None:
            self._quarantine(key_hex)
            return None
        frame = frames[0]
        with self._mu:
            entry = self._index.get(key_hex)
            if entry is not None:
                self.blocks_loaded += 1
                self.bytes_loaded += entry[0]
        return frame

    def remove(self, key_hex: str) -> None:
        self._unlink(key_hex)

    # ---- internals ------------------------------------------------------

    def _path(self, key_hex: str) -> str:
        return os.path.join(self.directory, key_hex + SPILL_SUFFIX)

    def _scan(self) -> None:
        try:
            names = os.listdir(self.directory)
        except OSError:
            return
        with self._mu:
            for name in sorted(names):
                if not name.endswith(SPILL_SUFFIX):
                    continue
                key_hex = name[: -len(SPILL_SUFFIX)]
                try:
                    size = os.path.getsize(
                        os.path.join(self.directory, name)
                    )
                except OSError:
                    continue
                self._tick += 1
                self._index[key_hex] = (size, self._tick)
                self._bytes += size
            doomed = self._collect_over_budget_locked()
        for victim in doomed:
            self._unlink(victim)

    def _collect_over_budget_locked(self) -> List[str]:
        """Oldest-spilled-first victims to fall back under budget; the
        unlinks happen after the lock is released."""
        doomed: List[str] = []
        if self.max_bytes <= 0 or self.follower:
            return doomed
        while self._bytes > self.max_bytes and self._index:
            key = min(self._index.items(), key=lambda kv: kv[1][1])[0]
            size, _ = self._index.pop(key)
            self._bytes -= size
            self.evictions += 1
            if self.journal is not None:
                self.journal.append(("unspill", key))
            doomed.append(key)
        return doomed

    def _drop_locked(self, key_hex: str) -> None:
        entry = self._index.pop(key_hex, None)
        if entry is not None:
            self._bytes -= entry[0]
            if self.journal is not None:
                self.journal.append(("unspill", key_hex))

    def note_corrupt(self) -> None:
        """Count a corruption a caller detected (the host cache's token
        check on a faulted-back frame)."""
        with self._mu:
            self.corrupt += 1

    def _quarantine(self, key_hex: str) -> None:
        self.note_corrupt()
        self._unlink(key_hex)

    def _unlink(self, key_hex: str) -> None:
        with self._mu:
            self._drop_locked(key_hex)
        try:
            os.unlink(self._path(key_hex))
        except OSError:
            pass

    def snapshot(self) -> Dict[str, int]:
        with self._mu:
            return {
                "entries": len(self._index),
                "bytes": self._bytes,
                "blocks_spilled": self.blocks_spilled,
                "blocks_loaded": self.blocks_loaded,
                "bytes_spilled": self.bytes_spilled,
                "bytes_loaded": self.bytes_loaded,
                "corrupt": self.corrupt,
                "evictions": self.evictions,
            }


def encode_spill_frame(blk) -> Tuple[str, bytes]:
    """One host-cache ``_Block`` → ``(key hex, frame bytes)`` in the
    block's stored tier (int8 spills as int8 + scales)."""
    key_hex = blk.key.hex()
    return key_hex, encode_frame(
        key_hex, blk.tokens,
        k=blk.k, v=blk.v,
        k_scale=blk.k_scale, v_scale=blk.v_scale,
        dtype=_dtype_name(blk.dtype),
    )
