"""Engine-side conversation index: the cluster KV directory's feed.

The port's copy of ``gpustack_tpu/engine/kv_fabric.py`` (``ConvIndex``)
and of ``gpustack_tpu/server/resilience.py``'s ``conversation_chain``.
The fleet's block directory routes on *cached-prefix mass*: how many of a
request's prefix blocks a replica actually holds. The proxy keys
conversations by message-prefix hashes (``conversation_chain``); the
engine keys KV blocks by token-block chain hashes. This index is the
bridge: at chat finish the server records the conversation's message
chain beside its token ids, and ``summary()`` re-checks block residency
across both cache tiers at scrape time (``POST /kv/summary``), so the
directory sees what a fresh request would match now, not what was once
stored.

Bounded: ``max_entries`` conversations, least recently recorded evicted
first; a summary carries at most ``max_keys`` chain hashes (the most
recent conversations win). Thread-safe: recorded from request handlers,
summarized from the scrape path.
"""

from __future__ import annotations

import collections
import hashlib
import json
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

DEFAULT_MAX_ENTRIES = 1024
DEFAULT_SUMMARY_KEYS = 512


def conversation_chain(model_name: str, messages: Sequence) -> List[str]:
    """Rolling hex digests of a chat's message prefixes: ``chain[k]`` keys
    ``messages[:k+1]``, seeded with the model name. Turn N+1's first
    ``len_N`` messages are turn N's whole list, so its chain extends turn
    N's. The digests are the proxy's, byte for byte."""
    chain: List[str] = []
    h = hashlib.sha256(model_name.encode())
    for msg in messages:
        if isinstance(msg, dict):
            payload = json.dumps(
                {
                    "role": msg.get("role", ""),
                    "content": msg.get("content", ""),
                },
                sort_keys=True, default=str,
            )
        else:
            payload = str(msg)
        h.update(payload.encode())
        chain.append(h.hexdigest())
    return chain


class _Conv:
    __slots__ = ("chain", "tokens")

    def __init__(self, chain: Tuple[str, ...], tokens: np.ndarray):
        self.chain = chain
        self.tokens = tokens


class ConvIndex:
    """Bounded map: conversation chain head → (message chain, tokens)."""

    def __init__(self, max_entries: int = DEFAULT_MAX_ENTRIES):
        self.max_entries = max(16, int(max_entries))
        self._entries: "collections.OrderedDict[str, _Conv]" = (
            collections.OrderedDict()
        )
        self._mu = threading.Lock()
        self.recorded = 0

    def __len__(self) -> int:
        with self._mu:
            return len(self._entries)

    def record(self, chain: Sequence[str], token_ids) -> None:
        """Remember a served conversation: its message-prefix hash chain
        and the token sequence whose KV blocks the cache holds (prompt +
        generated: what turn N+1 will prefix-match)."""
        if not chain or token_ids is None or not len(token_ids):
            return
        conv = _Conv(tuple(chain), np.asarray(list(token_ids), np.int32))
        head = conv.chain[-1]
        with self._mu:
            self._entries.pop(head, None)
            self._entries[head] = conv
            self.recorded += 1
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)

    def _recent(self) -> List[Tuple[str, _Conv]]:
        with self._mu:
            return list(reversed(self._entries.items()))

    def summary(self, cache, max_keys: int = DEFAULT_SUMMARY_KEYS) -> Dict:
        """The per-replica prefix-key summary the directory scrapes:
        ``keys`` maps each conversation-prefix hash this replica served to
        the block depth resident now (RAM + disk) and the deepest RAM
        block's chain key (the prefetch export handle, ``tail``). The most
        recent conversations win the ``max_keys`` bound; a conversation
        whose blocks all evicted contributes nothing, which lets the proxy
        drop stale affinity."""
        keys: Dict[str, Dict] = {}
        conversations = 0
        for _head, conv in self._recent():
            if len(keys) >= max_keys or cache is None:
                break
            ram, disk = cache.resident_keys(conv.tokens)
            blocks = len(ram) + len(disk)
            if blocks == 0:
                continue
            conversations += 1
            entry = {"blocks": blocks, "tail": ram[-1] if ram else ""}
            for h in conv.chain:
                prev = keys.get(h)
                if prev is None or blocks > prev["blocks"]:
                    keys[h] = entry
        return {"keys": keys, "conversations": conversations}

    def apply_sharing(
        self, cache, sharing: Optional[Dict[str, int]]
    ) -> int:
        """Fold the directory's fleet-wide sharing counts (conversation
        hash → replicas holding it) into the cache's eviction score: every
        resident block of a shared conversation gets the count. Returns
        the blocks updated."""
        if not sharing or cache is None:
            return 0
        updated = 0
        for _head, conv in self._recent():
            count = 0
            for h in conv.chain:
                c = sharing.get(h)
                if c is not None and int(c) > count:
                    count = int(c)
            if count <= 1:
                continue
            ram, _ = cache.resident_keys(conv.tokens)
            if ram:
                updated += cache.boost_sharing(ram, count)
        return updated
