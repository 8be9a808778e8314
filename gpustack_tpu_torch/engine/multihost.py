"""Multi-GPU serving: the leader's command channel to its followers.

The port of ``gpustack_tpu/engine/multihost.py``. A replica over a mesh is
one process per GPU, and every collective of the sharded forward
(``models.transformer``) needs every rank to make the same calls in the
same order. Only the leader (rank 0) serves requests, so it broadcasts
each device op it is about to run (prefill, first-token sample, insert,
decode, deactivate, the chunked-prefill ops) over a TCP channel of
newline-delimited JSON, and each follower replays the same call on its own
runner. The op vocabulary, the ``AUTH <token>`` handshake and
``GPUSTACK_TPU_CMD_TOKEN`` are the JAX module's; ``probe`` is the port's
own (``diagnostics.probe``: slot state, launch counts and memory gathered
from every rank, for checks).

Determinism contract:

- the sampler's step key is an int (``engine._step_key``) and rides the
  wire as one, so every rank samples from the same key;
- tensors never ride the wire: a follower's prefill output stays in its
  register until the next ``insert``; chunk ops keep a register of their
  own so a one-shot prefill admitted between chunks cannot clobber it;
- after each decode step the runner broadcasts rank 0's tokens on the
  device (``ModelRunner.decode_step``; under ``dp`` it gathers each
  group's rows from the group's first rank), so followers' slot states
  equal the leader's bit for bit;
- under ``dp`` the prefill ops name their slot, and a follower whose
  group does not own it skips the forward (its registers hold None) and
  the first-token sample; ``insert`` writes K/V on the owning group only
  and sets the slot's vectors everywhere;
- the host KV tier: each rank keeps its own (its part of every block: its
  KV heads, and under ``sp`` its stripe of the block's tokens, with the
  whole block's int8 scales) and rank 0's is the authority. The leader
  alone matches prompts and decides evictions, spills and restores; it
  names every store (at the
  moment it copies the K/V out: the followers copy their register's or a
  slot's rows at the same point of the op stream), every change its tier
  made (a journal: blocks attached, evicted, spilled, spill files
  dropped) and every hit (the gather, then its adoption into a slot's
  prefill). A follower runs its tier's side on its own kv-copy thread in
  the order the leader named it (:class:`FollowerTier`), and an adopted
  hit is checked on every rank at once (one world all-gather): a rank
  that lacks a named block ends the replica with an error naming the key
  and the rank, never a cold prefill on one rank;
- speculation: n-gram proposals ride the verify op as host ints; a
  draft's stay on rank 0's card and reach the others in one broadcast on
  the device; every rank ends the step with rank 0's accepted tokens
  (``ModelRunner.verify_step``);
- a handoff (``/kv/export``, ``/kv/import``) moves whole blocks while
  each rank keeps its own part. An export is named (``kv_export``: the
  chain keys whose payload travels) where the leader reads its tier,
  under the tier lock, and each distinct part of those blocks then moves
  once to rank 0, which joins them (:func:`gather_parts`); an import is
  attached on the leader at its part and named (``kv_import``: the token
  chain, the journal, a whole block's shapes), then rank 0 sends every
  other rank its part (:func:`scatter_parts`) and each follower attaches
  it as the journal says. Both run on the leader's scheduler thread,
  where every other op and collective starts;
- an embedding batch rides the ``embed`` op as host ints; the first
  ``dp`` group runs it (``ModelRunner.embed``; under ``sp`` a ring
  prefill whose pooled sums every ``sp`` rank adds);
- the vision path: the tower runs on rank 0 alone (its server decodes
  the images and builds the prompt on the request's handler thread), so
  no follower holds image state that could part from the leader's. The
  ``prefill_with_embeds`` op carries host ints only (the padded ids,
  ``true_len``, the slot and the mask's runs of image rows); the rows
  themselves leave rank 0's card in one world broadcast on the device
  (``ModelRunner.prefill_with_embeds``), and each rank splices its own.
  An image prompt is never stored in or matched against any rank's tier
  (the leader names no store) and never chunked.

A follower that dies closes its socket: the leader's watcher sees it, and
the next scheduler step raises, which makes the engine fatal and
``/healthz`` report it (``LLMEngine._loop``).
"""

from __future__ import annotations

import json
import logging
import os
import socket
import threading
import time
import types
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from gpustack_tpu_torch.engine import diagnostics
from gpustack_tpu_torch.engine.host_bf16 import to_numpy
from gpustack_tpu_torch.engine.kv_transfer import (
    _dtype_from_name,
    _dtype_name,
    block_arrays,
    join_parts,
    pack_arrays,
    slice_part,
    unpack_arrays,
)
from gpustack_tpu_torch.parallel.mesh import kv_head_range, kv_stripe

logger = logging.getLogger(__name__)

_CONNECT_TIMEOUT_S = 600.0   # followers may still be loading weights

# guarded-by contract: the leader's tier lock serialises each change of
# its tier with the op that names it (the scheduler and the kv-copy
# thread both change it); a follower's staged stores belong to its
# kv-copy thread, its gathered hits and pending futures to its loop
_FOLLOWER_KV_THREAD = ("_stage", "_commit")
_FOLLOWER_LOOP = ("store", "commit", "gather", "adopt", "check", "drain",
                  "_submit")
GUARDED_BY = {
    "BroadcastingRunner._gathers": "_tier_mu",
    "FollowerTier._staged": _FOLLOWER_KV_THREAD,
    "FollowerTier._gathered": _FOLLOWER_LOOP,
    "FollowerTier._futures": _FOLLOWER_LOOP,
}

# thread-boundary contract: a follower's tier state is touched only by the
# thread that owns it (its loop, or its kv-copy thread)
THREAD_OWNED = ("FollowerTier._staged", "FollowerTier._gathered",
                "FollowerTier._futures")


def channel_token() -> str:
    """The replica's shared command-channel token (``GPUSTACK_TPU_CMD_TOKEN``,
    the same in every process of the replica); empty disables auth."""
    return os.environ.get("GPUSTACK_TPU_CMD_TOKEN", "")


class CommandLeader:
    """Leader side: accepts follower connections, broadcasts op lines.

    Connections must open with ``AUTH <token>\\n``; a failed handshake is
    closed without counting toward ``n_followers`` and the accept loop
    goes on, so a stray client cannot take a follower's place."""

    _HANDSHAKE_TIMEOUT_S = 10.0

    def __init__(
        self, port: int, n_followers: int, host: str = "0.0.0.0",
        token: Optional[str] = None,
    ):
        self.n_followers = n_followers
        self.token = channel_token() if token is None else token
        self.error = ""              # set when a follower's socket closes
        self._conns: List[socket.socket] = []
        self._lock = threading.Lock()
        self._ready = threading.Event()
        self._closing = False
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(n_followers)
        threading.Thread(
            target=self._accept_loop, name="mh-accept", daemon=True
        ).start()

    def _handshake(self, conn: socket.socket, addr) -> None:
        """Admit ``conn`` iff its first line is the right AUTH; runs in its
        own thread so a stalled client cannot block the accept loop."""
        try:
            conn.settimeout(self._HANDSHAKE_TIMEOUT_S)
            buf = b""
            while b"\n" not in buf and len(buf) < 512:
                chunk = conn.recv(256)
                if not chunk:
                    break
                buf += chunk
            line = buf.split(b"\n", 1)[0].decode(errors="replace").strip()
            if line != f"AUTH {self.token}".strip():
                logger.warning(
                    "rejecting command-channel connection from %s "
                    "(bad handshake)", addr,
                )
                conn.close()
                return
            conn.settimeout(None)
        except OSError:
            try:
                conn.close()
            except OSError:
                pass
            return
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        logger.info("follower connected from %s", addr)
        with self._lock:
            if len(self._conns) >= self.n_followers:
                conn.close()            # late duplicate
                return
            self._conns.append(conn)
            if len(self._conns) >= self.n_followers:
                self._ready.set()
        threading.Thread(
            target=self._watch, args=(conn, addr), name="mh-watch",
            daemon=True,
        ).start()

    def _watch(self, conn: socket.socket, addr) -> None:
        """A follower sends nothing after its handshake but, when an op
        fails on it, one ``ERROR <why>`` line: end of stream or an error on
        its socket means it is gone."""
        said = b""
        try:
            while chunk := conn.recv(256):
                said = (said + chunk)[-4096:]
        except OSError:
            pass
        if not self._closing:
            why = said.decode(errors="replace").strip()
            self.error = f"follower at {addr[0]}:{addr[1]} disconnected" + (
                f" ({why[len('ERROR '):]})" if why.startswith("ERROR ")
                else "")
            logger.error("%s", self.error)

    def _accept_loop(self) -> None:
        while not self._ready.is_set():
            try:
                conn, addr = self._srv.accept()
            except OSError:
                return
            threading.Thread(
                target=self._handshake, args=(conn, addr),
                name="mh-handshake", daemon=True,
            ).start()

    def broadcast(self, op: Dict[str, Any]) -> None:
        """Send one op to every follower; blocks until all are connected
        (an op before the rendezvous would be lost, and the collectives
        behind it would hang)."""
        if not self._ready.wait(_CONNECT_TIMEOUT_S):
            raise RuntimeError(
                f"only {len(self._conns)}/{self.n_followers} followers "
                "connected to the command channel"
            )
        if self.error:
            raise RuntimeError(self.error)
        line = (json.dumps(op) + "\n").encode()
        with self._lock:
            for conn in self._conns:
                try:
                    conn.sendall(line)
                except OSError as e:
                    self.error = f"follower send failed: {e}"
                    raise RuntimeError(self.error) from e

    def close(self) -> None:
        """Close every follower's connection (each follower's loop then
        ends). ``shutdown`` first: a plain close would wait for the
        watcher blocked in ``recv`` and send nothing."""
        self._closing = True
        with self._lock:
            for c in self._conns:
                try:
                    c.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    c.close()
                except OSError:
                    pass
            self._conns.clear()
        try:
            self._srv.close()
        except OSError:
            pass


def _slot(slot):
    return None if slot is None else int(slot)


def mask_runs(mask) -> List[List[int]]:
    """``[[start, length], ...]``: the runs of True in a bool mask (an
    image prompt's rows), as host ints for the wire."""
    m = np.concatenate([[False], np.asarray(mask, bool), [False]])
    edges = np.flatnonzero(m[1:] != m[:-1])
    return [[int(a), int(b - a)] for a, b in zip(edges[::2], edges[1::2])]


def mask_of(runs, n: int) -> np.ndarray:
    """The bool mask of ``n`` rows whose True runs are ``runs``
    (:func:`mask_runs`)."""
    mask = np.zeros(n, bool)
    for start, length in runs:
        mask[start:start + length] = True
    return mask


def _bias(logit_bias):
    return (
        {str(k): float(v) for k, v in logit_bias.items()}
        if logit_bias else None
    )


class BroadcastingRunner:
    """Wraps the leader's ModelRunner: every replayable device op is
    broadcast to the followers before it runs here."""

    # insert() puts its first token on the wire as an int, so the engine
    # must not hand it a device scalar (its dispatch-ahead admission)
    supports_async_insert = False

    def __init__(self, runner, leader: CommandLeader):
        self._runner = runner
        self._leader = leader
        # each change of the leader's tier and the op naming it, as one
        self._tier_mu = threading.Lock()
        self._gathers: Dict[int, list] = {}    # gather id -> its tokens
        self._tier_cache = None

    def __getattr__(self, name):
        # everything not wrapped delegates (bucket_for, layout, plan, ...)
        return getattr(self._runner, name)

    @property
    def channel_error(self) -> str:
        return self._leader.error

    def close(self) -> None:
        self._leader.close()

    # -- wrapped ops ------------------------------------------------------

    def prefill(self, token_ids, true_len: int, slot=None):
        self._leader.broadcast({
            "op": "prefill",
            "ids": [int(t) for t in token_ids],
            "true_len": int(true_len), "slot": _slot(slot),
        })
        return self._runner.prefill(token_ids, true_len, slot)

    def prefill_with_embeds(self, token_ids, true_len: int, embeds, mask,
                            slot=None):
        """An image prompt's prefill: the op names the mask's runs, and
        the rows under it reach the followers on the device, from this
        rank's ``embeds`` (``ModelRunner.prefill_with_embeds``)."""
        self._leader.broadcast({
            "op": "prefill_with_embeds",
            "ids": [int(t) for t in token_ids],
            "true_len": int(true_len), "slot": _slot(slot),
            "rows": mask_runs(mask),
        })
        return self._runner.prefill_with_embeds(token_ids, true_len, embeds,
                                                mask, slot)

    def sample_first(
        self, last_logits, temperature, top_k, top_p, seed, seeded,
        position, key, logit_bias=None,
    ):
        self._leader.broadcast({
            "op": "sample_first",
            "temperature": float(temperature), "top_k": int(top_k),
            "top_p": float(top_p), "seed": int(seed),
            "seeded": bool(seeded), "position": int(position),
            "key": int(key), "logit_bias": _bias(logit_bias),
        })
        return self._runner.sample_first(
            last_logits, temperature, top_k, top_p, seed, seeded,
            position, key, logit_bias,
        )

    def insert(
        self, state, k, v, slot, true_len, first_token,
        temperature, top_k, top_p, seed=0, seeded=False, logit_bias=None,
    ):
        self._leader.broadcast({
            "op": "insert", "slot": int(slot), "true_len": int(true_len),
            "first_token": int(first_token),
            "temperature": float(temperature), "top_k": int(top_k),
            "top_p": float(top_p), "seed": int(seed),
            "seeded": bool(seeded), "logit_bias": _bias(logit_bias),
        })
        return self._runner.insert(
            state, k, v, slot, true_len, first_token,
            temperature, top_k, top_p, seed, seeded, logit_bias,
        )

    def decode_step(self, state, key):
        self._leader.broadcast({"op": "decode", "key": int(key)})
        return self._runner.decode_step(state, key)

    # -- chunked prefill (engine._advance_chunk): only host ints ride the
    # wire; a follower's continuation reads its own earlier chunk

    def prefill_chunk(self, token_ids, true_len: int, slot=None):
        self._leader.broadcast({
            "op": "chunk_start",
            "ids": [int(t) for t in token_ids],
            "true_len": int(true_len), "slot": _slot(slot),
        })
        return self._runner.prefill(token_ids, true_len, slot)

    def prefill_continue_chunk(
        self, k, v, start: int, token_ids, true_len: int,
        total_bucket: int, slot=None, prefix_block: int = 0,
    ):
        self._leader.broadcast({
            "op": "chunk_continue",
            "start": int(start),
            "ids": [int(t) for t in token_ids],
            "true_len": int(true_len),
            "total_bucket": int(total_bucket), "slot": _slot(slot),
            "prefix_block": int(prefix_block),
        })
        return self._runner.prefill_with_prefix(
            k, v, start, token_ids, true_len, total_bucket, slot,
            prefix_block,
        )

    def chunk_commit(self, slot=None) -> None:
        """A completed chunk job: followers promote the slot's chunk
        register to the insert register."""
        self._leader.broadcast({"op": "chunk_commit", "slot": _slot(slot)})

    def chunk_abort(self, slot=None) -> None:
        """An abandoned chunk job: followers drop the slot's chunk
        register."""
        self._leader.broadcast({"op": "chunk_abort", "slot": _slot(slot)})

    # -- the host KV tier -------------------------------------------------

    def kv_store(self, k, v, slot, total: int, store=None):
        """A store of the leader's tier: followers copy the same rows
        (``store["src"]``: their insert register, or ``"slot"``'s rows
        ``[:width]``) at this point of the op stream."""
        self._leader.broadcast({
            "op": "kv_store", "slot": _slot(slot), "total": int(total),
            "id": int(store["id"]), "ids": [int(t) for t in store["ids"]],
            "src": store["src"], "width": int(store.get("width", 0)),
        })
        return self._runner.kv_store(k, v, slot, total, store)

    def tier_op(self, cache, fn, make_op):
        """Change the leader's tier (``fn()``) and name the change to the
        followers: ``make_op(result)`` with the tier's journal of what
        changed, under one lock, so the ops leave in the order the
        changes were made."""
        with self._tier_mu:
            out = fn()
            op = make_op(out)
            op["events"] = cache.take_journal()
            self._tier_cache = cache
            if op["op"] == "kv_gather" and op["ok"]:
                self._gathers[op["id"]] = op["ids"]
            self._leader.broadcast(op)
        return out

    def kv_export(self, cache, read, have=()) -> List[dict]:
        """A whole-block export of the leader's tier (``read()``:
        ``export_blocks`` or ``export_chain``): named to the followers as
        it is read (``kv_export``, the keys of the blocks whose payload
        travels: those outside ``have``), then those blocks' parts
        gathered to rank 0 and joined (:func:`gather_parts`). Scheduler
        thread."""
        have = frozenset(have)
        blocks = self.tier_op(cache, read, lambda blocks: {
            "op": "kv_export",
            "keys": [b["key"] for b in blocks if b["key"] not in have],
        })
        sent = [b for b in blocks if b["key"] not in have]
        joined = gather_parts(self._runner, [b["key"] for b in sent], sent,
                              -1)
        whole = {b["key"]: j for b, j in zip(sent, joined)}
        return [whole.get(b["key"], b) for b in blocks]

    def kv_import_stage(self, prepared) -> dict:
        """The host work of a whole-block import, done before its turn on
        the op stream: the leader's own part of the ``prepared`` blocks
        (``"mine"``), every other rank's packed once per distinct part
        (``"parts"``, pinned on the card), and a whole block's arrays'
        dtypes and shapes (``"like"``)."""
        runner = self._runner
        parts: Dict[tuple, torch.Tensor] = {}
        for r in range(1, runner.plan.chips):
            part = _part(runner, r)
            if part not in parts:
                parts[part] = _staged([
                    a for b in sorted(prepared)
                    for a in block_arrays(*slice_part(prepared[b],
                                                      *part)[:3])
                ], runner.device)
        first = prepared[min(prepared)] if prepared else None
        return {"mine": {b: slice_part(p, *_part(runner, 0))
                         for b, p in prepared.items()},
                "parts": parts,
                "like": [] if first is None else [
                    [a.dtype.str, list(a.shape)]
                    for a in block_arrays(*first[:3])]}

    def kv_import(self, cache, tokens, staged) -> int:
        """A whole-block import (``staged``: :meth:`kv_import_stage`): the
        leader attaches its part and names the attach (``kv_import``: the
        token chain, the journal, a whole block's arrays' shapes), then
        sends each other rank its part (:func:`scatter_parts`). Scheduler
        thread."""
        mine = staged["mine"]
        order = sorted(mine)
        n = self.tier_op(
            cache, lambda: cache.import_blocks(tokens, mine),
            lambda n: {
                "op": "kv_import", "ids": [int(t) for t in tokens],
                "blocks": order, "like": staged["like"],
                "dtype": "" if not order else _dtype_name(
                    mine[order[0]][3]),
            })
        if order:
            scatter_parts(self._runner, staged["parts"])
        return n

    def embed(self, batch_token_ids, true_lens):
        """An embedding batch: named to the followers (``embed``), then
        run here (``ModelRunner.embed``)."""
        self._leader.broadcast({
            "op": "embed", "ids": [[int(t) for t in r]
                                   for r in batch_token_ids],
            "lens": [int(n) for n in true_lens],
        })
        return self._runner.embed(batch_token_ids, true_lens)

    def kv_adopt(self, gather_id: int, slot) -> None:
        """The gathered hit ``gather_id`` seeds ``slot``'s prefill: every
        follower takes its own upload of the same blocks, and every rank
        checks that it held them (:func:`check_hit`)."""
        self._leader.broadcast({"op": "kv_adopt", "id": int(gather_id),
                                "slot": _slot(slot)})
        with self._tier_mu:
            tokens = self._gathers.pop(gather_id)
        check_hit(self._runner, self._tier_cache, tokens, -1)

    def prefill_with_prefix(
        self, k, v, start: int, token_ids, true_len: int,
        total_bucket: int, slot=None, prefix_block: int = 0,
    ):
        """A one-shot prefill seeded from an adopted hit: followers
        continue from their own upload of the hit's blocks."""
        self._leader.broadcast({
            "op": "prefix_prefill", "start": int(start),
            "ids": [int(t) for t in token_ids],
            "true_len": int(true_len),
            "total_bucket": int(total_bucket), "slot": _slot(slot),
            "prefix_block": int(prefix_block),
        })
        return self._runner.prefill_with_prefix(
            k, v, start, token_ids, true_len, total_bucket, slot,
            prefix_block,
        )

    def verify_step(self, state, proposals, shared: bool = False):
        """A speculative verify step: n-gram proposals ride the op as host
        ints; ``shared`` ones (a draft's, on rank 0's card) reach the
        followers in the step's own broadcast on the device."""
        self._leader.broadcast({
            "op": "verify", "P": int(proposals.shape[1]),
            "proposals": None if shared else proposals.tolist(),
        })
        return self._runner.verify_step(state, proposals, shared)

    def deactivate(self, state, slot: int):
        self._leader.broadcast({"op": "deactivate", "slot": int(slot)})
        return self._runner.deactivate(state, slot)

    def probe(self, state, what: str, ids=None, true_len: int = 0,
              slot=None):
        """A check on every rank at once (``diagnostics.probe``)."""
        self._leader.broadcast({
            "op": "probe", "what": what,
            "ids": None if ids is None else [int(t) for t in ids],
            "true_len": int(true_len), "slot": _slot(slot),
        })
        return diagnostics.probe(self._runner, state, what, ids, true_len,
                                 slot)

    # -- a draft's op: the draft runs on rank 0's card alone, through a
    # runner of its own (refused here, defensively) ----------------------

    def _unsupported(self, what: str):
        # ValueError: the API handlers answer it with a 400
        raise ValueError(
            f"{what} is not supported on a multi-GPU replica "
            f"(plan {self._runner.plan})"
        )

    def ingest_step(self, *a, **kw):
        self._unsupported("draft ingestion")


def _first_lacking(runner, missing: int):
    """One world all-gather of each rank's ``missing`` (the index of the
    first named block it lacks, -1: none): ``(rank, index)`` of the first
    rank that lacks one, or None, the same on every rank."""
    flags = runner.mesh.all_gather_world(
        torch.tensor([missing], dtype=torch.int64, device=runner.device))
    for rank, flag in enumerate(int(f) for f in torch.cat(flags).tolist()):
        if flag >= 0:
            return rank, flag
    return None


def check_hit(runner, cache, tokens, missing: int) -> None:
    """Every rank at once, before a hit seeds a prefill: ``missing`` is the
    index of the first block of ``tokens`` this rank lacks (-1: none). One
    world all-gather; if any rank lacks one, every rank raises the same
    error, naming the first such rank and the block's chain key, so no
    rank runs the prefill cold while the others run it warm."""
    lacking = _first_lacking(runner, missing)
    if lacking is not None:
        rank, flag = lacking
        key = cache.chain_keys(tokens)[flag].hex()
        raise RuntimeError(
            f"rank {rank} lacks KV block {key} (block {flag} of a "
            f"{len(tokens)}-token prefix hit the leader named); the "
            "replica's host tiers parted"
        )


def _staged(arrays, device) -> torch.Tensor:
    """``arrays`` packed into one uint8 tensor on ``device``: on the card
    through a pinned host buffer (one copy on the host, an asynchronous
    one to the card)."""
    if device.type != "cuda":
        return torch.from_numpy(pack_arrays(arrays))
    n = sum(a.nbytes for a in arrays)
    host = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    pack_arrays(arrays, out=host.numpy())
    return host.to(device, non_blocking=True)


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A received uint8 buffer on the host (through a pinned buffer on the
    card: the copy waits for the transfer that filled it)."""
    if t.device.type != "cuda":
        return t.numpy()
    host = torch.empty(t.shape, dtype=torch.uint8, pin_memory=True)
    host.copy_(t)
    return host.numpy()


def _part(runner, rank: int):
    """Rank ``rank``'s part of a host-tier block: ``(its KV heads, its
    stripe of the tokens)`` (``parallel.mesh.kv_head_range``,
    ``kv_stripe``)."""
    plan = runner.plan
    return (kv_head_range(plan, rank, runner.cfg.num_kv_heads),
            kv_stripe(plan, rank, runner.host_tier.block_tokens))


def _part_like(like, part):
    """A block's arrays' ``(dtype, shape)`` (``like``: its K, V and any
    scales, in wire order) at ``part`` (:func:`_part`): K and V cut at the
    heads and the stripe, the scales at the heads alone."""
    (h0, h1), (r0, r1) = part
    out = []
    for j, (dtype, shape) in enumerate(like):
        shape = list(shape)
        shape[2] = h1 - h0
        if j < 2:
            shape[1] = r1 - r0
        out.append((np.dtype(dtype), tuple(shape)))
    return out


def gather_parts(runner, keys, blocks, missing: int):
    """Every rank at once, for an export naming the blocks ``keys``:
    ``blocks`` are this rank's parts of them (``export_blocks``' dicts)
    and ``missing`` the index of the first it lacks (-1: none). If any
    rank lacks one, every rank raises, naming the rank and the key. Else
    each distinct part (``Mesh.part_holders``: a stripe's heads) moves
    once to rank 0 (``Mesh.gather_parts``: nothing under ``tp`` and
    ``sp`` 1), which returns the whole blocks (``join_parts``); other
    ranks return None."""
    if not keys:
        return []
    lacking = _first_lacking(runner, missing)
    if lacking is not None:
        rank, i = lacking
        raise RuntimeError(
            f"rank {rank} lacks KV block {keys[i]} (block {i} of an "
            f"export of {len(keys)} the leader named); the replica's host "
            "tiers parted"
        )
    mesh = runner.mesh
    heads = runner.cfg.num_kv_heads
    holders = mesh.part_holders(heads)
    if len(holders) == 1:
        return blocks if mesh.rank == 0 else None
    arrays = [a for b in blocks for a in _payload(b)]
    mine = _part(runner, 0)[0]
    likes = [[x for b in blocks for x in _part_like(
        [(a.dtype, a.shape) for a in _payload(b)], (mine, _part(runner,
                                                                h)[1]))]
              for h in holders]
    parts = mesh.gather_parts(
        _staged(arrays, runner.device), heads,
        [sum(int(np.prod(shape)) * dtype.itemsize for dtype, shape in like)
         for like in likes])
    if parts is None:
        return None
    unpacked = [arrays] + [unpack_arrays(_to_host(p), like)
                           for p, like in zip(parts[1:], likes[1:])]
    out, at = [], 0
    for b in blocks:
        n = len(_payload(b))
        out.append(join_parts([
            {**b, **dict(zip(_present(b), arrs[at:at + n]))}
            for arrs in unpacked], len(holders) // mesh.sp))
        at += n
    return out


def _present(blk):
    return [n for n in ("k", "v", "k_scale", "v_scale")
            if blk[n] is not None]


def _payload(blk):
    return [blk[n] for n in _present(blk)]


def scatter_parts(runner, staged=None, op=None):
    """Every rank at once, for an import: rank 0 sends each other rank its
    part of the imported blocks (``staged``, by part:
    :meth:`BroadcastingRunner.kv_import_stage`) and returns None; a
    follower receives its part as the ``kv_import`` ``op`` lays it out
    and returns the received buffer (on the host, or on the card with the
    event its copy to the host is recorded on) for
    :func:`unstage_import`."""
    mesh = runner.mesh
    if mesh.rank == 0:
        mesh.scatter_from_leader_(None, {
            r: staged[_part(runner, r)] for r in range(1, mesh.world)})
        return None
    per_block = sum(int(np.prod(shape)) * dtype.itemsize
                    for dtype, shape in _part_like(op["like"],
                                                   _part(runner, mesh.rank)))
    buf = torch.empty(per_block * len(op["blocks"]), dtype=torch.uint8,
                      device=runner.device)
    mesh.scatter_from_leader_(buf)
    if buf.device.type != "cuda":
        return buf.numpy(), None
    # to the host without waiting here: the tier's thread waits on it
    host = torch.empty(buf.shape, dtype=torch.uint8, pin_memory=True)
    host.copy_(buf, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host.numpy(), done


def unstage_import(op, flat, like) -> Dict[int, tuple]:
    """A follower's received part of a ``kv_import``'s blocks (``like``:
    a block's arrays at its part, :func:`_part_like`) as prepared blocks
    ``{b: (k, v, scales|None, dtype, nbytes)}``, each array a copy of its
    own."""
    arrays = [a.copy() for a in unpack_arrays(flat, like * len(
        op["blocks"]))]
    n = len(like)
    dtype = _dtype_from_name(op["dtype"])
    out = {}
    for i, b in enumerate(op["blocks"]):
        k, v, *scales = arrays[i * n:(i + 1) * n]
        out[b] = (k, v, tuple(scales) if scales else None, dtype,
                  sum(a.nbytes for a in arrays[i * n:(i + 1) * n]))
    return out


class FollowerTier:
    """A follower's side of the host KV tier: its own ``HostKVCache`` in
    follower mode (``follow()``), changed only as the leader's ops say, on
    the engine's kv-copy thread (one worker: the ops run in the order they
    came). A store's K/V go to the host as the engine's own stores do
    (``LLMEngine._d2h``) and wait there for the leader's journal of the
    store; a hit's blocks are gathered and uploaded as the engine uploads
    them (``LLMEngine._upload_prefix``) and taken by the ``kv_adopt`` op
    that follows."""

    def __init__(self, engine):
        self.engine = engine
        self.cache = engine.host_kv_cache
        self.cache.follow()
        self._pool = engine._kv_copy_pool
        self._staged: Dict[int, tuple] = {}      # store id -> (ids, k, v)
        # slot -> (gather id, tokens, future of (k, v, event) | lacking key)
        self._gathered: Dict[Any, tuple] = {}
        self._futures: List[Any] = []

    def _submit(self, fn):
        fut = self._pool.submit(fn)
        self._futures.append(fut)
        return fut

    def check(self) -> None:
        """Raise the first failure of the tier's finished work (a CUDA
        error: it ends the follower, as it ends the leader's engine)."""
        while self._futures and self._futures[0].done():
            self._futures.pop(0).result()

    def drain(self) -> None:
        """Wait for the tier's queued work (a check reads the tier)."""
        self._submit(lambda: None).result()
        self.check()

    @staticmethod
    def _lost(keys) -> None:
        if keys:
            logger.warning(
                "the leader's tier named %d block(s) this rank cannot "
                "apply (a hit on them will end the replica): %s",
                len(keys), ", ".join(keys[:4]),
            )

    def store(self, store_id: int, ids, k, v, total: int,
              amax=None) -> None:
        hosts, done = self.engine._d2h(k, v, total, amax)

        def _stage():
            if done is not None:
                done.synchronize()
            self._staged[store_id] = (ids, *(
                None if h is None else to_numpy(h) for h in hosts))

        self._submit(_stage)

    def commit(self, store_id: int, events) -> None:
        def _commit():
            ids, k, v, amax = self._staged.pop(store_id)
            self._lost(self.cache.replay(events, ids, k, v, amax=amax))

        self._submit(_commit)

    def gather(self, gather_id: int, ids, length: int, slot, ok: bool,
               events, upload: bool) -> None:
        def _gather_job():
            self._lost(self.cache.replay(events, ids))
            if not ok:
                return None
            got = self.cache.follower_gather(ids, length)
            if isinstance(got, str):
                return got          # the first block this rank lacks
            if not upload:
                return None         # another dp group runs the prefill
            return self.engine._upload_prefix(got[0], got[1], length)

        fut = self._submit(_gather_job)
        if ok:
            self._gathered[slot] = (gather_id, list(ids), fut)

    def export(self, keys, events):
        """This rank's parts of the blocks a leader's export names, read
        where the leader read its own: after the queued work, with the
        journal the export carried. ``(blocks, index of the first it
        lacks or -1)``."""
        def read():
            self._lost(self.cache.replay(events, ()))
            return self.cache.named_blocks(keys)

        out = self._submit(read).result()
        self.check()
        return out

    def import_(self, op, runner) -> None:
        """A leader's import: this rank's part arrives from rank 0
        (:func:`scatter_parts`, on the loop thread, in the op stream's
        order) and is attached on the kv-copy thread as the leader's
        journal says."""
        flat, done = (scatter_parts(runner, op=op) if op["blocks"]
                      else (None, None))
        like = _part_like(op["like"], _part(runner, runner.mesh.rank))

        def attach():
            if done is not None:
                done.synchronize()
            prepared = ({} if flat is None
                        else unstage_import(op, flat, like))
            self._lost(self.cache.replay(op["events"], op["ids"],
                                         prepared=prepared))

        self._submit(attach)

    def adopt(self, gather_id: int, slot, runner):
        """This rank's upload of hit ``gather_id`` for ``slot`` (``(None,
        None)`` on a rank whose ``dp`` group does not run it), after every
        rank checked that it held the blocks (:func:`check_hit`)."""
        entry = self._gathered.pop(slot, None)
        if entry is None or entry[0] != gather_id:
            raise RuntimeError(
                f"kv_adopt {gather_id} for slot {slot} names no gather "
                "this rank ran"
            )
        _, tokens, fut = entry
        got = fut.result()
        missing = -1
        if isinstance(got, str):
            missing = [k.hex() for k in self.cache.chain_keys(tokens)].index(
                got)
            got = None
        check_hit(runner, self.cache, tokens, missing)
        if got is None:
            return None, None
        job = types.SimpleNamespace()
        self.engine._adopt_prefix(job, (*got[:2], len(tokens), got[2],
                                        gather_id), slot)
        return job.k, job.v


class FollowerLoop:
    """Follower side: replay the leader's op stream on the local runner,
    in a thread of its own, until the leader closes the channel."""

    def __init__(
        self, runner, cmd_address: str, state,
        token: Optional[str] = None, tier: Optional[FollowerTier] = None,
    ):
        self.runner = runner
        self.cmd_address = cmd_address
        self.token = channel_token() if token is None else token
        # the engine's own DecodeState: a follower creates no state the
        # leader does not
        self.state = state
        self.tier = tier
        self._reg: Optional[tuple] = None    # latest (last, k, v) prefill
        # per slot: a chunk job's (last, k, v) so far, or a hit's
        # adopted prefix (None, k, v) that its first continuation takes
        self._chunk_regs: Dict[Any, tuple] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.ops_applied = 0
        self.error = ""

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self.run, name="mh-follower", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait for the loop to end; True when it has."""
        if self._thread is not None:
            self._thread.join(timeout)
            return not self._thread.is_alive()
        return True

    def _connect(self) -> socket.socket:
        host, port = self.cmd_address.rsplit(":", 1)
        deadline = time.monotonic() + _CONNECT_TIMEOUT_S
        while True:
            try:
                sock = socket.create_connection((host, int(port)), 5.0)
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                sock.sendall(f"AUTH {self.token}\n".encode())
                # an idle replica sends nothing for long stretches: poll
                # so the loop can see _stop
                sock.settimeout(2.0)
                return sock
            except OSError:
                if time.monotonic() > deadline or self._stop.is_set():
                    raise
                time.sleep(0.2)

    def run(self) -> None:
        device = getattr(self.runner, "device", None)
        if device is not None and device.type == "cuda":
            # the current device is per thread: this one replays every op
            # (NCCL's batched point-to-point ops use it)
            torch.cuda.set_device(device)
        try:
            sock = self._connect()
        except OSError as e:
            self.error = f"cannot reach the leader at {self.cmd_address}: {e}"
            logger.error("%s", self.error)
            return
        logger.info("connected to leader command channel %s",
                    self.cmd_address)
        buf = b""
        try:
            while not self._stop.is_set():
                try:
                    chunk = sock.recv(1 << 16)
                except TimeoutError:
                    continue
                if not chunk:
                    logger.info("leader command channel closed")
                    return
                buf += chunk
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    if line.strip():
                        self._apply(json.loads(line))
        except Exception as e:           # a failed op ends the replica
            self.error = f"follower op failed: {e}"
            logger.exception("command channel loop died")
            try:                         # the leader's error names it too
                sock.sendall(f"ERROR {self.error}\n".encode())
            except OSError:
                pass
        finally:
            sock.close()

    def _apply(self, op: Dict[str, Any]) -> None:
        kind = op["op"]
        r = self.runner

        def bias_of(op):
            raw = op.get("logit_bias")
            return (
                {int(k): float(v) for k, v in raw.items()} if raw else None
            )

        if self.tier is not None:
            self.tier.check()
        # the slot a prefill names (its dp group's; None: every group)
        slot = op.get("slot")
        if kind == "prefill":
            self._reg = r.prefill(op["ids"], op["true_len"], slot)
        elif kind == "prefill_with_embeds":
            # the rows arrive from rank 0 on the device
            self._reg = r.prefill_with_embeds(
                op["ids"], op["true_len"], None,
                mask_of(op["rows"], len(op["ids"])), slot)
        elif kind == "chunk_start":
            self._chunk_regs[slot] = r.prefill(op["ids"], op["true_len"],
                                               slot)
        elif kind in ("chunk_continue", "prefix_prefill"):
            assert slot in self._chunk_regs, f"{kind} before its prefix"
            _, k, v = (self._chunk_regs[slot] if kind == "chunk_continue"
                       else self._chunk_regs.pop(slot))
            out = r.prefill_with_prefix(
                k, v, op["start"], op["ids"], op["true_len"],
                op["total_bucket"], slot, op.get("prefix_block", 0),
            )
            if kind == "chunk_continue":
                self._chunk_regs[slot] = out
            else:
                self._reg = out
        elif kind == "chunk_commit":
            assert slot in self._chunk_regs, "chunk_commit before chunk_start"
            self._reg = self._chunk_regs.pop(slot)
        elif kind == "chunk_abort":
            self._chunk_regs.pop(slot, None)
        elif kind == "kv_store":
            if op["src"] == "slot":
                k, v = r.slot_kv(self.state, slot, op["width"])
            else:
                _, k, v = self._reg
            k, v, amax = r.kv_store(k, v, slot, op["total"], op)
            self.tier.store(op["id"], op["ids"], k, v, op["total"], amax)
        elif kind == "kv_commit":
            self.tier.commit(op["id"], op["events"])
        elif kind == "kv_gather":
            self.tier.gather(op["id"], op["ids"], op["len"], slot, op["ok"],
                             op["events"], upload=r._runs(slot))
        elif kind == "kv_adopt":
            k, v = self.tier.adopt(op["id"], slot, r)
            self._chunk_regs[slot] = (None, k, v)
        elif kind == "kv_export":
            gather_parts(r, op["keys"], *self.tier.export(op["keys"],
                                                         op["events"]))
        elif kind == "kv_import":
            self.tier.import_(op, r)
        elif kind == "embed":
            r.embed(op["ids"], op["lens"])
        elif kind == "verify":
            if op["proposals"] is None:      # rank 0's, on the device
                buf = torch.empty((r.max_slots, op["P"]), dtype=torch.int64,
                                  device=r.device)
                self.state, _, _ = r.verify_step(self.state, buf, True)
            else:
                self.state, _, _ = r.verify_step(self.state,
                                                 op["proposals"])
        elif kind == "sample_first":
            assert self._reg is not None, "sample_first before prefill"
            if self._reg[0] is not None:   # None: another dp group's
                r.sample_first(
                    self._reg[0], op["temperature"], op["top_k"],
                    op["top_p"], op["seed"], op["seeded"], op["position"],
                    int(op["key"]), bias_of(op),
                )
        elif kind == "insert":
            assert self._reg is not None, "insert before prefill"
            _, k, v = self._reg
            self.state = r.insert(
                self.state, k, v, op["slot"], op["true_len"],
                op["first_token"], op["temperature"], op["top_k"],
                op["top_p"], op["seed"], op["seeded"], bias_of(op),
            )
        elif kind == "decode":
            self.state, _ = r.decode_step(self.state, int(op["key"]))
        elif kind == "deactivate":
            self.state = r.deactivate(self.state, op["slot"])
        elif kind == "probe":
            if self.tier is not None:
                self.tier.drain()
            diagnostics.probe(r, self.state, op["what"], op.get("ids"),
                              op.get("true_len", 0), op.get("slot"))
        else:
            logger.warning("unknown multihost op %r", kind)
            return
        self.ops_applied += 1
