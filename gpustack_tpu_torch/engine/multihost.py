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
- features whose host state would part across ranks are refused at build
  (``api_server.build_engine_from_args``: the host KV tier, speculation,
  the vision path, ``--kv-role``) and here, defensively (embeddings and
  rerank answer 400 naming the plan).

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
from typing import Any, Dict, List, Optional

import torch

from gpustack_tpu_torch.engine import diagnostics

logger = logging.getLogger(__name__)

_CONNECT_TIMEOUT_S = 600.0   # followers may still be loading weights


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
        """A follower sends nothing after its handshake: end of stream or
        an error on its socket means it is gone."""
        try:
            while conn.recv(256):
                pass
        except OSError:
            pass
        if not self._closing:
            self.error = f"follower at {addr[0]}:{addr[1]} disconnected"
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
        total_bucket: int, slot=None,
    ):
        self._leader.broadcast({
            "op": "chunk_continue",
            "start": int(start),
            "ids": [int(t) for t in token_ids],
            "true_len": int(true_len),
            "total_bucket": int(total_bucket), "slot": _slot(slot),
        })
        return self._runner.prefill_with_prefix(
            k, v, start, token_ids, true_len, total_bucket, slot
        )

    def chunk_commit(self) -> None:
        """A completed chunk job: followers promote the chunk register to
        the insert register."""
        self._leader.broadcast({"op": "chunk_commit"})

    def chunk_abort(self) -> None:
        """An abandoned chunk job: followers drop the chunk register."""
        self._leader.broadcast({"op": "chunk_abort"})

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

    # -- single-process features (refused at build; here defensively) ----

    def _unsupported(self, what: str):
        # ValueError: the API handlers answer it with a 400
        raise ValueError(
            f"{what} is not supported on a multi-GPU replica "
            f"(plan {self._runner.plan})"
        )

    def prefill_with_prefix(self, *a, **kw):
        self._unsupported("prefix-cache prefill")

    def prefill_with_embeds(self, *a, **kw):
        self._unsupported("vision-token prefill")

    def verify_step(self, *a, **kw):
        self._unsupported("speculative decoding")

    def ingest_step(self, *a, **kw):
        self._unsupported("draft ingestion")

    def embed(self, *a, **kw):
        self._unsupported("embeddings")


class FollowerLoop:
    """Follower side: replay the leader's op stream on the local runner,
    in a thread of its own, until the leader closes the channel."""

    def __init__(
        self, runner, cmd_address: str, state,
        token: Optional[str] = None,
    ):
        self.runner = runner
        self.cmd_address = cmd_address
        self.token = channel_token() if token is None else token
        # the engine's own DecodeState: a follower creates no state the
        # leader does not
        self.state = state
        self._reg: Optional[tuple] = None    # latest (last, k, v) prefill
        self._chunk_reg: Optional[tuple] = None
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

        # the slot a prefill names (its dp group's; None: every group)
        slot = op.get("slot")
        if kind == "prefill":
            self._reg = r.prefill(op["ids"], op["true_len"], slot)
        elif kind == "chunk_start":
            self._chunk_reg = r.prefill(op["ids"], op["true_len"], slot)
        elif kind == "chunk_continue":
            assert self._chunk_reg is not None, (
                "chunk_continue before chunk_start"
            )
            _, k, v = self._chunk_reg
            self._chunk_reg = r.prefill_with_prefix(
                k, v, op["start"], op["ids"], op["true_len"],
                op["total_bucket"], slot,
            )
        elif kind == "chunk_commit":
            assert self._chunk_reg is not None, (
                "chunk_commit before chunk_start"
            )
            self._reg = self._chunk_reg
            self._chunk_reg = None
        elif kind == "chunk_abort":
            self._chunk_reg = None
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
            diagnostics.probe(r, self.state, op["what"], op.get("ids"),
                              op.get("true_len", 0), op.get("slot"))
        else:
            logger.warning("unknown multihost op %r", kind)
            return
        self.ops_applied += 1
