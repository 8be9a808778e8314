"""Continuous-batching engine: request queue → slots → streamed tokens.

The port of ``gpustack_tpu/engine/engine.py`` around the PyTorch
:class:`~gpustack_tpu_torch.engine.runner.ModelRunner`, with the same
overlapped scheduling (one dispatch thread that never waits on the
device, ``pipeline_depth`` steps of work in flight):

1. admit: while a slot is free and requests wait → bucketed prefill +
   insert. The first sampled token is fed on the device (a device tensor
   into ``insert``), so admission N+1 dispatches while N's sample is
   still in flight.
2. decode: one ``decode_step`` advances all active slots; sampled tokens
   are fetched ``pipeline_depth`` steps behind dispatch. A CUDA event
   recorded after each dispatch says, without blocking, whether its
   tokens are ready. When a lagged fetch reveals a slot finished, the
   steps dispatched for it meanwhile are dropped host-side and the slot
   is re-tenanted cleanly.
3. retire: EOS / max_tokens / capacity → free slot; detokenization and
   stream writes ride a dedicated worker thread in overlap mode.

``pipeline_depth=0`` is the serial reference mode (fetch + inline detok
every step); greedy outputs are identical across modes.

Not ported yet (the constructor raises ``ValueError`` when asked for
them; ROADMAP lists them): speculative decoding and draft models, host
and spill KV tiers, disaggregated kv roles, chunked prefill, embeddings,
vision inputs, profile capture and the flight recorder.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from gpustack_tpu_torch.device import resolve_device
from gpustack_tpu_torch.engine.runner import DecodeState, ModelRunner
from gpustack_tpu_torch.engine.sampling import MAX_BIAS
from gpustack_tpu_torch.engine.tokenizer import load_tokenizer
from gpustack_tpu_torch.models.config import ModelConfig

logger = logging.getLogger(__name__)

# default decode-fetch pipeline depth (0 = serial mode)
_FETCH_LAG = 2

# sync-in-dispatch contract (as in the JAX engine): these functions form
# the scheduler dispatch path and must never block on the device — no
# .item() / .tolist() / .cpu() / synchronize inside them. Host syncs
# belong in _process_fetch and _drain_pending.
DISPATCH_SYNC_FREE = (
    "_loop", "step", "_admit", "_start_request", "_finalize_start",
    "_new_slot_info", "_decode_once", "_deliver", "_emit_text", "_push",
    "_finish", "_entry_ready", "_drain_ready", "_flush_detok",
    "_step_key", "_record_event",
)

# guarded-by contract: lock-guarded shared state, plus the scheduler
# thread's single-owner state (only these methods, all on the scheduler
# thread, may touch the attribute).
_SCHEDULER_METHODS = (
    "step", "_loop", "_admit", "_decode_once", "_fail_all_requests",
    "_finalize_start", "_finalize_start_sync", "_finish", "_process_fetch",
    "_drain_pending", "_drain_ready", "_start_request", "_deliver",
    "_flush_detok", "_new_slot_info", "_emit_text", "_push",
    "_entry_ready", "_step_key",
)

GUARDED_BY = {
    "_slots": _SCHEDULER_METHODS,
    "_free": _SCHEDULER_METHODS,
    "_pending": _SCHEDULER_METHODS,
    "_detok_batch": _SCHEDULER_METHODS,
    "_state": _SCHEDULER_METHODS,
    "_gen": _SCHEDULER_METHODS,
}

# thread-boundary contract: the HTTP layer reaches the engine only through
# submit()/health() and the thread-safe queues.
THREAD_OWNED = ("_slots", "_free", "_pending", "_detok_batch", "_state")


class LatencyHistogram:
    """Fixed-bucket Prometheus-style histogram (per-bucket tallies)."""

    def __init__(self, buckets):
        self.buckets = tuple(buckets)       # upper bounds, seconds
        self.counts = [0] * (len(self.buckets) + 1)   # +Inf tail
        self.total = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        # bucket BEFORE count: snapshot() reads count first, so a racing
        # reader never sees count > the +Inf bucket
        self.total += value
        for i, ub in enumerate(self.buckets):
            if value <= ub:
                self.counts[i] += 1
                break
        else:
            self.counts[-1] += 1
        self.count += 1

    def snapshot(self):
        """[(le, cumulative_count)], sum, count."""
        count = self.count
        cum, out = 0, []
        for ub, c in zip(self.buckets, self.counts):
            cum += c
            out.append((ub, cum))
        inf = cum + self.counts[-1]
        out.append((float("inf"), inf))
        return out, self.total, min(count, inf)


TTFT_BUCKETS_S = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)
TPOT_BUCKETS_S = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5)
E2E_BUCKETS_S = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)


@dataclasses.dataclass
class GenRequest:
    """One generation request (already tokenized)."""

    prompt_ids: List[int]
    max_tokens: int = 128
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: Optional[int] = None             # OpenAI 'seed': deterministic replay
    logit_bias: Optional[Dict[int, float]] = None   # token id -> bias
    stop_ids: Tuple[int, ...] = ()
    stop_texts: Tuple[str, ...] = ()       # OpenAI 'stop' strings
    logprobs: bool = False                 # collect per-token logprobs
    top_logprobs: int = 0                  # alternatives per position (<= 20)
    json_mode: bool = False                # stop after one complete JSON value
    stream: Optional[queue.Queue] = None   # receives (token_id, text_piece)
    request_id: str = ""

    # filled by the engine
    output_ids: List[int] = dataclasses.field(default_factory=list)
    output_text: str = ""                  # stop-truncated decoded text
    output_logprobs: List[float] = dataclasses.field(default_factory=list)
    output_top_logprobs: List[List[Tuple[int, float]]] = dataclasses.field(
        default_factory=list
    )
    finish_reason: str = ""
    done: threading.Event = dataclasses.field(default_factory=threading.Event)
    # client gone: the engine stops generating at its next delivery
    aborted: threading.Event = dataclasses.field(
        default_factory=threading.Event
    )
    submitted_at: float = 0.0
    first_token_at: float = 0.0
    finished_at: float = 0.0

    def abort(self) -> None:
        self.aborted.set()

    @property
    def ttft_ms(self) -> float:
        return (self.first_token_at - self.submitted_at) * 1e3


@dataclasses.dataclass
class _SlotInfo:
    request: GenRequest
    # incremental detokenization: undecoded ids buffer until they decode
    # cleanly (no dangling multibyte sequence), then text accumulates
    buffer_ids: List[int] = dataclasses.field(default_factory=list)
    text: str = ""            # decoded text (post stop-truncation)
    emitted: int = 0          # chars of ``text`` already streamed
    json_scan: Optional[Any] = None
    json_scanned: int = 0
    # True: the scheduler detokenizes inline (serial mode, stop strings,
    # JSON mode). False: the detok worker owns buffer_ids/text/emitted.
    sync_detok: bool = True


class _DetokWorker:
    """Dedicated detokenization + stream-write thread (overlap mode). The
    scheduler hands accepted token ids over a bounded FIFO queue, one
    coalesced ``("batch", [(info, toks), ...])`` entry per drained fetch;
    a ``("finish", info)`` item flushes the tail and sets ``done``."""

    _STOP = object()

    def __init__(self, engine: "LLMEngine", maxsize: int = 4096):
        self._engine = engine
        self._q: "queue.Queue" = queue.Queue(maxsize=maxsize)
        self._thread: Optional[threading.Thread] = None

    def _ensure_thread(self) -> None:
        # lazy, scheduler-thread-only callers: no start race
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="llm-detok", daemon=True
            )
            self._thread.start()

    def put_batch(self, items: List[Tuple["_SlotInfo", List[int]]]) -> None:
        self._ensure_thread()
        self._q.put(("batch", items))

    def finish(self, info: "_SlotInfo") -> None:
        self._ensure_thread()
        self._q.put(("finish", info))

    def stop(self, timeout: float = 10.0) -> None:
        if self._thread is None:
            return
        self._q.put(self._STOP)
        self._thread.join(timeout=timeout)

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is self._STOP:
                return
            kind, payload = item
            if kind == "finish":
                self._finish_one(payload)
            else:
                for info, toks in payload:
                    self._tokens_one(info, toks)

    def _tokens_one(self, info: "_SlotInfo", toks: List[int]) -> None:
        try:
            info.buffer_ids.extend(toks)
            self._engine._emit_text(info, final=False)
        except Exception:
            # a tokenizer fault fails ONE request loudly, never its batch
            logger.exception("detok worker item failed")
            self._fail_request(info)

    def _finish_one(self, info: "_SlotInfo") -> None:
        try:
            req = info.request
            self._engine._emit_text(info, final=True)
            req.output_text = info.text
            if req.stream is not None:
                req.stream.put(None)
            req.done.set()
        except Exception:
            logger.exception("detok worker finish failed")
            self._fail_request(info)

    @staticmethod
    def _fail_request(info: "_SlotInfo") -> None:
        req = info.request
        if not req.done.is_set():
            req.finish_reason = req.finish_reason or "error"
            req.output_text = info.text
            if req.stream is not None:
                req.stream.put(None)
            req.done.set()


class LLMEngine:
    """Single-device continuous-batching LLM engine."""

    def __init__(
        self,
        cfg: ModelConfig,
        params: Dict[str, Any],
        *,
        tokenizer=None,
        model_dir: Optional[str] = None,
        max_slots: int = 8,
        max_seq_len: int = 1024,
        seed: int = 0,
        pipeline_depth: int = _FETCH_LAG,  # 0 = serial reference mode
        device=None,
        speculative: str = "",
        draft_cfg=None,
        draft_params=None,
        host_kv_cache_mb: int = 0,
        kv_cache_int8: bool = False,
        prefill_chunk: int = 0,
        kv_role: str = "",
        kv_spill_mb: int = 0,
        kv_spill_dir: str = "",
    ):
        not_ported = {
            "speculative decoding": bool(speculative),
            "draft models": draft_cfg is not None or draft_params is not None,
            "host KV cache": host_kv_cache_mb > 0 or kv_cache_int8,
            "chunked prefill": prefill_chunk > 0,
            "kv roles": bool(kv_role),
            "disk KV spill": kv_spill_mb > 0 or bool(kv_spill_dir),
        }
        asked = [name for name, on in not_ported.items() if on]
        if asked:
            raise ValueError(
                f"not ported to the PyTorch engine yet: {', '.join(asked)}"
            )
        self.cfg = cfg
        self.device = resolve_device(device)
        self.tokenizer = tokenizer or load_tokenizer(model_dir)
        self.runner = ModelRunner(
            cfg, params, self.device,
            max_slots=max_slots, max_seq_len=max_seq_len,
        )
        self.max_slots = max_slots
        self.max_seq_len = max_seq_len
        self._state: DecodeState = self.runner.new_state()
        self._slots: Dict[int, _SlotInfo] = {}
        self._free = list(range(max_slots))
        self._waiting: "queue.Queue[GenRequest]" = queue.Queue()
        # step keys for the sampler's noise come from this seeded host
        # generator (drawing one never touches the device)
        self._gen = torch.Generator()
        self._gen.manual_seed(seed)
        # entries: ((kind, payload), owners {slot: request_id}, event)
        self._pending: List[Tuple[Any, Dict[int, str], Any]] = []
        self.pipeline_depth = max(0, min(int(pipeline_depth), 16))
        self.overlap = self.pipeline_depth > 0
        self._running = False
        self._fatal = ""            # set when the scheduling loop dies
        self._thread: Optional[threading.Thread] = None
        self._wake = threading.Condition()
        self._detok = _DetokWorker(self)
        self._detok_batch: List[Tuple[_SlotInfo, List[int]]] = []
        self._id_counter = itertools.count()
        self._step_count = 0
        self._tokens_generated = 0
        self._prompt_tokens = 0
        self._rollback_tokens = 0
        self.ttft_hist = LatencyHistogram(TTFT_BUCKETS_S)
        self.tpot_hist = LatencyHistogram(TPOT_BUCKETS_S)
        self.e2e_hist = LatencyHistogram(E2E_BUCKETS_S)

    # ---- public API -----------------------------------------------------

    def submit(self, req: GenRequest) -> GenRequest:
        if self._fatal:
            raise ValueError(f"engine is down: {self._fatal}")
        if not req.request_id:
            req.request_id = f"req-{next(self._id_counter)}"
        req.submitted_at = time.time()
        if req.logit_bias:
            if len(req.logit_bias) > MAX_BIAS:
                raise ValueError(
                    f"logit_bias supports at most {MAX_BIAS} entries "
                    f"(got {len(req.logit_bias)})"
                )
            bad = [
                t for t in req.logit_bias
                if not 0 <= int(t) < self.cfg.vocab_size
            ]
            if bad:
                raise ValueError(
                    f"logit_bias token ids out of range: {bad[:5]}"
                )
        if not req.prompt_ids:
            raise ValueError("empty prompt")
        if len(req.prompt_ids) >= self.max_seq_len:
            raise ValueError(
                f"prompt of {len(req.prompt_ids)} tokens >= max_seq_len "
                f"{self.max_seq_len}"
            )
        # enqueue + notify under one lock: no lost wakeup
        with self._wake:
            self._waiting.put(req)
            self._wake.notify_all()
        return req

    def generate(self, req: GenRequest, timeout: float = 300.0) -> GenRequest:
        """Blocking helper: submit and wait for completion."""
        self.submit(req)
        if not req.done.wait(timeout):
            raise TimeoutError(f"request {req.request_id} timed out")
        return req

    def start(self) -> None:
        self._running = True
        self._thread = threading.Thread(
            target=self._loop, name="llm-engine", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        with self._wake:
            self._wake.notify_all()
        if self._thread:
            self._thread.join(timeout=30)
        self._detok.stop()

    def health(self) -> Dict[str, Any]:
        return {
            "status": "error" if self._fatal else "ok",
            "error": self._fatal,
            "model": self.cfg.name,
            "device": str(self.device),
            "slots_total": self.max_slots,
            # racy-tolerated gauge read from the HTTP thread
            "slots_used": self.max_slots - len(self._free),  # analysis: ignore[guarded-by]
            "waiting": self._waiting.qsize(),
            "steps": self._step_count,
            "tokens_generated": self._tokens_generated,
            "prompt_tokens": self._prompt_tokens,
            "pipeline_depth": self.pipeline_depth,
            "overlap": self.overlap,
            "pipeline_rollback_tokens": self._rollback_tokens,
        }

    # ---- scheduling loop ------------------------------------------------

    def _loop(self) -> None:
        while self._running:
            try:
                busy = self.step()
            except Exception as e:
                # a dead scheduling thread is LOUD and terminal: fail every
                # request and flip health
                logger.exception("engine scheduling loop died")
                self._fatal = f"engine loop died: {e}"
                self._fail_all_requests(str(e))
                return
            if not busy:
                with self._wake:
                    if self._running and self._waiting.empty():
                        self._wake.wait(timeout=0.05)

    def _flush_detok(self) -> None:
        """Hand the accumulated (info, tokens) pairs to the detok worker
        as ONE queue entry."""
        if self._detok_batch:
            batch, self._detok_batch = self._detok_batch, []
            self._detok.put_batch(batch)

    def _fail_all_requests(self, message: str) -> None:
        self._flush_detok()
        for info in list(self._slots.values()):
            req = info.request
            req.finish_reason = "error"
            if info.sync_detok:
                req.output_text = info.text
                if req.stream is not None:
                    req.stream.put(None)
                req.done.set()
            else:
                self._detok.finish(info)
        self._slots.clear()
        while not self._waiting.empty():
            try:
                req = self._waiting.get_nowait()
            except queue.Empty:
                break
            req.finish_reason = "error"
            if req.stream is not None:
                req.stream.put(None)
            req.done.set()

    def step(self) -> bool:
        """One scheduling iteration. Returns False when fully idle."""
        # fetch whatever the device already finished (non-blocking probe)
        # so a slot whose request ended re-tenants THIS step
        self._drain_ready()
        admitted = self._admit()
        if self._slots:
            self._decode_once()
            return True
        if admitted:
            return True
        self._drain_pending()
        return not self._waiting.empty()

    def _admit(self) -> bool:
        admitted = False
        while self._free and not self._waiting.empty():
            try:
                req = self._waiting.get_nowait()
            except queue.Empty:
                break
            if req.aborted.is_set():
                self._finish_aborted(req)
                continue
            slot = self._free.pop(0)
            self._start_request(slot, req)
            admitted = True
        return admitted

    @staticmethod
    def _finish_aborted(req: GenRequest) -> None:
        req.finish_reason = "abort"
        req.finished_at = time.time()
        if req.stream is not None:
            req.stream.put(None)
        req.done.set()

    def _start_request(self, slot: int, req: GenRequest) -> None:
        ids = req.prompt_ids
        bucket = self.runner.bucket_for(max(1, len(ids)))
        padded = list(ids) + [0] * (bucket - len(ids))
        self._prompt_tokens += len(ids)
        last_logits, k, v = self.runner.prefill(padded, len(ids))
        self._finalize_start(slot, req, last_logits, k, v)

    def _step_key(self) -> int:
        return int(torch.randint(0, 2**62, (1,), generator=self._gen))

    def _new_slot_info(self, req: GenRequest) -> _SlotInfo:
        info = _SlotInfo(request=req)
        # stop strings and JSON mode decide WHICH tokens count from decoded
        # text, so their detok stays inline on the scheduler
        info.sync_detok = (
            not self.overlap or bool(req.stop_texts) or req.json_mode
        )
        if req.json_mode:
            from gpustack_tpu_torch.engine.openai_tools import JsonScanner

            info.json_scan = JsonScanner()
        return info

    def _record_event(self):
        """A CUDA event after the work just dispatched (None on the CPU,
        where every op has finished when it returns)."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev

    def _finalize_start(
        self, slot: int, req: GenRequest, last_logits, k, v
    ) -> None:
        """Insert a finished prefill into the decode state and feed the
        first sampled token. Overlap mode: the token never touches the
        host here — ``insert`` consumes it as a device tensor and the
        host learns it through the fetch pipeline. Logprobs requests take
        the synchronous path."""
        ids = req.prompt_ids
        # decode samples token 2 at position len(ids); the first token
        # uses len(ids)-1 so every seeded draw's stream is distinct
        seed = 0 if req.seed is None else int(req.seed) & 0xFFFFFFFF
        toks, tok_lp, top_ids, top_lps = self.runner.sample_first(
            last_logits, req.temperature, req.top_k, req.top_p,
            seed, req.seed is not None, len(ids) - 1, self._step_key(),
            logit_bias=req.logit_bias,
        )
        if self.overlap and not req.logprobs:
            self._state = self.runner.insert(
                self._state, k, v, slot, len(ids), toks[0],
                req.temperature, req.top_k, req.top_p,
                seed, req.seed is not None, req.logit_bias,
            )
            self._slots[slot] = self._new_slot_info(req)
            self._pending.append(
                (("first", toks), {slot: req.request_id},
                 self._record_event())
            )
            return
        self._finalize_start_sync(
            slot, req, k, v, seed, toks, tok_lp, top_ids, top_lps
        )

    def _finalize_start_sync(
        self, slot, req, k, v, seed, toks, tok_lp, top_ids, top_lps
    ) -> None:
        """Synchronous first-token path (serial mode, logprobs): reads the
        sampled token to the host before insert — a designated sync."""
        ids = req.prompt_ids
        first = int(toks[0])
        first_lps = None
        if req.logprobs:
            first_lps = [(
                float(tok_lp[0]),
                list(zip(top_ids[0].tolist(), top_lps[0].tolist())),
            )]
        self._state = self.runner.insert(
            self._state, k, v, slot, len(ids), first,
            req.temperature, req.top_k, req.top_p,
            seed, req.seed is not None, req.logit_bias,
        )
        info = self._new_slot_info(req)
        self._slots[slot] = info
        self._deliver(slot, info, [first], first_lps)
        self._flush_detok()

    def _decode_once(self) -> None:
        # snapshot slot ownership at dispatch time: a lagged fetch drops
        # tokens of a slot that was retired and re-used since
        owners = {
            s: info.request.request_id for s, info in self._slots.items()
        }
        if not owners:
            return
        self._state, out = self.runner.decode_step(
            self._state, self._step_key()
        )
        self._pending.append((("decode", out), owners, self._record_event()))
        self._step_count += 1
        if len(self._pending) > self.pipeline_depth:
            self._process_fetch(*self._pending.pop(0))

    @staticmethod
    def _entry_ready(entry) -> bool:
        """Non-blocking: has the device finished this entry's tokens?"""
        event = entry[2]
        return True if event is None else bool(event.query())

    def _drain_ready(self) -> None:
        while self._pending and self._entry_ready(self._pending[0]):
            self._process_fetch(*self._pending.pop(0))

    def _drain_pending(self) -> None:
        while self._pending:
            self._process_fetch(*self._pending.pop(0))

    def _process_fetch(self, out, owners: Dict[int, str], event) -> None:
        kind, payload = out
        if kind == "first":
            ((slot, owner_id),) = owners.items()
            info = self._slots.get(slot)
            if info is None or info.request.request_id != owner_id:
                self._rollback_tokens += 1
                return
            self._deliver(slot, info, [int(payload[0])])
            self._flush_detok()
            return
        tokens, tok_lp, top_ids, top_lps = payload
        tok_arr = tokens.tolist()              # sync point (lagged)
        want_lps = any(
            (info := self._slots.get(s)) is not None
            and info.request.logprobs for s in owners
        )
        if want_lps:
            lp_arr = tok_lp.tolist()
            top_ids_arr = top_ids.tolist()
            top_lps_arr = top_lps.tolist()
        for slot, owner_id in owners.items():
            info = self._slots.get(slot)
            if info is None or info.request.request_id != owner_id:
                # this step was dispatched before a lagged fetch ended (or
                # re-tenanted) the slot: its token never existed
                self._rollback_tokens += 1
                continue
            lps = None
            if want_lps and info.request.logprobs:
                lps = [(
                    lp_arr[slot],
                    list(zip(top_ids_arr[slot], top_lps_arr[slot])),
                )]
            self._deliver(slot, info, [tok_arr[slot]], lps)
        self._flush_detok()

    def _deliver(
        self, slot: int, info: _SlotInfo, toks: List[int], lps=None
    ) -> None:
        """Deliver newly generated tokens (``lps``: aligned list of
        (token_logprob, [(id, logprob)])). Termination is decided here at
        the id level; detokenization runs inline or on the detok worker."""
        req = info.request
        if req.aborted.is_set():
            self._finish(slot, info, "abort")
            return
        if not req.first_token_at:
            req.first_token_at = time.time()
        offload: List[int] = []
        for j, tok in enumerate(toks):
            is_eos = tok in self.tokenizer.eos_ids or tok in req.stop_ids
            if not is_eos:
                req.output_ids.append(tok)
                if lps is not None and j < len(lps):
                    req.output_logprobs.append(lps[j][0])
                    req.output_top_logprobs.append(lps[j][1])
                self._tokens_generated += 1
                if info.sync_detok:
                    info.buffer_ids.append(tok)
                    if self._emit_text(info, final=False):
                        self._finish(slot, info, "stop")
                        return
                else:
                    offload.append(tok)
            at_cap = (
                len(req.prompt_ids) + len(req.output_ids)
                >= self.max_seq_len - 1
            )
            if is_eos or at_cap or len(req.output_ids) >= req.max_tokens:
                if offload:
                    self._detok_batch.append((info, offload))
                self._finish(slot, info, "stop" if is_eos else "length")
                return
        if offload:
            self._detok_batch.append((info, offload))

    def _emit_text(self, info: _SlotInfo, final: bool) -> bool:
        """Advance incremental detokenization; stream newly-safe text.
        Returns True when a stop string or the end of a JSON value matched
        (text already truncated and flushed)."""
        req = info.request
        if info.buffer_ids:
            piece = self.tokenizer.decode(info.buffer_ids)
            if final or not piece.endswith("�"):
                info.text += piece
                info.buffer_ids.clear()
        if info.json_scan is not None and len(info.text) > info.json_scanned:
            rel = info.json_scan.feed(info.text[info.json_scanned:])
            if rel != -1:
                info.text = info.text[: info.json_scanned + rel]
                self._push(info, info.text[info.emitted:])
                return True
            info.json_scanned = len(info.text)
        unemitted = info.text[info.emitted:]
        for s in req.stop_texts:
            idx = unemitted.find(s)
            if idx != -1:
                info.text = info.text[: info.emitted + idx]
                self._push(info, info.text[info.emitted:])
                return True
        hold = 0
        if not final:
            for s in req.stop_texts:
                for k in range(min(len(s) - 1, len(unemitted)), 0, -1):
                    if unemitted.endswith(s[:k]):
                        hold = max(hold, k)
                        break
        self._push(
            info, unemitted[: len(unemitted) - hold] if hold else unemitted
        )
        return False

    def _push(self, info: _SlotInfo, piece: str) -> None:
        if not piece:
            return
        info.emitted += len(piece)
        req = info.request
        if req.stream is not None:
            last = req.output_ids[-1] if req.output_ids else 0
            req.stream.put((last, piece))

    def _finish(self, slot: int, info: _SlotInfo, reason: str) -> None:
        req = info.request
        if info.sync_detok:
            if self._emit_text(info, final=True):
                reason = "stop"
            req.output_text = info.text
        req.finish_reason = reason
        req.finished_at = time.time()
        if req.first_token_at and req.submitted_at:
            self.ttft_hist.observe(req.first_token_at - req.submitted_at)
            self.e2e_hist.observe(req.finished_at - req.submitted_at)
            if len(req.output_ids) > 1:
                self.tpot_hist.observe(
                    (req.finished_at - req.first_token_at)
                    / (len(req.output_ids) - 1)
                )
        self._state = self.runner.deactivate(self._state, slot)
        del self._slots[slot]
        self._free.append(slot)
        if info.sync_detok:
            if req.stream is not None:
                req.stream.put(None)
            req.done.set()
        else:
            # flush FIRST so this request's last tokens precede its finish
            self._flush_detok()
            self._detok.finish(info)
