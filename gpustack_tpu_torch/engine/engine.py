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

The prompt path, as in the JAX engine:

- **chunked prefill** (``prefill_chunk``): a prompt longer than the chunk
  is prefilled one chunk per scheduler step, each chunk a continuation
  (``runner.prefill_with_prefix``) of the ones before, with a decode step
  for the running slots between chunks;
- **host KV cache** (``host_kv_cache_mb``, ``kv_block_tokens``,
  ``kv_cache_int8``; ``kv_host_cache.py``) with an optional **disk spill
  tier** (``kv_spill_mb``, ``kv_spill_dir``; ``kv_spill.py``): every
  prefill, and every cleanly finished sequence (prompt + generated
  tokens), is copied to host RAM in blocks; a later prompt sharing a block
  run uploads it and prefills only its suffix.

KV moves between the card and the host off the scheduler thread. A
device→host store is enqueued on a side stream that waits for the work
that produced the K/V, into pinned buffers, with ``record_stream`` on the
source so the caching allocator cannot hand its memory to the next
prefill before the copy read it; the kv-copy thread waits on the copy's
event and inserts the blocks. A host→device prefix upload runs on that
thread too (a pinned, bucket-padded buffer copied on a second side
stream); the scheduler makes its stream wait on the upload's event and
records the uploaded tensors on its stream before the continuation
prefill. A failure in either (a CUDA error) ends the engine like a failed
decode step; a block run evicted between probe and gather cold-starts.

**Speculative decoding** (``speculative``, greedy only, as in the JAX
engine): each decode step becomes a verify step (``runner.verify_step``)
over ``spec_tokens`` positions per slot, fed with proposals from an
incremental 2-gram index of each slot's context (``"ngram"``), or from a
draft model's own decode state (``"draft"``: delivered tokens are
block-ingested into the draft's cache, it proposes ``spec_tokens - 1``
greedy tokens, and its positions are rewound). Output is identical to
plain greedy decoding; near the cache end the step falls back to plain
decode.

**Embeddings** (``embed``): a batch is handed to the scheduler thread as
a job and runs there as one forward, so every forward on the card is
launched by one thread.

**Profile capture** (``capture_profile``): ``torch.profiler`` wraps the
next N busy scheduler steps (started and stopped on the scheduler
thread) and writes a Chrome trace; the steps' flight records come back
with it.

The flight recorder (``observability/flight.py``) keeps one record per
scheduler step (modes ``prefill``, ``prefill_chunk``, ``decode``,
``spec_verify``, ``embed``).

Not ported yet (the constructor raises ``ValueError`` when asked for
them; ROADMAP lists them): disaggregated kv roles (and the ``/kv/*``
handoff) and vision inputs.
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import itertools
import logging
import os
import queue
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from gpustack_tpu_torch.device import resolve_device
from gpustack_tpu_torch.engine.host_bf16 import from_numpy, to_numpy
from gpustack_tpu_torch.engine.runner import DecodeState, ModelRunner
from gpustack_tpu_torch.engine.sampling import MAX_BIAS
from gpustack_tpu_torch.engine.tokenizer import load_tokenizer
from gpustack_tpu_torch.models.config import ModelConfig
from gpustack_tpu_torch.models.transformer import torch_dtype
from gpustack_tpu_torch.observability.flight import (
    FlightRecorder,
    aggregate_records,
)

logger = logging.getLogger(__name__)

# default decode-fetch pipeline depth (0 = serial mode)
_FETCH_LAG = 2
# a capture whose steps did not all come stops at the scheduler's next
# iteration; the capture thread waits this long for it
PROFILE_STOP_WAIT_S = 30.0
# the Chrome trace's file name under a capture's out_dir
PROFILE_TRACE_FILE = "trace.json"

# sync-in-dispatch contract (as in the JAX engine): these functions form
# the scheduler dispatch path and must never block on the device — no
# .item() / .tolist() / .cpu() / synchronize inside them. Host syncs
# belong in _process_fetch, _drain_pending and the designated KV waits
# (_resolve_staged_prefix, _upload_prefix), or off-thread.
DISPATCH_SYNC_FREE = (
    "_loop", "step", "_admit", "_start_request", "_finalize_start",
    "_new_slot_info", "_plan_chunk_job", "_advance_chunk",
    "_advance_one_shot", "_decode_once", "_deliver", "_emit_text",
    "_push", "_finish", "_flight_record", "_submit_kv_copy",
    "_store_finished_sequence", "_check_kv_copies", "_entry_ready",
    "_drain_ready", "_flush_detok", "_step_key", "_record_event",
    "_note_spec_dispatch", "_spec_safe", "_build_proposals",
    "_draft_propose", "_run_embed_job",
)

# guarded-by contract: lock-guarded shared state, plus the scheduler
# thread's single-owner state (only these methods, all on the scheduler
# thread, may touch the attribute).
_SCHEDULER_METHODS = (
    "step", "_loop", "_admit", "_advance_chunk", "_advance_one_shot",
    "_decode_once", "_fail_all_requests", "_finalize_start",
    "_finalize_start_sync", "_finish", "_flight_record", "_process_fetch",
    "_drain_pending", "_drain_ready", "_start_request", "_deliver",
    "_flush_detok", "_store_finished_sequence", "_resolve_staged_prefix",
    "_plan_chunk_job", "_new_slot_info", "_emit_text", "_push",
    "_entry_ready", "_step_key", "_submit_kv_copy", "_check_kv_copies",
    "_note_spec_dispatch", "_spec_safe", "_build_proposals",
    "_draft_propose", "_run_embed_job", "_profile_step", "_profile_poll",
)

GUARDED_BY = {
    "_overlap_s": "_overlap_mu",
    "_profile": "_profile_mu",
    "_KVStager._inflight": "_mu",
    "_slots": _SCHEDULER_METHODS,
    "_free": _SCHEDULER_METHODS,
    "_pending": _SCHEDULER_METHODS,
    "_chunk_jobs": _SCHEDULER_METHODS,
    "_kv_copies": _SCHEDULER_METHODS,
    "_detok_batch": _SCHEDULER_METHODS,
    "_overlap_seen": _SCHEDULER_METHODS,
    "_state": _SCHEDULER_METHODS,
    "_draft_state": _SCHEDULER_METHODS,
    "_gen": _SCHEDULER_METHODS,
}

# thread-boundary contract: the HTTP layer reaches the engine only through
# submit()/health() and the thread-safe queues.
THREAD_OWNED = (
    "_slots", "_free", "_pending", "_chunk_jobs", "_detok_batch", "_state",
    "_draft_state",
)


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


def _ngram_propose(ctx: List[int], k: int, n: int = 2) -> List[int]:
    """Up to ``k`` continuation tokens: find the latest earlier occurrence
    of the context's final n-gram and replay what followed. The O(len)
    reference; the engine uses the incremental :class:`_NgramIndex`."""
    if k <= 0 or len(ctx) < n + 1:
        return []
    key = tuple(ctx[-n:])
    for i in range(len(ctx) - n - 1, -1, -1):
        if tuple(ctx[i : i + n]) == key:
            return list(ctx[i + n : i + n + k])
    return []


class _NgramIndex:
    """Incremental 2-gram index: O(1) proposal lookup per decode step.

    ``prev[g]`` is the end index of the latest occurrence of 2-gram ``g``
    before its most recent one: what the proposer needs, since the most
    recent occurrence of the context's final 2-gram is the tail itself."""

    def __init__(self, ctx: List[int], n: int = 2):
        self.n = n
        self.ctx = list(ctx)
        self.cur: Dict[tuple, int] = {}
        self.prev: Dict[tuple, int] = {}
        for end in range(n, len(self.ctx) + 1):
            self._register(tuple(self.ctx[end - n : end]), end)

    def _register(self, gram: tuple, end: int) -> None:
        if gram in self.cur:
            self.prev[gram] = self.cur[gram]
        self.cur[gram] = end

    def append(self, token: int) -> None:
        self.ctx.append(token)
        if len(self.ctx) >= self.n:
            self._register(tuple(self.ctx[-self.n:]), len(self.ctx))

    def propose(self, k: int) -> List[int]:
        if k <= 0 or len(self.ctx) < self.n + 1:
            return []
        end = self.prev.get(tuple(self.ctx[-self.n:]))
        if end is None:
            return []
        return self.ctx[end : end + k]


def _torch_profiler():
    """``torch.profiler``, or None where this torch build has none."""
    return getattr(torch, "profiler", None)


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
    # prefix reuse: prompt tokens whose prefill a host KV cache hit
    # skipped, and the seconds spent uploading them to the device
    prefix_tokens_reused: int = 0
    kv_upload_s: float = 0.0

    def abort(self) -> None:
        self.aborted.set()

    @property
    def ttft_ms(self) -> float:
        return (self.first_token_at - self.submitted_at) * 1e3


@dataclasses.dataclass
class _ChunkJob:
    """An in-progress chunked (or deferred one-shot) prefill holding a
    slot that is not decoding yet."""

    req: "GenRequest"
    ids: List[int]
    done: int = 0            # tokens prefilled so far
    last: Any = None         # last-position logits of the latest chunk
    k: Any = None            # accumulated KV [L, width, H, hd] on device
    v: Any = None
    # staged prefix upload in flight on the kv-copy thread: resolves to
    # (k, v, prefix_len, event) or None on eviction — the job cold-starts
    # then. While pending, decode for running slots proceeds.
    pending_kv: Any = None
    # deferred ONE-SHOT prefill (a prefix hit without chunking): the
    # single "chunk" is the whole suffix, run once the upload landed
    one_shot: bool = False


@dataclasses.dataclass
class _EmbedJob:
    """One embedding batch for the scheduler thread: rows pre-padded to
    one bucket; ``result`` resolves to the ``[N, D]`` device tensor."""

    ids: List[List[int]]
    lens: List[int]
    result: concurrent.futures.Future = dataclasses.field(
        default_factory=concurrent.futures.Future
    )


@dataclasses.dataclass
class _SlotInfo:
    request: GenRequest
    ngram: Optional[_NgramIndex] = None
    # draft mode: delivered tokens not yet ingested into the draft cache
    pending_draft: List[int] = dataclasses.field(default_factory=list)
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
        eng = self._engine
        while True:
            item = self._q.get()
            if item is self._STOP:
                return
            kind, payload = item
            t0 = time.perf_counter()
            try:
                if kind == "finish":
                    self._finish_one(payload)
                else:
                    for info, toks in payload:
                        self._tokens_one(info, toks)
            finally:
                eng._note_overlap(time.perf_counter() - t0)

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


class _KVStager:
    """Two-slot staging bound for host→device prefix uploads on the
    kv-copy executor: at most ``depth`` jobs in flight, so the next job's
    prefix copies while the current chunk or the running slots' decode
    computes, without unbounded host pinning."""

    def __init__(self, executor, depth: int = 2):
        self._ex = executor
        self._inflight: "collections.deque" = collections.deque()
        self._mu = threading.Lock()
        self.depth = depth

    def submit(self, fn):
        with self._mu:
            while self._inflight and self._inflight[0].done():
                self._inflight.popleft()
            while len(self._inflight) >= self.depth:
                # backpressure: the two-slot bound is the memory contract
                concurrent.futures.wait([self._inflight.popleft()])
            try:
                fut = self._ex.submit(fn)
            except RuntimeError:
                # executor shut down (engine stopping): run inline — a
                # resolved future keeps the caller's contract
                fut = concurrent.futures.Future()
                try:
                    fut.set_result(fn())
                except Exception as e:
                    fut.set_exception(e)
            self._inflight.append(fut)
            return fut


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
        speculative: str = "",       # ""|"ngram"|"draft" (greedy only)
        spec_tokens: int = 4,        # positions verified per spec step
        draft_cfg=None,              # draft model (speculative="draft")
        draft_params=None,
        host_kv_cache_mb: int = 0,   # >0: host-RAM block KV cache
        kv_block_tokens: int = 0,    # block granularity (0 = default 256)
        kv_cache_int8: bool = False,  # int8 host tier (per-block scales)
        prefill_chunk: int = 0,      # >0: chunked prefill (tokens/chunk)
        kv_role: str = "",
        kv_spill_mb: int = 0,        # >0: disk spill tier under host RAM
        kv_spill_dir: str = "",      # spill directory ("" = derived tmp)
    ):
        not_ported = {"kv roles": bool(kv_role)}
        asked = [name for name, on in not_ported.items() if on]
        if asked:
            raise ValueError(
                f"not ported to the PyTorch engine yet: {', '.join(asked)}"
            )
        if speculative not in ("", "ngram", "draft"):
            raise ValueError(
                f"speculative must be '', 'ngram' or 'draft': {speculative!r}"
            )
        has_draft = draft_cfg is not None or draft_params is not None
        if speculative == "draft" and (draft_cfg is None or draft_params is None):
            raise ValueError("speculative='draft' needs draft_cfg/draft_params")
        if has_draft and speculative != "draft":
            raise ValueError("a draft model needs speculative='draft'")
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
        # host work overlapped with device compute (detok worker + kv
        # copy thread busy seconds), drained per step into the flight
        # record's host_overlap field
        self._overlap_mu = threading.Lock()
        self._overlap_s = 0.0
        self._overlap_seen = 0.0
        self._id_counter = itertools.count()
        self._step_count = 0
        self._tokens_generated = 0
        # one record per scheduler step, always on
        self.flight = FlightRecorder(max_slots)
        # per-step accumulators, reset at the top of step(); written only
        # by the scheduler thread
        self._step_mode = ""
        self._step_real = 0          # tokens genuinely dispatched
        self._step_padded = 0        # tokens the padded dispatch computed
        self._step_out = 0           # tokens delivered to requests
        self._step_prompt = 0        # prompt tokens entering prefill
        self._step_spec_proposed = 0
        self._step_spec_accepted = 0
        # speculative decoding: verify steps, accepted proposals (the
        # tokens beyond one per slot-step) and proposals made
        self.speculative = speculative
        self.spec_tokens = max(2, int(spec_tokens))
        self._spec_steps = 0
        self._spec_hits = 0
        self._spec_proposed = 0
        self.draft_runner = None
        self._draft_state = None
        if speculative == "draft":
            self.draft_runner = ModelRunner(
                draft_cfg, draft_params, self.device,
                max_slots=max_slots, max_seq_len=max_seq_len,
            )
            self._draft_state = self.draft_runner.new_state()
        # embedding batches handed to the scheduler thread
        self._embed_jobs: "queue.Queue[_EmbedJob]" = queue.Queue()
        # on-demand profiler capture (capture_profile): the scheduler
        # thread starts and stops torch.profiler around N busy steps
        self._profile_mu = threading.Lock()
        self._profile: Optional[Dict[str, Any]] = None
        self.ttft_hist = LatencyHistogram(TTFT_BUCKETS_S)
        self.tpot_hist = LatencyHistogram(TPOT_BUCKETS_S)
        self.e2e_hist = LatencyHistogram(E2E_BUCKETS_S)
        # chunked prefill: snap the chunk to a real bucket (rounding UP),
        # clamped to the top bucket — a chunk >= every prompt is a no-op
        self.prefill_chunk = 0
        if prefill_chunk > 0:
            top = self.runner.prefill_buckets[-1]
            self.prefill_chunk = self.runner.bucket_for(
                min(prefill_chunk, top)
            )
        self._chunk_jobs: Dict[int, _ChunkJob] = {}
        # futures of kv-copy work (device→host stores, abandoned stages)
        # whose results the scheduler reads, so a failed copy ends the
        # engine instead of vanishing on the copy thread
        self._kv_copies: List[concurrent.futures.Future] = []
        self.host_kv_cache = None
        self._kv_copy_pool = None
        self._kv_stage = None
        self._copy_stream = self._upload_stream = None
        if host_kv_cache_mb > 0:
            from gpustack_tpu_torch.engine.kv_host_cache import (
                DEFAULT_BLOCK_TOKENS,
                HostKVCache,
            )

            self.host_kv_cache = HostKVCache(
                host_kv_cache_mb * 2**20,
                block_tokens=(
                    kv_block_tokens if kv_block_tokens > 0
                    else DEFAULT_BLOCK_TOKENS
                ),
                int8=kv_cache_int8,
            )
            if kv_spill_mb > 0:
                from gpustack_tpu_torch.engine.kv_spill import DiskKVSpill

                spill_dir = kv_spill_dir or os.path.join(
                    tempfile.gettempdir(),
                    f"gpustack-kv-spill-{os.getpid()}",
                )
                self.host_kv_cache.spill = DiskKVSpill(
                    spill_dir, kv_spill_mb * 2**20
                )
            # device↔host KV copies run off the scheduler thread; staged
            # prefix uploads share the thread behind a two-slot bound
            self._kv_copy_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="kv-copy"
            )
            self._kv_stage = _KVStager(self._kv_copy_pool)
            if self.device.type == "cuda":
                self._copy_stream = torch.cuda.Stream(self.device)
                self._upload_stream = torch.cuda.Stream(self.device)

    # ---- public API -----------------------------------------------------

    def submit(self, req: GenRequest) -> GenRequest:
        if self._fatal:
            raise ValueError(f"engine is down: {self._fatal}")
        if not req.request_id:
            req.request_id = f"req-{next(self._id_counter)}"
        req.submitted_at = time.time()
        if self.speculative:
            # verification is greedy and yields no sampled distribution:
            # refuse what it would silently change
            if req.temperature > 0:
                raise ValueError(
                    "this deployment runs speculative decoding, which is "
                    "greedy-only; set temperature=0 (or deploy without "
                    "--speculative) to use sampling"
                )
            if req.logprobs:
                raise ValueError(
                    "logprobs are unavailable under speculative decoding "
                    "(verification produces no per-token distribution)"
                )
            if req.logit_bias:
                raise ValueError(
                    "logit_bias is unavailable under speculative decoding "
                    "(verification argmaxes raw logits; the bias would "
                    "stop applying after the first token)"
                )
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
        self._fail_embed_jobs("engine stopped")
        self._detok.stop()
        if self._kv_copy_pool is not None:
            # stores already queued land; later ones are skipped
            self._kv_copy_pool.shutdown(wait=True)

    def embed(
        self, batch_prompt_ids: List[List[int]], timeout: float = 300.0
    ) -> List[List[float]]:
        """Mean-pooled, l2-normalised embeddings from one batched forward
        (``runner.embed``: rows padded to one prefill bucket, the batch to
        a power of two). The JAX engine runs this on the caller's thread;
        here the batch goes to the scheduler thread as a job, so every
        forward on the card is launched by one thread. Needs a started
        engine."""
        if self._fatal:
            raise ValueError(f"engine is down: {self._fatal}")
        if not batch_prompt_ids or any(not ids for ids in batch_prompt_ids):
            raise ValueError("embedding inputs must be non-empty")
        for ids in batch_prompt_ids:
            if len(ids) >= self.max_seq_len:
                raise ValueError(
                    f"input of {len(ids)} tokens >= max_seq_len "
                    f"{self.max_seq_len}"
                )
        bucket = self.runner.bucket_for(
            max(len(ids) for ids in batch_prompt_ids)
        )
        job = _EmbedJob(
            ids=[list(ids) + [0] * (bucket - len(ids))
                 for ids in batch_prompt_ids],
            lens=[len(ids) for ids in batch_prompt_ids],
        )
        with self._wake:
            if not self._running:
                raise RuntimeError("embed needs a started engine")
            self._embed_jobs.put(job)
            self._wake.notify_all()
        # the device-to-host copy waits for the forward on the stream
        return job.result.result(timeout).tolist()

    def _fail_embed_jobs(self, message: str) -> None:
        while True:
            try:
                job = self._embed_jobs.get_nowait()
            except queue.Empty:
                return
            job.result.set_exception(RuntimeError(message))

    def health(self) -> Dict[str, Any]:
        kv = self.host_kv_cache
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
            "prompt_tokens": self.flight.prompt_tokens_total,
            "flight_overhead_ratio": round(self.flight.overhead_ratio(), 6),
            "pipeline_depth": self.pipeline_depth,
            "overlap": self.overlap,
            "host_overlap_ratio": round(
                self.flight.host_overlap_ratio(), 6
            ),
            "pipeline_rollback_tokens": self.flight.rollback_tokens_total,
            "idle_wait_s": round(self.flight.idle_wait_s_total, 3),
            "speculative": self.speculative,
            "spec_steps": self._spec_steps,
            "spec_extra_tokens": self._spec_hits,
            # accepted proposals / proposals made (1.0: every proposal of
            # every slot accepted)
            "spec_acceptance_rate": round(
                self._spec_hits / max(1, self._spec_proposed), 4
            ),
            "draft_model": (
                self.draft_runner.cfg.name if self.draft_runner else ""
            ),
            "kv_cache_hits": kv.hits if kv else 0,
            "kv_cache_misses": kv.misses if kv else 0,
            "kv_cache_prefix_hits": kv.prefix_hits if kv else 0,
            "kv_cache_prefix_tokens_reused": (
                kv.prefix_tokens_reused if kv else 0
            ),
            "kv_cache_blocks": kv.entries if kv else 0,
            "kv_cache_host_bytes": kv.bytes_used if kv else 0,
            "kv_spill": kv.spill.snapshot() if kv and kv.spill else {},
            "kv_faultbacks": kv.faultbacks if kv else 0,
        }

    # ---- scheduling loop ------------------------------------------------

    def _loop(self) -> None:
        try:
            while self._running:
                try:
                    busy = self.step()
                except Exception as e:
                    # a dead scheduling thread is LOUD and terminal: fail
                    # every request and flip health
                    logger.exception("engine scheduling loop died")
                    self._fatal = f"engine loop died: {e}"
                    self._fail_all_requests(str(e))
                    return
                # unlocked probe: None is the steady state
                if self._profile is not None:  # analysis: ignore[guarded-by]
                    self._profile_poll()
                if not busy:
                    with self._wake:
                        if (
                            self._running and self._waiting.empty()
                            and self._embed_jobs.empty()
                        ):
                            t0 = time.perf_counter()
                            self._wake.wait(timeout=0.05)
                            self.flight.note_idle_wait(
                                time.perf_counter() - t0
                            )
        finally:
            # a capture still open when the loop ends closes here, on the
            # thread that started it
            self._profile_poll(closing=True)

    def _notify_wake(self) -> None:
        with self._wake:
            self._wake.notify_all()

    def _note_overlap(self, seconds: float) -> None:
        """Worker threads report host work done concurrently with the
        scheduler; _flight_record drains the delta per step."""
        with self._overlap_mu:
            self._overlap_s += seconds

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
        # mid-prefill requests live in _chunk_jobs, not _slots
        for job in self._chunk_jobs.values():
            job.req.finish_reason = "error"
            if job.req.stream is not None:
                job.req.stream.put(None)
            job.req.done.set()
        self._chunk_jobs.clear()
        self._fail_embed_jobs(message)
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
        t0 = time.perf_counter()
        self._step_mode = ""
        self._step_real = self._step_padded = 0
        self._step_out = self._step_prompt = 0
        self._step_spec_proposed = self._step_spec_accepted = 0
        self._check_kv_copies()
        # fetch whatever the device already finished (non-blocking probe)
        # so a slot whose request ended re-tenants THIS step
        self._drain_ready()
        admitted = self._admit()
        # at most one prefill chunk per step: decode cadence for running
        # slots is bounded by one chunk's latency, not a whole prompt's
        progressed = self._advance_chunk()
        # at most one embedding batch per step, like a prefill
        embedded = self._run_embed_job()
        if self._slots:
            self._decode_once()
            self._flight_record(t0)
            return True
        if admitted or progressed or embedded or self._chunk_jobs:
            self._flight_record(t0)
            return True
        self._drain_pending()
        if self._step_out or self._step_spec_accepted:
            # tokens the drain delivered belong to a record too
            self._flight_record(t0)
        return not (self._waiting.empty() and self._embed_jobs.empty())

    def _run_embed_job(self) -> bool:
        """Dispatch the oldest queued embedding batch (one forward); its
        future resolves to the device tensor, which the caller's thread
        copies to the host."""
        try:
            job = self._embed_jobs.get_nowait()
        except queue.Empty:
            return False
        if not job.result.set_running_or_notify_cancel():
            return True
        try:
            vecs = self.runner.embed(job.ids, job.lens)
        except Exception as e:
            # a bad batch fails its caller; a CUDA error fails the next
            # step too, which ends the engine
            job.result.set_exception(e)
            return True
        self._step_mode = self._step_mode or "embed"
        self._step_real += sum(job.lens)
        # the batch runs padded to the next power of two
        self._step_padded += len(job.ids[0]) * (
            1 << (len(job.ids) - 1).bit_length()
        )
        job.result.set_result(vecs)
        return True

    def _flight_record(self, t0: float) -> None:
        """Seal this step's flight record. Scheduler-thread only."""
        dur_s = time.perf_counter() - t0
        oldest = 0.0
        try:
            # peeking the queue head without its mutex: worst case the
            # gauge is one submit stale
            oldest = time.time() - self._waiting.queue[0].submitted_at
        except IndexError:
            pass
        kv = self.host_kv_cache
        with self._overlap_mu:
            overlap_total = self._overlap_s
        overlap_delta = overlap_total - self._overlap_seen
        self._overlap_seen = overlap_total
        self.flight.record(
            dur_s=dur_s,
            host_overlap_s=max(0.0, overlap_delta),
            mode=self._step_mode or "decode",
            slots_used=self.max_slots - len(self._free),
            waiting=self._waiting.qsize(),
            oldest_wait_s=max(0.0, oldest),
            tokens_real=self._step_real,
            tokens_padded=self._step_padded,
            tokens_out=self._step_out,
            prompt_tokens=self._step_prompt,
            spec_proposed=self._step_spec_proposed,
            spec_accepted=self._step_spec_accepted,
            kv_blocks=kv.entries if kv is not None else 0,
            kv_reused_total=kv.prefix_tokens_reused if kv is not None else 0,
        )
        # unlocked probe: None is the steady state, and a stale non-None
        # pays one lock round trip in _profile_step
        if self._profile is not None:  # analysis: ignore[guarded-by]
            self._profile_step()

    # ---- on-demand profiler capture -------------------------------------

    def capture_profile(
        self, steps: int, out_dir: str = "", timeout_s: float = 30.0
    ) -> Dict[str, Any]:
        """Wrap the next ``steps`` busy scheduler steps in a
        ``torch.profiler`` capture (CPU activity, and CUDA activity on the
        card) and return the captured steps' flight records with their
        aggregate. The scheduler thread starts and stops the profiler;
        this thread then writes the Chrome trace to
        ``out_dir/trace.json``. With an empty ``out_dir``, or without a
        usable profiler, the capture degrades to flight records only.

        Blocks up to ``timeout_s`` for the steps to elapse; an idle engine
        returns what was captured by then. One capture at a time: a
        concurrent one gets a ValueError (profiler state is
        process-global)."""
        n = max(1, min(int(steps), 10_000))
        cap: Dict[str, Any] = {
            "remaining": n, "requested": n, "records": [],
            "out_dir": out_dir, "profiler": "flight-only",
            "started": False, "stop_requested": False, "error": "",
            "start_ms": None, "done": threading.Event(),
        }
        with self._profile_mu:
            if self._profile is not None:
                raise ValueError("a profile capture is already in progress")
            self._profile = cap
        if not cap["done"].wait(timeout_s):
            with self._profile_mu:
                if self._profile is cap and not cap["started"]:
                    # no busy step came: nothing to stop
                    self._profile = None
                    cap["done"].set()
                else:
                    # the scheduler closes the open trace at its next
                    # iteration (the profiler is bound to its thread)
                    cap["stop_requested"] = True
            if not cap["done"].wait(PROFILE_STOP_WAIT_S):
                cap["error"] = "the scheduler did not close the capture"
        if cap["profiler"] == "torch":
            try:
                os.makedirs(out_dir, exist_ok=True)
                cap["_prof"].export_chrome_trace(
                    os.path.join(out_dir, PROFILE_TRACE_FILE)
                )
            except Exception as e:  # a failed export keeps the records
                cap["error"] = f"trace export failed: {e}"
                cap["profiler"] = "flight-only"
        records = list(cap["records"])
        return {
            "requested": cap["requested"],
            "steps_captured": len(records),
            "profiler": cap["profiler"],
            "artifact": out_dir if cap["profiler"] == "torch" else "",
            "error": cap["error"],
            # the first CUDA capture of a process initialises CUPTI, which
            # can stall the step that starts it
            "profiler_start_ms": cap["start_ms"],
            "records": records,
            "aggregate": aggregate_records(
                records, self.max_slots,
                overhead_ratio=self.flight.overhead_ratio(),
            ) if records else {},
        }

    def _profile_step(self) -> None:
        """Advance the open capture by one recorded step (scheduler
        thread; the lock only guards the handoff with the capture
        thread)."""
        with self._profile_mu:
            cap = self._profile
            if cap is None or cap["remaining"] <= 0:
                return
            if not cap["started"]:
                # the first captured step is this one: its record lands
                # before the trace opens, so the trace covers the rest
                cap["started"] = True
                if cap["out_dir"] and self._profiler_start(cap):
                    cap["profiler"] = "torch"
            snap = self.flight.snapshot(limit=1)
            if snap:
                cap["records"].append(snap[-1])
            cap["remaining"] -= 1
            if cap["remaining"] <= 0:
                self._profiler_stop(cap)
                self._profile = None
                cap["done"].set()

    def _profile_poll(self, closing: bool = False) -> None:
        """Close a capture its caller gave up waiting for (or, when the
        loop ends, any open one) on the scheduler thread."""
        with self._profile_mu:
            cap = self._profile
            if cap is None or not (closing or cap["stop_requested"]):
                return
            self._profiler_stop(cap)
            self._profile = None
            cap["done"].set()

    def _profiler_start(self, cap: Dict[str, Any]) -> bool:
        prof = _torch_profiler()
        if prof is None or not hasattr(prof, "profile"):
            cap["error"] = "torch.profiler unavailable"
            return False
        activities = [prof.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(prof.ProfilerActivity.CUDA)
        t0 = time.perf_counter()
        try:
            p = prof.profile(activities=activities)
            p.start()
        except Exception as e:  # the profiler must never kill the loop
            cap["error"] = f"profiler start failed: {e}"
            return False
        cap["start_ms"] = (time.perf_counter() - t0) * 1e3
        cap["_prof"] = p
        return True

    @staticmethod
    def _profiler_stop(cap: Dict[str, Any]) -> None:
        if cap["profiler"] != "torch" or cap.get("_stopped"):
            return
        cap["_stopped"] = True
        try:
            cap["_prof"].stop()
        except Exception as e:
            cap["error"] = f"profiler stop failed: {e}"
            cap["profiler"] = "flight-only"

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
        # ONE prefix probe per request (counts one hit or miss), shared by
        # the chunked and one-shot paths
        kv_cache = self.host_kv_cache
        matched = (
            kv_cache.match_prefix_len(ids) if kv_cache is not None else 0
        )
        if (
            self.prefill_chunk
            and len(ids) > self.prefill_chunk
            and (job := self._plan_chunk_job(req, ids, matched)) is not None
        ):
            # long prompt: one chunk per scheduler step, seeded from the
            # host cache's matched block run when one fits
            self._step_mode = self._step_mode or "prefill_chunk"
            self._chunk_jobs[slot] = job
            return
        use_len = matched
        if use_len > 0:
            top = self.runner.prefill_buckets[-1]
            # bounds contract: the suffix BLOCK (bucketed) must fit above
            # the prefix within a real bucket — a write past it would land
            # outside the scratch cache. Trim the matched run one block at
            # a time, BEFORE any KV bytes are assembled.
            while use_len > 0:
                sb = self.runner.bucket_for(len(ids) - use_len)
                if use_len + sb <= top:
                    break
                use_len -= kv_cache.block_tokens
        if use_len > 0:
            # deferred one-shot prefill: the gather+upload rides the
            # kv-copy thread while decode proceeds; the slot holds a job
            # whose single "chunk" is the whole suffix
            fut = self._kv_stage.submit(
                self._stage_prefix_fn(req, ids, use_len, kv_cache)
            )
            self._chunk_jobs[slot] = _ChunkJob(
                req=req, ids=list(ids), pending_kv=fut, one_shot=True,
            )
            return
        bucket = self.runner.bucket_for(max(1, len(ids)))
        padded = list(ids) + [0] * (bucket - len(ids))
        self._step_mode = self._step_mode or "prefill"
        self._step_real += len(ids)
        self._step_prompt += len(ids)
        self._step_padded += bucket
        last_logits, k, v = self.runner.prefill(padded, len(ids))
        self._submit_kv_copy(ids, k, v, len(ids))
        self._finalize_start(slot, req, last_logits, k, v)

    # ---- chunked prefill and prefix reuse -------------------------------

    def _plan_chunk_job(
        self, req: GenRequest, ids, matched: int = 0
    ) -> Optional[_ChunkJob]:
        """Chunk schedule for a long prompt, seeded from the host cache's
        matched block run (``matched``) when one fits. Returns None when
        any continuation would overflow the top bucket (possible with a
        max_seq_len that is not a power of two): the caller falls back to
        a one-shot prefill, which always fits."""
        top = self.runner.prefill_buckets[-1]

        def fits(start: int) -> bool:
            # every continuation writes its suffix block at
            # [start, start + sb): it must stay inside a real bucket
            while start < len(ids):
                n = min(self.prefill_chunk, len(ids) - start)
                sb = self.runner.bucket_for(n)
                if start and start + sb > top:
                    return False
                start += n
            return True

        kv_cache = self.host_kv_cache
        if kv_cache is not None and matched > 0:
            # trim the matched run block by block until its continuation
            # fits, BEFORE gathering any bytes
            plen = matched
            while plen > 0 and not fits(plen):
                plen -= kv_cache.block_tokens
            if plen > 0 and fits(0):
                # staged: gather + upload on the kv-copy thread while this
                # and later steps decode; fits(0) guards the cold restart
                # of a run evicted between match and gather
                fut = self._kv_stage.submit(
                    self._stage_prefix_fn(req, ids, plen, kv_cache)
                )
                return _ChunkJob(req=req, ids=list(ids), pending_kv=fut)
            got = (
                self._gather_and_upload(req, ids, plen, kv_cache)
                if plen > 0 else None
            )
            if got is not None:
                job = _ChunkJob(req=req, ids=list(ids))
                self._adopt_prefix(job, got)
                return job
        if fits(0):
            return _ChunkJob(req=req, ids=list(ids))
        return None

    def _gather_and_upload(self, req, ids, plen: int, kv_cache):
        """Gather a matched block run from host RAM and upload it at
        bucket width: ``(k, v, plen, event)``, or None when the run
        evicted between match and gather. Hit counters and the request's
        attribution are recorded here, on success only."""
        got = kv_cache.gather_prefix(list(ids), plen)
        if got is None:
            return None
        pk, pv = got
        kv_cache.prefix_hits += 1
        kv_cache.prefix_tokens_reused += plen
        req.prefix_tokens_reused = plen
        t0 = time.time()
        k, v, event = self._upload_prefix(pk, pv, plen)
        req.kv_upload_s = time.time() - t0
        return k, v, plen, event

    def _stage_prefix_fn(self, req, ids, plen: int, kv_cache):
        """The kv-copy-thread job for a prefix seed."""
        ids_t = tuple(ids)

        def stage():
            t0 = time.perf_counter()
            try:
                return self._gather_and_upload(
                    req, list(ids_t), plen, kv_cache
                )
            finally:
                self._note_overlap(time.perf_counter() - t0)
                self._notify_wake()
        return stage

    def _upload_prefix(self, pk, pv, use_len: int):
        """Upload a matched prefix run padded to its BUCKET width (pad rows
        sit at positions >= use_len: overwritten by the suffix or hidden
        by the causal mask). On the card: a pinned host buffer copied on
        the upload stream into tensors allocated there; waits for the
        copy (on the calling thread, the kv-copy thread when staged) so
        the request's upload time is the transfer's. Returns ``(k, v,
        event)``; the scheduler adopts them with :meth:`_adopt_prefix`."""
        pw = self.runner.bucket_for(use_len)
        L, _, H, hd = pk.shape
        cuda = self.device.type == "cuda"
        hosts = []
        for arr in (pk, pv):
            host = torch.zeros(
                (L, pw, H, hd), dtype=torch_dtype(self.cfg), pin_memory=cuda
            )
            host[:, :use_len] = from_numpy(arr[:, :use_len])
            hosts.append(host)
        if not cuda:
            return hosts[0], hosts[1], None
        with torch.cuda.stream(self._upload_stream):
            k = hosts[0].to(self.device, non_blocking=True)
            v = hosts[1].to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        event.synchronize()
        return k, v, event

    def _adopt_prefix(self, job: _ChunkJob, got) -> None:
        """Seed ``job`` with an uploaded prefix: the scheduler's stream
        waits on the upload's event, and the tensors (allocated on the
        upload stream) are recorded on it, so the allocator frees them
        only after the scheduler's stream is done with them."""
        k, v, plen, event = got
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            k.record_stream(stream)
            v.record_stream(stream)
        job.k, job.v, job.done = k, v, plen

    def _resolve_staged_prefix(self, job: _ChunkJob) -> None:
        """Rendezvous with a staged gather+upload — the designated wait
        point (blocks when the job is reached before the upload landed).
        An evicted run (None) cold-starts the job; a failed stage raises
        and ends the engine."""
        fut, job.pending_kv = job.pending_kv, None
        got = fut.result()
        if got is not None:
            self._adopt_prefix(job, got)

    def _advance_chunk(self) -> bool:
        """Run ONE chunk of the oldest runnable in-progress job. A job
        whose staged upload is still in flight is passed over while any
        decode work exists; with nothing else to run, the oldest upload is
        awaited instead."""
        if not self._chunk_jobs:
            return False
        slot = job = None
        for s, j in self._chunk_jobs.items():
            if j.pending_kv is None or j.pending_kv.done():
                slot, job = s, j
                break
        if job is None:
            if self._slots:
                return False   # decode while the upload lands
            slot = next(iter(self._chunk_jobs))
            job = self._chunk_jobs[slot]
        if job.req.aborted.is_set():
            # abandon the remaining chunks; the slot never activated. An
            # upload still in flight is read later, like a store.
            del self._chunk_jobs[slot]
            self._free.append(slot)
            if job.pending_kv is not None:
                self._kv_copies.append(job.pending_kv)
            self._finish_aborted(job.req)
            return True
        if job.pending_kv is not None:
            self._resolve_staged_prefix(job)
        if job.one_shot:
            self._advance_one_shot(slot, job)
            return True
        r = self.runner
        start = job.done
        chunk = job.ids[start : start + self.prefill_chunk]
        sb = r.bucket_for(len(chunk))
        padded = list(chunk) + [0] * (sb - len(chunk))
        self._step_mode = self._step_mode or "prefill_chunk"
        self._step_real += len(chunk)
        self._step_prompt += len(chunk)
        self._step_padded += sb
        if start == 0:
            job.last, job.k, job.v = r.prefill(padded, len(chunk))
        else:
            job.last, job.k, job.v = r.prefill_with_prefix(
                job.k, job.v, start, padded, len(chunk),
                r.bucket_for(start + sb),
            )
        job.done += len(chunk)
        if job.done >= len(job.ids):
            del self._chunk_jobs[slot]
            self._submit_kv_copy(job.ids, job.k, job.v, len(job.ids))
            self._finalize_start(slot, job.req, job.last, job.k, job.v)
        return True

    def _advance_one_shot(self, slot: int, job: _ChunkJob) -> None:
        """Complete a deferred one-shot prefill: the staged prefix (when
        it landed — an evicted stage leaves ``done == 0`` and the job
        cold-starts) plus ONE bucketed forward over the whole suffix."""
        req, ids = job.req, job.ids
        r = self.runner
        self._step_mode = self._step_mode or "prefill"
        if job.done > 0:
            suffix = ids[job.done:]
            sb = r.bucket_for(len(suffix))
            self._step_real += len(suffix)
            self._step_prompt += len(suffix)
            self._step_padded += sb
            padded = list(suffix) + [0] * (sb - len(suffix))
            last_logits, k, v = r.prefill_with_prefix(
                job.k, job.v, job.done, padded, len(suffix),
                r.bucket_for(job.done + sb),
            )
        else:
            bucket = r.bucket_for(max(1, len(ids)))
            self._step_real += len(ids)
            self._step_prompt += len(ids)
            self._step_padded += bucket
            padded = list(ids) + [0] * (bucket - len(ids))
            last_logits, k, v = r.prefill(padded, len(ids))
        del self._chunk_jobs[slot]
        self._submit_kv_copy(ids, k, v, len(ids))
        self._finalize_start(slot, req, last_logits, k, v)

    # ---- device→host KV stores ------------------------------------------

    def _submit_kv_copy(self, seq, k_dev, v_dev, total: int) -> None:
        """Queue an async device→host copy + block insert of ``seq``'s KV
        (``k_dev``/``v_dev`` may be wider than ``total``: bucket or
        continuation padding). On the card the copy is enqueued here, on
        the copy stream behind the work that produced the K/V, into pinned
        buffers; the kv-copy thread waits on its event and inserts."""
        kv_cache = self.host_kv_cache
        if kv_cache is None:
            return
        if self.device.type == "cuda":
            stream = self._copy_stream
            stream.wait_stream(torch.cuda.current_stream(self.device))
            hosts = []
            with torch.cuda.stream(stream):
                for t in (k_dev, v_dev):
                    host = torch.empty(
                        (t.shape[0], total) + tuple(t.shape[2:]),
                        dtype=t.dtype, pin_memory=True,
                    )
                    host.copy_(t[:, :total], non_blocking=True)
                    t.record_stream(stream)
                    hosts.append(host)
                done = torch.cuda.Event()
                done.record()
        else:
            hosts = [k_dev[:, :total].clone(), v_dev[:, :total].clone()]
            done = None

        def copy_to_host(seq=tuple(seq), k_host=hosts[0], v_host=hosts[1]):
            t0 = time.perf_counter()
            try:
                if done is not None:
                    done.synchronize()
                kv_cache.insert_sequence(
                    seq, to_numpy(k_host), to_numpy(v_host)
                )
            finally:
                self._note_overlap(time.perf_counter() - t0)

        try:
            fut = self._kv_copy_pool.submit(copy_to_host)
        except RuntimeError:
            # pool shut down (engine stopping): skip the store; the cache
            # is an optimization, never required for correctness
            return
        self._kv_copies.append(fut)

    def _check_kv_copies(self) -> None:
        """Read the result of every finished kv-copy future: a failed copy
        (a CUDA error) raises here and ends the engine."""
        while self._kv_copies and self._kv_copies[0].done():
            self._kv_copies.pop(0).result()

    def _store_finished_sequence(self, slot: int, req: GenRequest) -> None:
        """Cache the FULL finished sequence (prompt + generated tokens) so
        turn N+1 of a conversation prefix-hits the blocks turn N decoded.
        The trailing output token is dropped: its KV is written only when
        it is fed, which may not have happened by finish time."""
        kv_cache = self.host_kv_cache
        if kv_cache is None:
            return
        seq = list(req.prompt_ids) + list(req.output_ids[:-1])
        bt = kv_cache.block_tokens
        if len(seq) // bt <= len(req.prompt_ids) // bt:
            # no full block beyond what the prefill-time store indexed
            return
        total = len(seq)
        k_dev, v_dev = self.runner.slot_kv(
            self._state, slot, self.runner.bucket_for(total)
        )
        self._submit_kv_copy(seq, k_dev, v_dev, total)

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
        if self.speculative == "ngram":
            info.ngram = _NgramIndex(req.prompt_ids)
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
        host learns it through the fetch pipeline. Speculative modes (the
        proposers need the exact host context) and logprobs requests take
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
        if self.overlap and not self.speculative and not req.logprobs:
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
        """Synchronous first-token path (serial mode, speculation,
        logprobs): reads the sampled token to the host before insert — a
        designated sync. A draft model mirrors the slot: its own prefill
        of the prompt, inserted greedy with the same first token."""
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
        if self.draft_runner is not None:
            dr = self.draft_runner
            bucket = dr.bucket_for(max(1, len(ids)))
            _, dk, dv = dr.prefill(
                list(ids) + [0] * (bucket - len(ids)), len(ids)
            )
            self._draft_state = dr.insert(
                self._draft_state, dk, dv, slot, len(ids), first,
                0.0, 0, 1.0,
            )
        self._slots[slot] = info
        self._deliver(slot, info, [first], first_lps)
        self._flush_detok()
        if self.draft_runner is not None and slot in self._slots:
            # ``first`` is already the draft's pending last token (set at
            # insert): queueing it again would feed it twice
            self._slots[slot].pending_draft.clear()

    def _decode_once(self) -> None:
        if self.draft_runner is not None and self._spec_safe():
            # a draft chain must continue the target's ACTUAL last token:
            # proposing from a lagged context misaligns the whole chain
            # (the n-gram proposer tolerates lag). One host sync per spec
            # step, amortised over up to spec_tokens tokens.
            self._drain_pending()
        # snapshot slot ownership at dispatch time: a lagged fetch drops
        # tokens of a slot that was retired and re-used since
        owners = {
            s: info.request.request_id for s, info in self._slots.items()
        }
        if not owners:
            return
        # the drain may have moved a sequence nearer the end: ask again
        if self.speculative and self._spec_safe():
            proposals = (
                self._build_proposals() if self.speculative == "ngram"
                else self._draft_propose()
            )
            self._state, tokens, produced = self.runner.verify_step(
                self._state, proposals
            )
            self._spec_steps += 1
            self._spec_proposed += len(owners) * (self.spec_tokens - 1)
            # one tensor, one copy at fetch: [B, P] tokens then produced
            out = torch.cat([tokens, produced[:, None]], dim=1)
            self._pending.append(
                (("spec", out), owners, self._record_event())
            )
            self._note_spec_dispatch(len(owners))
        else:
            self._state, out = self.runner.decode_step(
                self._state, self._step_key()
            )
            self._pending.append(
                (("decode", out), owners, self._record_event())
            )
            # decode runs every slot whether or not it is active: the
            # idle share is the decode side of padding waste
            self._step_mode = self._step_mode or "decode"
            self._step_real += len(owners)
            self._step_padded += self.max_slots
        self._step_count += 1
        if len(self._pending) > self.pipeline_depth:
            self._process_fetch(*self._pending.pop(0))

    def _note_spec_dispatch(self, active: int) -> None:
        """Flight accounting for one verify step: every slot computes
        spec_tokens positions, active or not."""
        self._step_mode = self._step_mode or "spec_verify"
        self._step_real += active * self.spec_tokens
        self._step_padded += self.max_slots * self.spec_tokens
        self._step_spec_proposed += active * (self.spec_tokens - 1)

    # ---- speculative decoding -------------------------------------------

    def _spec_safe(self) -> bool:
        """A verify step writes spec_tokens KV positions contiguously:
        stay clear of the cache end. The host's view of a sequence lags
        the device by up to ``pipeline_depth`` dispatched steps (default
        ``_FETCH_LAG``), each worth up to spec_tokens positions, hence the
        margin."""
        margin = self.spec_tokens * (self.pipeline_depth + 2)
        for info in self._slots.values():
            req = info.request
            used = len(req.prompt_ids) + len(req.output_ids)
            if used + margin >= self.max_seq_len:
                return False
        return True

    def _build_proposals(self) -> torch.Tensor:
        """N-gram lookup on each slot's (lagged) context through its
        incremental index: ``[B, spec_tokens]`` on the host."""
        P = self.spec_tokens
        proposals = torch.zeros((self.max_slots, P), dtype=torch.int64)
        for slot, info in self._slots.items():
            if info.ngram is None:
                continue
            prop = info.ngram.propose(P - 1)
            if prop:
                proposals[slot, : len(prop)] = torch.tensor(prop)
        return proposals

    def _draft_propose(self) -> torch.Tensor:
        """Draft-model proposals ``[B, spec_tokens]``, left on the device:

        1. catch-up: block-ingest each slot's delivered but not yet
           ingested tokens into the draft cache (one forward; the block is
           a power of two wide, at most 2·spec_tokens, the rest queued);
        2. propose: spec_tokens - 1 greedy draft decode steps;
        3. rewind: restore the draft's positions and last tokens; the
           proposal's cache entries sit above them, masked until accepted
           tokens overwrite them.

        The target's verify guarantees greedy-exact output whatever the
        draft proposes."""
        P = self.spec_tokens
        dr = self.draft_runner
        width = max(
            (len(i.pending_draft) for i in self._slots.values()), default=0
        )
        if width:
            width = min(width, 2 * P)
            w = 1
            while w < width:
                w *= 2
            block = torch.zeros((self.max_slots, w), dtype=torch.int64)
            counts = torch.zeros((self.max_slots,), dtype=torch.int64)
            for slot, info in self._slots.items():
                take = info.pending_draft[:w]
                info.pending_draft = info.pending_draft[len(take):]
                if take:
                    block[slot, : len(take)] = torch.tensor(take)
                counts[slot] = len(take)
            self._draft_state = dr.ingest_step(
                self._draft_state, block, counts
            )
        snap = dr.snapshot_sequence(self._draft_state)
        proposals = torch.zeros(
            (self.max_slots, P), dtype=torch.int64, device=self.device
        )
        for j in range(P - 1):
            # draft sampling is greedy: the step key is unused
            self._draft_state, out = dr.decode_step(self._draft_state, 0)
            proposals[:, j] = out[0]
        self._draft_state = dr.restore_sequence(self._draft_state, snap)
        return proposals

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
                self.flight.note_rollback(1)
                return
            self._deliver(slot, info, [int(payload[0])])
            self._flush_detok()
            return
        if kind == "spec":
            rows = payload.tolist()            # sync point (lagged)
            for slot, owner_id in owners.items():
                n = rows[slot][-1]
                info = self._slots.get(slot)
                if info is None or info.request.request_id != owner_id:
                    if n > 0:
                        self.flight.note_rollback(n)
                    continue
                if n <= 0:
                    continue
                self._spec_hits += n - 1
                self._step_spec_accepted += n - 1
                self._deliver(slot, info, rows[slot][:n])
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
                self.flight.note_rollback(1)
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
                self._step_out += 1
                if info.ngram is not None:
                    info.ngram.append(tok)
                if self.draft_runner is not None:
                    info.pending_draft.append(tok)
                if info.sync_detok:
                    info.buffer_ids.append(tok)
                    if self._emit_text(info, final=False):
                        # a verify step's later tokens never existed
                        if len(toks) - j - 1:
                            self.flight.note_rollback(len(toks) - j - 1)
                        self._finish(slot, info, "stop")
                        return
                else:
                    offload.append(tok)
            at_cap = (
                len(req.prompt_ids) + len(req.output_ids)
                >= self.max_seq_len - 1
            )
            if is_eos or at_cap or len(req.output_ids) >= req.max_tokens:
                if len(toks) - j - 1:
                    self.flight.note_rollback(len(toks) - j - 1)
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
        if reason in ("stop", "length"):
            # aborted/errored slots may have undelivered device state;
            # only cleanly finished sequences are cached
            self._store_finished_sequence(slot, req)
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
