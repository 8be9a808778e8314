"""Engine flight recorder: one bounded record per scheduler step.

The port's copy of ``gpustack_tpu/observability/flight.py``: a
fixed-capacity ring of per-step records cheap enough to stay always on
(its self-measured overhead is exported), served raw at the engine's
``GET /debug/flight`` and aggregated into the ``gpustack_engine_*``
Prometheus families on ``/metrics``. The record layout is the JAX
package's, so one consumer reads an engine of either package.

Record vocabulary (per step):

- ``mode`` — what the step mostly did: ``prefill`` (one-shot),
  ``prefill_chunk`` (one chunk of a long prompt), ``decode`` (one
  decode_step over all slots), ``spec_verify`` (one speculative verify
  step: ``tokens_real`` = active slots x spec_tokens, ``tokens_padded``
  = all slots x spec_tokens), ``embed`` (one embedding batch; the port
  runs it on the scheduler thread, the JAX engine beside it, unrecorded).
- ``dur_ms`` — step wall time.
- ``slots_used``/``slots_total``, ``waiting``, ``oldest_wait_ms`` —
  occupancy, queue depth, and how long the queue head has waited.
- ``tokens_real``/``tokens_padded`` — tokens the step genuinely needed
  vs. tokens the padded dispatch computed (bucket padding on prefill,
  inactive slots on decode).
- ``tokens_out`` — tokens delivered to requests during the step.
- ``spec_proposed``/``spec_accepted`` — speculation: proposals made and
  accepted.
- ``kv_blocks``/``kv_reused_total`` — host KV cache pressure.
- ``host_overlap_ms`` — host work (detokenization, stream writes, KV
  staging copies) done on worker threads during this step.

Cumulative: ``idle_wait_s_total`` (seconds the scheduler parked on its
wakeup condition) and ``rollback_tokens_total`` (tokens the dispatch-ahead
pipeline dropped after a lagged fetch revealed their slot finished).
"""

from __future__ import annotations

import bisect
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

# step-time buckets: µs-scale stub steps through multi-second chunked
# prefills on real hardware
STEP_BUCKETS_S = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
)

DEFAULT_CAPACITY = 2048


def _pctl(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[idx]


def aggregate_records(
    entries: List[Dict[str, Any]],
    slots_total: int,
    overhead_ratio: float = 0.0,
) -> Dict[str, Any]:
    """Utilization aggregates over a list of step records (the ring, a
    window of it, or a profiler capture's slice)."""
    out: Dict[str, Any] = {
        "steps": len(entries),
        "slots_total": slots_total,
        "overhead_ratio": round(overhead_ratio, 6),
    }
    if not entries:
        out["modes"] = {}
        return out
    by_mode: Dict[str, List[float]] = {}
    occ: List[float] = []
    waits: List[float] = []
    real = padded = tokens_out = proposed = accepted = 0
    prompt = 0
    overlap_ms = dur_ms = 0.0
    for e in entries:
        by_mode.setdefault(e["mode"], []).append(e["dur_ms"])
        occ.append(e["slots_used"] / max(1, slots_total))
        waits.append(e["oldest_wait_ms"])
        real += e["tokens_real"]
        padded += e["tokens_padded"]
        tokens_out += e["tokens_out"]
        prompt += e.get("prompt_tokens", 0)
        proposed += e["spec_proposed"]
        accepted += e["spec_accepted"]
        overlap_ms += e.get("host_overlap_ms", 0.0)
        dur_ms += e["dur_ms"]
    occ.sort()
    waits.sort()
    span_s = (
        max(1e-9, entries[-1]["ts"] - entries[0]["ts"])
        if len(entries) > 1 else None
    )
    out["modes"] = {
        mode: {
            "steps": len(durs),
            "step_ms_p50": round(_pctl(sorted(durs), 0.5), 3),
            "step_ms_p95": round(_pctl(sorted(durs), 0.95), 3),
        }
        for mode, durs in sorted(by_mode.items())
    }
    out.update(
        occupancy_p50=round(_pctl(occ, 0.5), 4),
        occupancy_p95=round(_pctl(occ, 0.95), 4),
        queue_wait_ms_p50=round(_pctl(waits, 0.5), 2),
        queue_wait_ms_max=round(waits[-1], 2),
        tokens_real=real,
        tokens_padded=padded,
        padding_waste_pct=(
            round(100.0 * (1.0 - real / padded), 2) if padded else 0.0
        ),
        tokens_out=tokens_out,
        prompt_tokens=prompt,
        tokens_per_step=round(tokens_out / len(entries), 3),
        spec_proposed=proposed,
        spec_accepted=accepted,
        spec_acceptance=(
            round(accepted / proposed, 4) if proposed else None
        ),
        kv_blocks=entries[-1]["kv_blocks"],
        kv_reused_total=entries[-1]["kv_reused_total"],
        host_overlap_ms=round(overlap_ms, 3),
        # overlapped host work / scheduler step wall time; > 1.0 means
        # several worker threads overlapped the same step
        host_overlap_ratio=(
            round(overlap_ms / dur_ms, 4) if dur_ms else 0.0
        ),
    )
    if span_s:
        out["tokens_out_per_s"] = round(tokens_out / span_s, 2)
    return out


# concurrency contract: one writer (the engine scheduler's record/note_*
# calls), many readers (HTTP exporters, bench) — every touch of the
# ring, histogram, counters, and self-measurement under `_mu`.
GUARDED_BY = {
    "_ring": "_mu",
    "_hist": "_mu",
    "tokens_real_total": "_mu",
    "tokens_padded_total": "_mu",
    "tokens_out_total": "_mu",
    "prompt_tokens_total": "_mu",
    "spec_proposed_total": "_mu",
    "spec_accepted_total": "_mu",
    "_last_slots_used": "_mu",
    "_last_waiting": "_mu",
    "_last_oldest_wait_s": "_mu",
    "_last_kv_blocks": "_mu",
    "host_overlap_s_total": "_mu",
    "idle_wait_s_total": "_mu",
    "rollback_tokens_total": "_mu",
    "_record_s": "_mu",
    "_step_s": "_mu",
}


class FlightRecorder:
    """Bounded ring of per-step records + cumulative counters.

    ``record`` is called from exactly one thread (the engine scheduler);
    readers (HTTP exporters, bench) take the lock only to copy. The
    recorder measures its own cost: ``overhead_ratio()`` is cumulative
    seconds spent inside ``record`` divided by cumulative step wall
    time — exported so "observability is free" stays a measured claim,
    never an assumption.
    """

    def __init__(
        self, slots_total: int, capacity: int = DEFAULT_CAPACITY
    ):
        self.slots_total = max(1, int(slots_total))
        self._mu = threading.Lock()
        # tuples, not dicts: the write path is on the scheduler's step
        # budget, and a 14-key dict per step costs ~10x a tuple append.
        # snapshot() re-materializes dicts on the (cold) read side.
        self._ring: deque = deque(maxlen=max(16, int(capacity)))
        # per-mode step-time histogram: plain lists, single writer
        # (same torn-read tolerance as the engine's LatencyHistogram)
        self._hist: Dict[str, List] = {}
        self.tokens_real_total = 0
        self.tokens_padded_total = 0
        self.tokens_out_total = 0
        self.prompt_tokens_total = 0
        self.spec_proposed_total = 0
        self.spec_accepted_total = 0
        self._last_slots_used = 0
        self._last_waiting = 0
        self._last_oldest_wait_s = 0.0
        self._last_kv_blocks = 0
        # overlapped-engine accounting: cumulative host work
        # overlapped with device compute, scheduler idle-park seconds
        # (the spin the condition-variable wakeup saves), and tokens the
        # dispatch-ahead pipeline rolled back after a lagged fetch
        self.host_overlap_s_total = 0.0
        self.idle_wait_s_total = 0.0
        self.rollback_tokens_total = 0
        # self-measurement
        self._record_s = 0.0
        self._step_s = 0.0

    # ---- write side (scheduler thread) --------------------------------

    def record(
        self,
        *,
        dur_s: float,
        mode: str,
        slots_used: int,
        waiting: int,
        oldest_wait_s: float,
        tokens_real: int,
        tokens_padded: int,
        tokens_out: int,
        prompt_tokens: int = 0,
        spec_proposed: int = 0,
        spec_accepted: int = 0,
        kv_blocks: int = 0,
        kv_reused_total: int = 0,
        host_overlap_s: float = 0.0,
    ) -> None:
        t0 = time.perf_counter()
        with self._mu:
            self._ring.append((
                time.time(), dur_s, mode, slots_used, waiting,
                oldest_wait_s, tokens_real, tokens_padded, tokens_out,
                prompt_tokens, spec_proposed, spec_accepted, kv_blocks,
                kv_reused_total, host_overlap_s,
            ))
            h = self._hist.get(mode)
            if h is None:
                h = self._hist[mode] = [
                    [0] * (len(STEP_BUCKETS_S) + 1), 0.0, 0,
                ]
            h[0][bisect.bisect_left(STEP_BUCKETS_S, dur_s)] += 1
            h[1] += dur_s
            h[2] += 1
            self.tokens_real_total += tokens_real
            self.tokens_padded_total += tokens_padded
            self.tokens_out_total += tokens_out
            self.prompt_tokens_total += prompt_tokens
            self.spec_proposed_total += spec_proposed
            self.spec_accepted_total += spec_accepted
            self._last_kv_blocks = kv_blocks
            self._last_waiting = waiting
            self._last_oldest_wait_s = oldest_wait_s
            self._last_slots_used = slots_used
            self.host_overlap_s_total += host_overlap_s
            self._step_s += dur_s
            self._record_s += time.perf_counter() - t0

    def note_idle_wait(self, seconds: float) -> None:
        """Scheduler parked on its wakeup condition for ``seconds`` —
        spin time the condition-variable loop saved vs. busy-polling."""
        with self._mu:
            self.idle_wait_s_total += seconds

    def note_rollback(self, tokens: int) -> None:
        """``tokens`` speculatively generated tokens discarded because a
        lagged fetch revealed their slot finished or was re-tenanted."""
        with self._mu:
            self.rollback_tokens_total += tokens

    @staticmethod
    def _to_entry(row) -> Dict[str, Any]:
        (ts, dur_s, mode, slots_used, waiting, oldest_wait_s,
         tokens_real, tokens_padded, tokens_out, prompt_tokens,
         spec_proposed, spec_accepted, kv_blocks, kv_reused_total,
         host_overlap_s) = row
        return {
            "ts": ts,
            "dur_ms": round(dur_s * 1e3, 4),
            "mode": mode,
            "slots_used": slots_used,
            "waiting": waiting,
            "oldest_wait_ms": round(oldest_wait_s * 1e3, 2),
            "tokens_real": tokens_real,
            "tokens_padded": tokens_padded,
            "tokens_out": tokens_out,
            "prompt_tokens": prompt_tokens,
            "spec_proposed": spec_proposed,
            "spec_accepted": spec_accepted,
            "kv_blocks": kv_blocks,
            "kv_reused_total": kv_reused_total,
            "host_overlap_ms": round(host_overlap_s * 1e3, 4),
        }

    # ---- read side -----------------------------------------------------

    def overhead_ratio(self) -> float:
        """Seconds spent recording / seconds of recorded step wall time
        (0.0 until the first step)."""
        with self._mu:
            if self._step_s <= 0.0:
                return 0.0
            return self._record_s / self._step_s

    def host_overlap_ratio(self) -> float:
        """Cumulative overlapped host seconds / cumulative step wall
        time (can exceed 1.0 with several overlapping workers)."""
        with self._mu:
            if self._step_s <= 0.0:
                return 0.0
            return self.host_overlap_s_total / self._step_s

    def snapshot(self, limit: int = 200) -> List[Dict[str, Any]]:
        """Newest-last copy of the most recent ``limit`` records."""
        with self._mu:
            rows = list(self._ring)
        return [
            self._to_entry(r) for r in rows[-max(1, int(limit)):]
        ]

    def aggregate(
        self, window_s: Optional[float] = None
    ) -> Dict[str, Any]:
        """Windowed utilization aggregates over the ring (the whole
        ring when ``window_s`` is None): per-mode step counts and
        latency percentiles, occupancy, padding waste, queue stats,
        speculation acceptance, KV pressure. This is the shape bench's
        utilization section and /debug/flight both serve."""
        with self._mu:
            rows = list(self._ring)
        entries = [self._to_entry(r) for r in rows]
        if window_s is not None:
            cutoff = time.time() - window_s
            entries = [e for e in entries if e["ts"] >= cutoff]
        return aggregate_records(
            entries, self.slots_total,
            overhead_ratio=self.overhead_ratio(),
        )

    # ---- prometheus ----------------------------------------------------

    def metrics_lines(self) -> List[str]:
        """Exposition lines for the flight-derived families (TYPE text
        from the declared vocabulary, ``metrics.METRIC_FAMILIES``)."""
        from gpustack_tpu_torch.observability.metrics import (
            type_line as decl,
        )

        with self._mu:
            slots_used = self._last_slots_used
            waiting = self._last_waiting
            oldest = self._last_oldest_wait_s
            kv_blocks = self._last_kv_blocks
            real = self.tokens_real_total
            padded = self.tokens_padded_total
            prompt = self.prompt_tokens_total
            proposed = self.spec_proposed_total
            accepted = self.spec_accepted_total
            hist = {
                mode: (list(h[0]), h[1], h[2])
                for mode, h in self._hist.items()
            }
            idle_wait_s = self.idle_wait_s_total
            rollback_tokens = self.rollback_tokens_total
        lines = [decl("gpustack_engine_step_seconds")]
        for mode in sorted(hist):
            counts, total, count = hist[mode]
            cum = 0
            for ub, c in zip(STEP_BUCKETS_S, counts):
                cum += c
                lines.append(
                    f"gpustack_engine_step_seconds_bucket"
                    f'{{mode="{mode}",le="{repr(ub)}"}} {cum}'
                )
            inf = cum + counts[-1]
            lines.append(
                f"gpustack_engine_step_seconds_bucket"
                f'{{mode="{mode}",le="+Inf"}} {inf}'
            )
            lines.append(
                f'gpustack_engine_step_seconds_sum{{mode="{mode}"}} '
                f"{total:.6f}"
            )
            lines.append(
                f'gpustack_engine_step_seconds_count{{mode="{mode}"}} '
                f"{min(count, inf)}"
            )
        lines += [
            decl("gpustack_engine_dispatched_tokens_total"),
            f'gpustack_engine_dispatched_tokens_total{{kind="real"}} '
            f"{real}",
            f'gpustack_engine_dispatched_tokens_total{{kind="padded"}} '
            f"{padded}",
            decl("gpustack_engine_prompt_tokens_total"),
            f"gpustack_engine_prompt_tokens_total {prompt}",
            decl("gpustack_engine_occupancy_ratio"),
            f"gpustack_engine_occupancy_ratio "
            f"{slots_used / max(1, self.slots_total):.4f}",
            decl("gpustack_engine_queue_oldest_wait_seconds"),
            f"gpustack_engine_queue_oldest_wait_seconds "
            f"{oldest:.4f}",
            decl("gpustack_engine_queue_depth"),
            f"gpustack_engine_queue_depth {waiting}",
            decl("gpustack_engine_spec_proposed_total"),
            f"gpustack_engine_spec_proposed_total {proposed}",
            decl("gpustack_engine_spec_accepted_total"),
            f"gpustack_engine_spec_accepted_total {accepted}",
            decl("gpustack_engine_kv_blocks_used"),
            f"gpustack_engine_kv_blocks_used {kv_blocks}",
            decl("gpustack_engine_flight_overhead_ratio"),
            f"gpustack_engine_flight_overhead_ratio "
            f"{self.overhead_ratio():.6f}",
            decl("gpustack_engine_host_overlap_ratio"),
            f"gpustack_engine_host_overlap_ratio "
            f"{self.host_overlap_ratio():.6f}",
            decl("gpustack_engine_idle_wait_seconds_total"),
            f"gpustack_engine_idle_wait_seconds_total "
            f"{idle_wait_s:.6f}",
            decl("gpustack_engine_rollback_tokens_total"),
            f"gpustack_engine_rollback_tokens_total "
            f"{rollback_tokens}",
        ]
        return lines
