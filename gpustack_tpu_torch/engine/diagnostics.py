"""Checks of a multi-GPU replica, run on every rank at once.

A probe is a collective: the leader broadcasts it over the command
channel (``multihost.BroadcastingRunner.probe``), each follower's loop
replays it (``multihost.FollowerLoop``), and every rank then calls
:func:`probe` on its own runner. The serving path never calls it.
"""

from __future__ import annotations

import hashlib
import importlib

import numpy as np
import torch

from gpustack_tpu_torch.models import transformer
from gpustack_tpu_torch.models.transformer import forward

# fp32 scores of one query-row chunk of the plain attention references
PLAIN_CHUNK_BYTES = 1 << 30
# the flash kernel's LSE mode while "plain_attention" swaps it out
_SWAPPED = {}

# the hand-written kernels' wrappers, by module (their launch counters)
KERNEL_WRAPPERS = (
    ("flash_attention", "flash_attention_prefill"),
    ("w8a16", "w8a16_matmul"),
    ("w8a16", "w8a16_grouped"),
    ("w8a16", "bf16_grouped"),
)


def _wrappers():
    return [
        (name, getattr(importlib.import_module(
            f"gpustack_tpu_torch.ops.{mod}"), name))
        for mod, name in KERNEL_WRAPPERS
    ]


def _chunk_rows(q, S: int) -> int:
    B, _, Hq, _ = q.shape
    return max(1, PLAIN_CHUNK_BYTES // (B * Hq * S * 4))


def plain_prefill(q, k, v, scale: float, q_offset: int = 0):
    """The flash kernel's plain version (``flash_attention_prefill_ref``)
    over query-row chunks of at most ``PLAIN_CHUNK_BYTES`` of fp32
    scores, so a check's reference runs at 32768 tokens."""
    from gpustack_tpu_torch.ops import flash_attention as fa

    n = _chunk_rows(q, k.shape[1])
    return torch.cat([
        fa.flash_attention_prefill_ref(q[:, t:t + n], k, v, scale,
                                       q_offset + t)
        for t in range(0, q.shape[1], n)], dim=1)


def plain_lse(q, k, v, scale: float, q_offset: int = 0):
    """The LSE mode's plain version (``flash_attention_lse_ref``) over
    query-row chunks, as :func:`plain_prefill`: ``(out, lse)``."""
    from gpustack_tpu_torch.ops import flash_attention as fa

    n = _chunk_rows(q, k.shape[1])
    parts = [fa.flash_attention_lse_ref(q[:, t:t + n], k, v, scale,
                                        q_offset + t)
             for t in range(0, q.shape[1], n)]
    return (torch.cat([o for o, _ in parts], dim=1),
            torch.cat([lse for _, lse in parts], dim=2))


class RoutingTape:
    """The experts each MoE layer call picks, kept per call of
    ``transformer._moe_mlp`` (``record``), or picks forced back into the
    calls that follow (``replay``), so two forwards over the same tokens
    can be compared without the near-tie picks that flip between them.

    Inside ``with``, ``transformer._moe_mlp`` and ``moe_route`` are
    wrapped. ``replay(calls)`` takes, per layer call in order, candidate
    ``[N, k]`` pick tensors and uses the one whose N is the call's token
    count (a ring block's rows or a whole prompt's), consumed row by row
    across the call's token chunks. A replayed call's combine weights are
    recomputed from its own router logits over the picks (softmax scoring
    then ``norm_topk_prob``, or ``softmax_topk``); ``flips`` counts, per
    call,
    the tokens whose own picks differ."""

    def __init__(self):
        self.calls, self.flips = [], []
        self.mode = "record"
        self._cur, self._at = None, 0

    def replay(self, calls) -> None:
        self.mode, self.flips = "replay", []
        self._queue = list(calls)

    def picks(self):
        """The recorded picks, one ``[N, k]`` tensor per layer call."""
        return [torch.cat(c) for c in self.calls]

    def __enter__(self):
        self._mlp, self._route = transformer._moe_mlp, transformer.moe_route

        def mlp(x, *args, **kw):
            if self.mode == "record":
                self.calls.append([])
            else:
                n = x.shape[0] * x.shape[1]
                cands = self._queue.pop(0)
                match = [c for c in cands if c.shape[0] == n]
                if not match:
                    raise ValueError(
                        f"no recorded picks for a call of {n} tokens "
                        f"(candidates {[c.shape[0] for c in cands]})")
                self._cur, self._at = match[0].to(x.device), 0
                self.flips.append(0)
            return self._mlp(x, *args, **kw)

        def route(x, router_w, cfg, router_bias=None):
            idx, combine = self._route(x, router_w, cfg, router_bias)
            if self.mode == "record":
                self.calls[-1].append(idx)
                return idx, combine
            want = self._cur[self._at:self._at + len(idx)]
            self._at += len(idx)
            self.flips[-1] += int(
                (idx.sort(-1).values != want.sort(-1).values).any(-1).sum())
            logits = x.float() @ router_w.float()
            if cfg.moe_scoring == "softmax_topk":
                if router_bias is not None:
                    logits = logits + router_bias.float()
                top_w = torch.softmax(torch.gather(logits, -1, want), -1)
            elif cfg.moe_scoring == "softmax":
                top_w = torch.gather(torch.softmax(logits, -1), -1, want)
                if cfg.norm_topk_prob:
                    top_w = top_w / top_w.sum(dim=-1, keepdim=True)
            else:
                raise ValueError(f"the tape cannot replay {cfg.moe_scoring}")
            return want, torch.zeros_like(logits).scatter_(-1, want, top_w)

        transformer._moe_mlp, transformer.moe_route = mlp, route
        return self

    def __exit__(self, *exc):
        transformer._moe_mlp, transformer.moe_route = self._mlp, self._route


def probe(runner, state, what: str, ids=None, true_len: int = 0,
          slot=None):
    """Read or reset what a check needs on this rank of ``runner``'s mesh
    (every rank calls it in step). ``what``:

    - ``"slot_state"``: every rank's ``[last_tokens, positions]`` (int64
      ``[2, B]``), gathered, in rank order;
    - ``"launches"``: every rank's kernel launch counts
      (``{wrapper: [n per rank]}``, and ``{wrapper_path: [n per rank]}``
      for a wrapper that splits its launches by path);
    - ``"reset_launches"``: each rank's counts to 0;
    - ``"memory"``: every rank's peak device bytes since the last
      ``"reset_memory"`` (0 on the CPU);
    - ``"prefill_plain"``: a prefill of the bucket-padded ``ids``
      (``true_len`` real) through the plain attention; the last real
      position's logits (under ``dp`` with a ``slot``, on the owning
      group and rank 0 only, as :meth:`ModelRunner.prefill`);
    - ``"decode_logits"``: the logits ``[B, V]`` a decode step would
      sample from (it writes the K/V that step would write, and leaves
      the slot state as it is; under ``dp`` each group's rows gathered);
    - ``"kv_rows"``: ``slot``'s K and V at positions ``0 .. true_len -
      1`` as this rank's heads hold them (fp32 ``[2, L, true_len, H,
      hd]``); under ``dp`` from the owning group's rank at this rank's
      other coordinates, on every ``dp`` peer (a ``dp`` gather), so a
      check compares two groups' rows of the same heads;
    - ``"routing_record"``: from here on, record the experts each MoE
      layer call picks (a :class:`RoutingTape` on every rank);
    - ``"routing_replay"``: replay each rank's recorded picks, call by
      call, in the forwards that follow (the same calls over the same
      tokens); with ``ids`` ``[start, stop]``, rows ``start .. stop - 1``
      of each recorded call are offered too (a continuation's tail of a
      recorded prefill from zero);
    - ``"plain_attention"``: from here on (``true_len`` 1) or no longer
      (0), this rank's prefill and embedding forwards take the plain
      attention, and a ring's blocks the LSE mode's plain version
      (:func:`plain_lse`; a check's reference forward on the same
      ranks);
    - ``"routing"``: stop the tape; every rank's recorded per-call picks
      (int32 on the host) and, after a replay, its flipped tokens per
      call, gathered, in rank order;
    - ``"kv_tier"``: every rank's host tier: ``entries``, ``bytes``,
      ``spill_entries`` and sha256 digests of its sorted RAM keys
      (``keys_digest``), of its spilled keys (``spill_digest``) and of
      the block ending at the last full block of ``ids`` as it stores it
      (``block_digest``: K, V and any int8 scales; "" where absent);
    - ``"kv_block"``: every rank's stored arrays of that block (``k``,
      ``v``, ``k_scale``, ``v_scale``; numpy, bf16 as uint16 bits), in
      rank order;
    - ``"kv_forget"``: every rank but 0 drops that block from its tier (a
      lost block: the next hit on it must end the replica);
    - ``"spec"``: every rank's verify steps and accepted proposals
      (``[steps, accepted]``).
    """
    device = runner.device
    cuda = device.type == "cuda"

    def gather(t: torch.Tensor):
        parts = (runner.mesh.all_gather_world(t) if runner.mesh is not None
                 else [t])
        return [p.cpu() for p in parts]

    if what == "slot_state":
        return gather(torch.stack([state.last_tokens, state.positions]))
    if what == "launches":
        names, counts = [], []
        for name, fn in _wrappers():
            names.append(name)
            counts.append(fn.launches)
            for path, n in getattr(fn, "launches_by_path", {}).items():
                names.append(f"{name}_{path}")
                counts.append(n)
        per_rank = gather(torch.tensor(counts, device=device))
        return {name: [int(p[i]) for p in per_rank]
                for i, name in enumerate(names)}
    if what == "reset_launches":
        for _, fn in _wrappers():
            fn.launches = 0
            if hasattr(fn, "launches_by_path"):
                fn.launches_by_path.update(
                    dict.fromkeys(fn.launches_by_path, 0))
        return None
    if what == "memory":
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        return [int(p) for p in gather(torch.tensor([peak], device=device))]
    if what == "reset_memory":
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        return None
    if what == "prefill_plain":
        if not runner._runs(slot):
            return runner._to_leader(None, slot)
        Tb = len(ids)
        tokens = torch.tensor([list(ids)], dtype=torch.int64, device=device)
        positions = torch.arange(Tb, device=device)[None, :]
        hidden, _ = forward(
            runner.params, runner.cfg, tokens, positions, runner._cache(Tb),
            return_hidden=True, attn_impl="plain", mesh=runner.mesh,
        )
        return runner._to_leader(runner._head(hidden[0, true_len - 1]), slot)
    if what == "decode_logits":
        rows = slice(runner.row0, runner.row0 + runner.rows)
        logits, _ = forward(
            runner.params, runner.cfg, state.last_tokens[rows, None],
            state.positions[rows, None], state.cache,
            attn_impl="sp_cache" if runner.sp_mode else "plain",
            mesh=runner.mesh,
        )
        if runner.dp > 1:
            return runner.mesh.gather_dp_rows(logits[:, 0])
        return logits[:, 0]
    if what == "routing_record":
        runner.routing_tape = RoutingTape().__enter__()
        return None
    if what == "routing_replay":
        tape = runner.routing_tape
        rows = slice(*ids) if ids else None
        tape.replay([[p] if rows is None else [p, p[rows]]
                     for p in tape.picks()])
        return None
    if what == "plain_attention":
        from gpustack_tpu_torch.ops import flash_attention as fa

        if true_len:
            runner.attn_impl_for = lambda bucket: "plain"
            _SWAPPED.setdefault("lse", fa.flash_attention_lse)
            fa.flash_attention_lse = plain_lse
        else:
            runner.__dict__.pop("attn_impl_for", None)
            fa.flash_attention_lse = _SWAPPED.pop("lse",
                                                  fa.flash_attention_lse)
        return None
    if what == "routing":
        tape, runner.routing_tape = runner.routing_tape, None
        tape.__exit__(None, None, None)
        picks = tape.picks()
        k = runner.cfg.num_experts_per_tok
        # each rank's call count (a dp group that ran no forward has
        # none), then its calls' rows and flips, then its picks, padded
        # to the largest rank's (int32: NCCL gathers no int16)
        n_calls = [int(n) for n in gather(torch.tensor(
            [len(picks)], device=device))]
        C = max(n_calls)
        lens = torch.zeros(2 * C, dtype=torch.int64, device=device)
        lens[:len(picks)] = torch.tensor([p.shape[0] for p in picks],
                                         dtype=torch.int64)
        lens[C:C + len(tape.flips)] = torch.tensor(tape.flips,
                                                   dtype=torch.int64)
        all_lens = gather(lens)
        rows = max(int(n[:C].sum()) for n in all_lens)
        padded = torch.zeros((rows, k), dtype=torch.int32, device=device)
        if picks:
            flat = torch.cat(picks)
            padded[:flat.shape[0]] = flat.int()
        out = []
        for c, n, flat in zip(n_calls, all_lens, gather(padded)):
            sizes = n[:c].tolist()
            out.append({"picks": list(flat[:sum(sizes)].split(sizes)),
                        "flips": n[C:C + c].tolist()})
        return out
    if what == "kv_rows":
        if runner.sp_mode:
            raise ValueError("kv_rows reads a slot's rows whole: not "
                             f"under plan {runner.plan}")
        c = state.cache
        rows = torch.zeros((2, c.k.shape[0], true_len, *c.k.shape[3:]),
                           dtype=torch.float32, device=device)
        if runner._runs(slot):
            row = slot - runner.row0
            rows[0] = c.k[:, row, :true_len]
            rows[1] = c.v[:, row, :true_len]
        if runner.dp > 1:
            rows = runner.mesh.all_gather_dp(rows)[slot // runner.rows]
        return rows.cpu()
    if what in ("kv_tier", "kv_block", "kv_forget"):
        return _kv_probe(runner, what, ids, gather)
    if what == "spec":
        rows = gather(torch.stack([
            torch.tensor(runner.spec_steps, device=device),
            runner.spec_accepted.to(device),
        ]))
        return [[int(x) for x in r.tolist()] for r in rows]
    raise ValueError(f"unknown probe {what!r}")


def _block_arrays(blk):
    return [a for a in (blk.k, blk.v, blk.k_scale, blk.v_scale)
            if a is not None]


def _digest(chunks) -> torch.Tensor:
    h = hashlib.sha256()
    for c in chunks:
        h.update(c)
    return torch.tensor(list(h.digest()), dtype=torch.int64)


def _kv_probe(runner, what, ids, gather):
    """The host-tier probes (:func:`probe`'s ``kv_*``)."""
    cache = runner.host_tier
    blk = key = None
    if ids is not None:
        keys = cache.chain_keys(ids)
        key = keys[-1] if keys else None
        blk = cache.block(key) if key is not None else None
    if what == "kv_forget":
        if runner.mesh is not None and runner.mesh.rank and key is not None:
            cache._detach(key)
        return None
    if what == "kv_block":
        if blk is None:
            raise ValueError("kv_block names no block this rank holds")
        flat = np.concatenate([np.ascontiguousarray(a).view(np.uint8)
                               .ravel() for a in _block_arrays(blk)])
        parts = gather(torch.from_numpy(flat).to(runner.device))
        out = []
        for part in parts:
            raw, arrays, at = part.numpy(), {}, 0
            for name in ("k", "v", "k_scale", "v_scale"):
                a = getattr(blk, name)
                if a is None:
                    continue
                n = a.nbytes
                arrays[name] = raw[at:at + n].view(a.dtype).reshape(a.shape)
                at += n
            out.append(arrays)
        return out
    spill = cache.spill
    spilled = spill.keys() if spill is not None else []
    row = torch.cat([
        torch.tensor([cache.entries, cache.bytes_used, len(spilled),
                      int(blk is not None)], dtype=torch.int64),
        _digest(k.encode() for k in cache.keys()),
        _digest(k.encode() for k in spilled),
        _digest(np.ascontiguousarray(a).tobytes()
                for a in (_block_arrays(blk) if blk is not None else [])),
    ]).to(runner.device)
    out = []
    for r in gather(row):
        r = r.tolist()
        out.append({
            "entries": r[0], "bytes": r[1], "spill_entries": r[2],
            "keys_digest": bytes(r[4:36]).hex(),
            "spill_digest": bytes(r[36:68]).hex(),
            "block_digest": bytes(r[68:100]).hex() if r[3] else "",
        })
    return out
