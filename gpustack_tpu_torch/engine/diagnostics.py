"""Checks of a multi-GPU replica, run on every rank at once.

A probe is a collective: the leader broadcasts it over the command
channel (``multihost.BroadcastingRunner.probe``), each follower's loop
replays it (``multihost.FollowerLoop``), and every rank then calls
:func:`probe` on its own runner. The serving path never calls it.
"""

from __future__ import annotations

import importlib

import torch

from gpustack_tpu_torch.models.transformer import forward

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


def probe(runner, state, what: str, ids=None, true_len: int = 0):
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
      position's logits;
    - ``"decode_logits"``: the logits ``[B, V]`` a decode step would
      sample from (it writes the K/V that step would write, and leaves
      the slot state as it is).
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
        Tb = len(ids)
        tokens = torch.tensor([list(ids)], dtype=torch.int64, device=device)
        positions = torch.arange(Tb, device=device)[None, :]
        hidden, _ = forward(
            runner.params, runner.cfg, tokens, positions, runner._cache(Tb),
            return_hidden=True, attn_impl="plain", mesh=runner.mesh,
        )
        return runner._head(hidden[0, true_len - 1])
    if what == "decode_logits":
        logits, _ = forward(
            runner.params, runner.cfg, state.last_tokens[:, None],
            state.positions[:, None], state.cache,
            attn_impl="sp_cache" if runner.sp_mode else "plain",
            mesh=runner.mesh,
        )
        return logits[:, 0]
    raise ValueError(f"unknown probe {what!r}")
