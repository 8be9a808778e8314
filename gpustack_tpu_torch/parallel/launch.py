"""Run one function on every rank of a small mesh, one process each.

For checks that hold a sharded computation to a one-process one (the CPU
tests over gloo, ``chip_smoke.py``'s sharded-forward phases over NCCL):
``run_ranks(fn, world, *args)`` starts ``world`` processes (the ``spawn``
method: a fresh interpreter each, so no CUDA state is inherited), each
calling ``fn(rank, world, coordinator, *args)`` with a rendezvous address
on a free port, and returns their results in rank order. ``fn`` must be a
module-level function of an importable module. Any rank's exception, a
rank that dies, or the ``timeout`` fails the run, and every rank still
alive is killed: no process outlives the call.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import time
import traceback
from typing import Any, Callable, List

from gpustack_tpu_torch.parallel.mesh import free_port


def _rank_main(fn, rank, world, coordinator, results, threads, args):
    import torch

    if threads:
        torch.set_num_threads(threads)
    try:
        results.put((rank, True, fn(rank, world, coordinator, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def run_ranks(
    fn: Callable, world: int, *args, timeout: float = 300.0,
    threads: int = 0,
) -> List[Any]:
    """``[fn(rank, world, coordinator, *args) for rank in range(world)]``,
    each in its own process; ``threads`` > 0 sets each process's torch
    threads (1 keeps CPU ranks from oversubscribing the host)."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    coordinator = f"127.0.0.1:{free_port()}"
    procs = [
        ctx.Process(
            target=_rank_main, daemon=True,
            args=(fn, rank, world, coordinator, results, threads, args),
        )
        for rank in range(world)
    ]
    for p in procs:
        p.start()
    out: dict = {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"ranks {sorted(set(range(world)) - set(out))} did not "
                    f"finish within {timeout} s"
                )
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None]
                if dead:
                    # a last result may still be in the pipe
                    try:
                        rank, ok, value = results.get(timeout=2.0)
                    except queue.Empty:
                        raise RuntimeError(
                            f"rank {dead[0]} died (exit code "
                            f"{procs[dead[0]].exitcode})"
                        ) from None
                else:
                    continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(world)]
