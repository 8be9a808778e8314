"""Rank bodies for the sequence-parallel tests (``test_torch_ring_attention.py``,
``test_torch_sp_serving.py``): each runs in a process of its own over gloo
(``parallel.launch.run_ranks``) and imports no JAX. Inputs arrive as numpy
arrays, numpy trees and port configs; every rank returns numpy."""

import numpy as np
import torch

from gpustack_tpu_torch.engine.runner import ModelRunner  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.weights import params_from_numpy  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.ops import ring_attention as ra  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.parallel.mesh import Mesh, MeshPlan, init_mesh  # analysis: ignore[metrics-drift]

CPU = torch.device("cpu")


def _block(x, axis, index, parts):
    n = x.shape[axis] // parts
    return np.take(x, np.arange(index * n, (index + 1) * n), axis=axis)


def attention_cases(rank, world, coordinator, cases):
    """``cases``: ``[(name, plan, q, k, v, positions, cache, scale)]``, q
    ``[B, T, Hq, d]`` and k, v ``[B, T, Hkv, d]`` whole (sequence over
    ``sp``, heads over ``tp`` cut here). A ring case (``cache`` None)
    returns this rank's ``[B, T / sp, Hq / tp * d]``; a cache case (``k``
    and ``v`` the whole cache ``[B, S, Hkv, d]``, ``positions`` ``[B,
    T]``) returns this rank's ``[B, T, Hq / tp * d]``. Each with the
    rank's (sp index, tp index)."""
    init_mesh(MeshPlan(tp=world), rank, coordinator, CPU)
    out = {}
    for name, plan, q, k, v, positions, cache, scale in cases:
        mesh = Mesh(MeshPlan.parse(plan), rank)
        i, j, sp, tp = mesh.sp_rank, mesh.tp_rank, mesh.sp, mesh.tp
        qh, kh, vh = (torch.from_numpy(_block(x, 2, j, tp))
                      for x in (q, k, v))
        if cache is None:
            got = ra.ring_attention(
                *(torch.from_numpy(np.ascontiguousarray(
                    _block(x.numpy(), 1, i, sp))) for x in (qh, kh, vh)),
                scale, mesh)
        else:
            got = ra.sp_cache_attention(
                qh, *(torch.from_numpy(np.ascontiguousarray(
                    _block(x.numpy(), 1, i, sp))) for x in (kh, vh)),
                torch.from_numpy(positions), scale, mesh)
        out[name] = (i, j, got.numpy())
    return out


def _runner(rank, coordinator, cfg, tree, plan, max_seq_len, buckets=()):
    mesh = init_mesh(MeshPlan.parse(plan), rank, coordinator, CPU)
    return ModelRunner(
        cfg, params_from_numpy(tree, CPU, mesh, cfg.num_kv_heads), CPU,
        max_slots=2, max_seq_len=max_seq_len, prefill_buckets=buckets,
        mesh=mesh,
    )


def _prefill(runner, prompt, chunk):
    """A one-shot prefill, or one in chunks of ``chunk`` tokens
    (``prefill_chunk`` then ``prefill_continue_chunk``, as the engine's
    ``_advance_chunk`` runs them). Returns ``(last, k, v)``."""
    if not chunk:
        bucket = runner.bucket_for(len(prompt))
        return runner.prefill(
            list(prompt) + [0] * (bucket - len(prompt)), len(prompt))
    done, k, v = 0, None, None
    while done < len(prompt):
        part = prompt[done:done + chunk]
        sb = runner.bucket_for(len(part))
        padded = list(part) + [0] * (sb - len(part))
        if done == 0:
            last, k, v = runner.prefill_chunk(padded, len(part))
        else:
            last, k, v = runner.prefill_continue_chunk(
                k, v, done, padded, len(part), runner.bucket_for(done + sb))
        done += len(part)
    return last, k, v


def greedy_sp(rank, world, coordinator, cfg, tree, plan, prompts, steps,
              chunk, max_seq_len):
    """Each prompt prefilled (whole, or in chunks of ``chunk``), its first
    token picked greedily and inserted into slot ``i % 2``, then ``steps``
    decode steps of both slots. Returns the first-token logits of each
    prompt, each step's ``(tokens, token logprobs)`` and this rank's slot
    state at the end."""
    runner = _runner(rank, coordinator, cfg, tree, plan, max_seq_len)
    state = runner.new_state()
    firsts = []
    for slot, prompt in enumerate(prompts):
        last, k, v = _prefill(runner, prompt, chunk)
        first = int(runner.sample_first(last, 0.0, 0, 1.0, 0, False,
                                        len(prompt) - 1, 0)[0][0])
        state = runner.insert(state, k, v, slot, len(prompt), first, 0.0,
                              0, 1.0)
        firsts.append(last.numpy())
    steps_out = []
    for step in range(steps):
        state, out = runner.decode_step(state, step)
        steps_out.append((out[0].numpy(), out[1].numpy()))
    return (firsts, steps_out, state.last_tokens.numpy(),
            state.positions.numpy())


def refusal(rank, world, coordinator, cfg, tree, plan, max_seq_len,
            buckets):
    """The runner's refusal for this plan and shape, as a string."""
    try:
        _runner(rank, coordinator, cfg, tree, plan, max_seq_len, buckets)
    except ValueError as e:
        return str(e)
    return ""


def verify_ingest(rank, world, coordinator, cfg, tree, plan, prompts,
                  blocks, max_seq_len):
    """The speculative ops under ``plan``: each of ``prompts`` prefilled
    and inserted into slot ``i`` with its greedy first token, then for
    each ``(kind, tokens [B, P], counts [B] or None)`` of ``blocks`` a
    verify step (``"verify"``: the tokens are proposals) or a draft's
    ingest step (``"ingest"``), each followed by a decode step. Returns,
    per block, ``((greedy [B, P], produced [B])`` of a verify step or
    None, the last tokens and positions after it, and the decode step's
    tokens and token logprobs)``."""
    runner = _runner(rank, coordinator, cfg, tree, plan, max_seq_len)
    state = runner.new_state()
    for slot, prompt in enumerate(prompts):
        last, k, v = _prefill(runner, prompt, 0)
        state = runner.insert(state, k, v, slot, len(prompt),
                              int(last.argmax()), 0.0, 0, 1.0)
    out = []
    for step, (kind, tokens, counts) in enumerate(blocks):
        verified = None
        if kind == "verify":
            state, greedy, produced = runner.verify_step(
                state, torch.from_numpy(tokens))
            verified = (greedy.numpy(), produced.numpy())
        else:
            state = runner.ingest_step(state, torch.from_numpy(tokens),
                                       torch.from_numpy(counts))
        after = (state.last_tokens.numpy().copy(),
                 state.positions.numpy().copy())
        state, dec = runner.decode_step(state, step)
        out.append((verified, *after, dec[0].numpy(), dec[1].numpy()))
    return out
