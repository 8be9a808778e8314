"""Rank bodies for the data-parallel tests (``test_torch_dp_serving.py``)
and the ``ep x tp`` group check of ``test_torch_sp_ep_serving.py``: each
runs in a process of its own over gloo (``parallel.launch.run_ranks``)
and imports no JAX. Inputs arrive as numpy trees and port configs; every
rank returns numpy."""

import torch
import torch.distributed as dist

from gpustack_tpu_torch.engine.runner import ModelRunner  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.weights import params_from_numpy  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.parallel.mesh import MeshPlan, init_mesh  # analysis: ignore[metrics-drift]

CPU = torch.device("cpu")


def _prefill(runner, prompt, chunk, slot):
    """A one-shot prefill for ``slot``, or one in chunks of ``chunk``
    tokens (``prefill_chunk`` then ``prefill_continue_chunk``, as the
    engine's ``_advance_chunk`` runs them). Returns ``(last, k, v)``: None
    for each where this rank's group does not own the slot (rank 0 apart,
    which receives ``last``)."""
    if not chunk:
        bucket = runner.bucket_for(len(prompt))
        return runner.prefill(
            list(prompt) + [0] * (bucket - len(prompt)), len(prompt), slot)
    done, k, v = 0, None, None
    while done < len(prompt):
        part = prompt[done:done + chunk]
        sb = runner.bucket_for(len(part))
        padded = list(part) + [0] * (sb - len(part))
        if done == 0:
            last, k, v = runner.prefill_chunk(padded, len(part), slot)
        else:
            last, k, v = runner.prefill_continue_chunk(
                k, v, done, padded, len(part), runner.bucket_for(done + sb),
                slot)
        done += len(part)
    return last, k, v


def greedy_dp(rank, world, coordinator, cfg, tree, plan, prompts, slots,
              steps, chunk, max_seq_len, max_slots):
    """Prompt ``i`` prefilled for ``slots[i]`` (on its owning ``dp`` group;
    whole, or in chunks of ``chunk``), its greedy first token picked on
    rank 0 from the logits the group sent it and broadcast (as the
    leader's ``insert`` op carries it), inserted, then ``steps`` decode
    steps of every slot. Returns rank 0's first-token logits (None
    elsewhere), each step's ``(tokens, token logprobs)``, this rank's slot
    state at the end, its cache rows ``(k, v)`` with its ``dp`` index,
    and which prompts this rank's group prefilled."""
    mesh = init_mesh(MeshPlan.parse(plan), rank, coordinator, CPU)
    runner = ModelRunner(
        cfg, params_from_numpy(tree, CPU, mesh, cfg.num_kv_heads), CPU,
        max_slots=max_slots, max_seq_len=max_seq_len, mesh=mesh,
    )
    state = runner.new_state()
    firsts, ran = [], []
    for prompt, slot in zip(prompts, slots):
        last, k, v = _prefill(runner, prompt, chunk, slot)
        ran.append(k is not None)
        first = torch.zeros(1, dtype=torch.int64)
        if rank == 0:
            first[0] = runner.sample_first(last, 0.0, 0, 1.0, 0, False,
                                           len(prompt) - 1, 0)[0][0]
            firsts.append(last.numpy())
        dist.broadcast(first, src=0)
        state = runner.insert(state, k, v, slot, len(prompt), int(first),
                              0.0, 0, 1.0)
    steps_out = []
    for step in range(steps):
        state, out = runner.decode_step(state, step)
        steps_out.append((out[0].numpy(), out[1].numpy()))
    return {
        "firsts": firsts if rank == 0 else None, "steps": steps_out,
        "last_tokens": state.last_tokens.numpy(),
        "positions": state.positions.numpy(),
        "active": state.active.numpy(),
        "cache": (state.cache.k.numpy(), state.cache.v.numpy()),
        "coords": dict(mesh.coords), "ran": ran,
    }


def moe_groups(rank, world, coordinator, plan):
    """This rank's ``ep x tp`` group's members and its ``sp`` index, and
    an all-reduce over that group of the rank's ``sp`` index (what the
    MoE layer's one all-reduce sums over)."""
    mesh = init_mesh(MeshPlan.parse(plan), rank, coordinator, CPU)
    members = dist.get_process_group_ranks(mesh.moe_group)
    x = torch.full((1,), float(mesh.sp_rank))
    mesh.all_reduce_moe(x)
    return {"members": sorted(members), "coords": dict(mesh.coords),
            "sum": float(x[0]), "moe_size": mesh.moe_size}


def runner_refusal(rank, world, coordinator, cfg, tree, plan, max_slots):
    """The runner's refusal for this plan and slot count, as a string."""
    mesh = init_mesh(MeshPlan.parse(plan), rank, coordinator, CPU)
    try:
        ModelRunner(cfg, params_from_numpy(tree, CPU, mesh,
                                           cfg.num_kv_heads), CPU,
                    max_slots=max_slots, max_seq_len=64, mesh=mesh)
    except ValueError as e:
        return str(e)
    return ""
