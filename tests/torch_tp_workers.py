"""Rank bodies for the sharded-forward tests (``test_torch_tp.py``): each
runs in a process of its own over gloo (``parallel.launch.run_ranks``)
and imports no JAX. Inputs arrive as numpy trees and port configs; rank
0 returns numpy outputs."""

import numpy as np
import torch

from gpustack_tpu_torch.engine.runner import ModelRunner  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.weights import params_from_numpy  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models import transformer as pt  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.parallel.mesh import Mesh, MeshPlan, init_mesh  # analysis: ignore[metrics-drift]

CPU = torch.device("cpu")


def _forwards(cfg, params, toks, mesh, S):
    """Cacheless logits, then a prefill into a cache and one decode step
    at position T: each rank's logits (every rank holds the whole
    vocab)."""
    t = torch.from_numpy(toks).long()
    B, T = t.shape
    pos = torch.arange(T)[None].expand(B, T)
    plain, _ = pt.forward(params, cfg, t, pos, mesh=mesh)
    cache = pt.KVCache.create(cfg, B, S, CPU, mesh.tp if mesh else 1)
    pre, _ = pt.forward(params, cfg, t, pos, cache, mesh=mesh)
    nxt = torch.from_numpy((toks[:, -1:] * 7 + 3) % cfg.vocab_size).long()
    dec, _ = pt.forward(params, cfg, nxt, torch.full((B, 1), T), cache,
                        mesh=mesh)
    return [x.float().numpy() for x in (plain, pre, dec)]


def forward_cases(rank, world, coordinator, cases):
    """``cases``: ``[(name, cfg, plan, tree, toks, S)]``, plans of
    ``world`` ranks each. Returns ``{name: (plain, prefill, decode)}``
    logits from every rank (rank 0's are compared; the others must equal
    them)."""
    init_mesh(MeshPlan(tp=world), rank, coordinator, CPU)
    out = {}
    for name, cfg, plan, tree, toks, S in cases:
        mesh = Mesh(MeshPlan.parse(plan), rank)
        params = params_from_numpy(tree, CPU, mesh, cfg.num_kv_heads)
        out[name] = _forwards(cfg, params, toks, mesh, S)
    return out


def greedy_tp(rank, world, coordinator, cfg, tree, prompt, steps, plan):
    """A prefill, the first token, then ``steps`` decode steps of one
    greedy slot through the sharded runner: the ids, and this rank's
    slot state (last tokens, positions) at the end."""
    mesh = init_mesh(MeshPlan.parse(plan), rank, coordinator, CPU)
    runner = ModelRunner(
        cfg, params_from_numpy(tree, CPU, mesh, cfg.num_kv_heads), CPU,
        max_slots=2, max_seq_len=64, mesh=mesh,
    )
    state = runner.new_state()
    bucket = runner.bucket_for(len(prompt))
    last, k, v = runner.prefill(
        list(prompt) + [0] * (bucket - len(prompt)), len(prompt)
    )
    first = int(runner.sample_first(last, 0.0, 0, 1.0, 0, False,
                                    len(prompt) - 1, 0)[0][0])
    state = runner.insert(state, k, v, 1, len(prompt), first, 0.0, 0, 1.0)
    ids = [first]
    for step in range(steps):
        state, out = runner.decode_step(state, step)
        ids.append(int(out[0][1]))
    return ids, state.last_tokens.numpy(), state.positions.numpy()


def checkpoint_rank(rank, world, coordinator, model_dir, cmd_port, prompt):
    """One rank of a replica set up from outside, through the server's
    environment contract: ``build_engine_from_args`` over a safetensors
    checkpoint with ``--quantization int8``. Returns whether this rank's
    tree equals the slice of the whole quantized tree, and (rank 0) the
    greedy ids it served; a follower replays until the leader closes."""
    import os

    from gpustack_tpu_torch.engine.api_server import (  # analysis: ignore[metrics-drift]
        build_engine_from_args,
        build_parser,
        shutdown_replica,
    )
    from gpustack_tpu_torch.engine.engine import GenRequest  # analysis: ignore[metrics-drift]
    from gpustack_tpu_torch.engine.weights import load_or_init_params  # analysis: ignore[metrics-drift]
    from gpustack_tpu_torch.models.config import load_hf_config  # analysis: ignore[metrics-drift]
    from gpustack_tpu_torch.models.quant import QuantW, quantize_params  # analysis: ignore[metrics-drift]
    from gpustack_tpu_torch.parallel.sharding import shard_params  # analysis: ignore[metrics-drift]

    os.environ.update({
        "GPUSTACK_TPU_COORDINATOR": coordinator,
        "GPUSTACK_TPU_NUM_PROCESSES": str(world),
        "GPUSTACK_TPU_PROCESS_ID": str(rank),
        "GPUSTACK_TPU_CMD_ADDRESS": f"127.0.0.1:{cmd_port}",
        "GPUSTACK_TPU_CMD_TOKEN": "ckpt",
    })
    engine = build_engine_from_args(build_parser().parse_args([
        "--model-dir", model_dir, "--device", "cpu", "--quantization",
        "int8", "--mesh-plan", f"tp{world}", "--max-seq-len", "128",
    ]))
    cfg = load_hf_config(model_dir)
    whole = quantize_params(load_or_init_params(cfg, model_dir, 0, CPU))
    want = shard_params(whole, engine.mesh, cfg.num_kv_heads)

    def leaves(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v)
            elif isinstance(v, QuantW):
                yield v.q
                yield v.s
            else:
                yield v

    same = all(torch.equal(a, b) for a, b in zip(
        leaves(engine.runner.params), leaves(want)))
    if rank:
        engine.follower_loop.start()
        engine.follower_loop.join()
        return same, engine.follower_loop.ops_applied
    engine.start()
    try:
        ids = engine.generate(GenRequest(
            prompt_ids=list(prompt), max_tokens=6, temperature=0.0,
            stop_ids=()), timeout=120).output_ids
    finally:
        engine.stop()
        shutdown_replica(engine)
    return same, ids
