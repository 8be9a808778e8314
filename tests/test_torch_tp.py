"""The port's sharded forward (``models.transformer`` with a mesh,
``parallel.sharding``) against the JAX package's sharded forward
(``shard_params`` on the 8-device CPU mesh, jitted), on ranks of their
own over gloo: ``tp4`` and ``tp2`` on ``tiny``, ``ep2xtp2``, ``ep4`` and
``tp2`` on ``tiny-moe``, ``tp2`` on the tiny GPT-OSS, Gemma (1, 2, 3) and
MLA configs of the families' own test files (their zero-init leaves drawn
at random, so a bias added once per rank or a sink at the wrong heads
shows). Each plan's forwards are a cacheless one, a prefill into a cache
and one decode step, fp32, within 1e-5 of the output's scale (all-reduce
summation order). ``tiny`` at ``tp4`` has 2 KV heads: each rank keeps its
whole KV head. Then greedy ids of a prefill and 8 decode steps through
the ``tp2`` runner against the JAX runner at ``MeshPlan(tp=2)``, and the
ranks' slot states bit for bit.

The spawned ranks run ``tests/torch_tp_workers.py`` (no JAX), each with
one torch thread, on a free port, with a timeout that kills them.
"""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpustack_tpu.engine.runner import ModelRunner as JaxRunner
from gpustack_tpu.models import transformer as jt
from gpustack_tpu.models.config import PRESETS as JAX_PRESETS
from gpustack_tpu.parallel.mesh import MeshPlan as JaxPlan
from gpustack_tpu.parallel.mesh import make_mesh
from gpustack_tpu.parallel.sharding import shard_params
from gpustack_tpu_torch.models.config import get_config  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.parallel.launch import run_ranks  # analysis: ignore[metrics-drift]

import torch_tp_workers as workers

REL = 1e-5
SPAWN_TIMEOUT_S = 240


def _load(name):
    path = os.path.join(os.path.dirname(__file__), f"test_torch_{name}.py")
    spec = importlib.util.spec_from_file_location(f"_tp_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


GPTOSS, GEMMA, MLA = _load("gptoss"), _load("gemma"), _load("mla")


def _plain(preset, seed):
    fields = dict(dtype="float32")
    cfg = dataclasses.replace(get_config(preset), **fields)
    jcfg = dataclasses.replace(JAX_PRESETS[preset], **fields)
    tree = jax.tree.map(np.asarray, jt.init_params(
        jcfg, jax.random.key(seed), dtype=jnp.float32))
    return cfg, jcfg, tree


def _mla(seed):
    cfg, jcfg = MLA._cfgs(MLA._hf())
    tree = jax.tree.map(np.asarray, jt.init_params(
        jcfg, jax.random.key(seed), dtype=jnp.float32))
    return cfg, jcfg, tree


# (name, world, plan, (cfg, jcfg, numpy tree))
CASES = [
    ("tiny-tp4", 4, "tp4", lambda: _plain("tiny", 0)),
    ("tiny-moe-ep2xtp2", 4, "ep2xtp2", lambda: _plain("tiny-moe", 1)),
    ("tiny-moe-ep4", 4, "ep4", lambda: _plain("tiny-moe", 2)),
    ("tiny-tp2", 2, "tp2", lambda: _plain("tiny", 3)),
    ("tiny-moe-tp2", 2, "tp2", lambda: _plain("tiny-moe", 4)),
    ("gptoss-tp2", 2, "tp2", lambda: (*GPTOSS._cfgs(), GPTOSS._tree(
        GPTOSS._cfgs()[1], 5))),
    *[(f"{fam}-tp2", 2, "tp2",
       lambda fam=fam: (*GEMMA._cfgs(fam), GEMMA._tree(GEMMA._cfgs(fam)[1],
                                                       6)))
      for fam in sorted(GEMMA.FAMILIES)],
    ("mla-tp2", 2, "tp2", lambda: _mla(7)),
]
B, T, S = 2, 8, 16


def _jax_forwards(jcfg, tree, toks, plan):
    """The JAX package's sharded forwards: the same three as the
    workers' ``_forwards``."""
    mesh = make_mesh(JaxPlan.parse(plan))
    params = shard_params(jax.tree.map(jnp.asarray, tree), mesh)
    t = jnp.asarray(toks, jnp.int32)
    pos = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32), (B, T))
    fwd = jax.jit(lambda p, tk, ps, c: jt.forward(p, jcfg, tk, ps, c))
    plain = jax.jit(lambda p, tk, ps: jt.forward(p, jcfg, tk, ps)[0])(
        params, t, pos)
    cache = jt.KVCache.create(jcfg, B, S, jnp.float32)
    pre, cache = fwd(params, t, pos, cache)
    nxt = jnp.asarray((toks[:, -1:] * 7 + 3) % jcfg.vocab_size, jnp.int32)
    dec, _ = fwd(params, nxt, jnp.full((B, 1), T, jnp.int32), cache)
    return [np.asarray(x, np.float32) for x in (plain, pre, dec)]


@pytest.fixture(scope="module")
def results():
    """Every case through the port's ranks (one spawn per world size)
    and through JAX."""
    rng = np.random.default_rng(0)
    got, want, spawns = {}, {}, {}
    for name, world, plan, make in CASES:
        cfg, jcfg, tree = make()
        toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int64)
        spawns.setdefault(world, []).append((name, cfg, plan, tree, toks, S))
        want[name] = _jax_forwards(jcfg, tree, toks, plan)
    for world, cases in spawns.items():
        ranks = run_ranks(workers.forward_cases, world, cases,
                          timeout=SPAWN_TIMEOUT_S, threads=1)
        for name in ranks[0]:
            for other in ranks[1:]:
                for a, b in zip(ranks[0][name], other[name]):
                    np.testing.assert_array_equal(a, b)
        got.update(ranks[0])
    return got, want


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_sharded_forward_matches_jax(results, name):
    got, want = results
    for mode, g, w in zip(("plain", "prefill", "decode"), got[name],
                          want[name]):
        assert g.shape == w.shape, mode
        err = float(np.abs(g - w).max())
        scale = float(np.abs(w).max())
        assert err <= REL * scale, (name, mode, err, scale)


def _jax_greedy(jcfg, jparams, prompt, steps):
    plan = JaxPlan(tp=2)
    runner = JaxRunner(jcfg, jparams, plan=plan, mesh=make_mesh(plan),
                       max_slots=2, max_seq_len=64)
    state = runner.new_state()
    bucket = runner.bucket_for(len(prompt))
    last, k, v = runner.prefill(
        list(prompt) + [0] * (bucket - len(prompt)), len(prompt))
    key = jax.random.key(0)
    first = int(np.asarray(runner.sample_first(
        last, 0.0, 0, 1.0, 0, False, len(prompt) - 1, key)[0])[0])
    state = runner.insert(state, k, v, 1, len(prompt), first, 0.0, 0, 1.0)
    ids = [first]
    for _ in range(steps):
        state, out = runner.decode_step(state, key)
        ids.append(int(np.asarray(out[0])[1]))
    return ids


def test_greedy_ids_tp2_runner_match_jax():
    """``tiny`` as served (bf16): the port's tp2 runner and JAX's runner
    at ``MeshPlan(tp=2)`` pick the same ids; both ranks end with the same
    slot state."""
    jcfg = JAX_PRESETS["tiny"]
    jparams = jt.init_params(jcfg, jax.random.key(11))
    tree = jax.tree.map(np.asarray, jparams)
    prompt = [5, 17, 42, 9, 100, 3, 77]
    want = _jax_greedy(jcfg, jparams, prompt, 8)
    ranks = run_ranks(workers.greedy_tp, 2, get_config("tiny"), tree,
                      prompt, 8, "tp2", timeout=SPAWN_TIMEOUT_S, threads=1)
    assert ranks[0][0] == ranks[1][0] == want
    for i in (1, 2):
        np.testing.assert_array_equal(ranks[0][i], ranks[1][i])
