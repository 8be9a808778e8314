"""Ring attention and the sequence-sharded cache merge in the PyTorch port
(``ops/ring_attention.py``), against the JAX package's
``sharded_prefill_attention`` and ``sp_cache_attention`` on the 8-device
CPU mesh, in fp32 within 1e-5: under ``sp2``, ``sp4`` and ``sp2xtp2``,
the port's ranks on gloo (one process each), each holding its block of
the sequence (and under ``tp`` its heads), their outputs put back
together. Then the flash kernel's LSE mode through its plain version
(``flash_attention_lse_ref``): the LSE against ``torch.logsumexp`` of
each row's visible scores, the output against the causal plain version,
and a whole sequence's attention rebuilt from blocks of its keys with
``merge_partials``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from gpustack_tpu.ops.ring_attention import (
    sharded_prefill_attention,
    sp_cache_attention,
)
from gpustack_tpu.parallel.mesh import MeshPlan as JaxPlan
from gpustack_tpu.parallel.mesh import make_mesh
from gpustack_tpu_torch.ops import ring_attention as ra  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.ops.flash_attention import (  # analysis: ignore[metrics-drift]
    flash_attention_lse,
    flash_attention_lse_ref,
    flash_attention_prefill,
    flash_attention_prefill_ref,
)
from gpustack_tpu_torch.parallel.launch import run_ranks  # analysis: ignore[metrics-drift]

import torch_sp_workers as workers

TOL = 1e-5
PLANS = [("sp2", 2), ("sp4", 4), ("sp2xtp2", 4)]
B, T, HQ, HKV, D = 2, 32, 4, 2, 16
S_CACHE, T_CACHE = 32, 3
SCALE = D ** -0.5
SPAWN_TIMEOUT_S = 240


def _inputs(seed):
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    ring = (draw(B, T, HQ, D), draw(B, T, HKV, D), draw(B, T, HKV, D))
    cache = (draw(B, T_CACHE, HQ, D), draw(B, S_CACHE, HKV, D),
             draw(B, S_CACHE, HKV, D))
    # the last query of row 0 sees into the second block; row 1 sees it all
    positions = np.array([[10, 11, 20], [29, 30, 31]], np.int64)
    return ring, cache, positions


def _jax(plan, ring, cache, positions):
    mesh = make_mesh(JaxPlan.parse(plan))
    q, k, v = ring
    g = HQ // HKV
    pos = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32), (B, T))
    ring_out = sharded_prefill_attention(
        mesh, jnp.asarray(q).reshape(B, T, HKV, g, D), jnp.asarray(k),
        jnp.asarray(v), pos, SCALE)
    cq, ck, cv = cache
    cache_out = sp_cache_attention(
        mesh, jnp.asarray(cq).reshape(B, T_CACHE, HKV, g, D),
        jnp.asarray(ck), jnp.asarray(cv),
        jnp.asarray(positions, jnp.int32), SCALE)
    return np.asarray(ring_out), np.asarray(cache_out)


def _assemble(parts, seq_blocks):
    """Rank outputs (sp index, tp index, block) back into the whole:
    heads side by side, then (ring) sequence blocks one after another."""
    by_seq = {}
    for i, j, out in parts:
        by_seq.setdefault(i, {})[j] = out
    rows = [np.concatenate([by_seq[i][j] for j in sorted(by_seq[i])],
                           axis=-1) for i in sorted(by_seq)]
    return np.concatenate(rows, axis=1) if seq_blocks else rows[0]


@pytest.fixture(scope="module")
def results():
    got, want, spawns = {}, {}, {}
    for n, (plan, world) in enumerate(PLANS):
        ring, cache, positions = _inputs(n)
        want[plan] = _jax(plan, ring, cache, positions)
        spawns.setdefault(world, []).extend([
            (f"{plan}-ring", plan, *ring, None, None, SCALE),
            (f"{plan}-cache", plan, *cache, positions, True, SCALE),
        ])
    for world, cases in spawns.items():
        ranks = run_ranks(workers.attention_cases, world, cases,
                          timeout=SPAWN_TIMEOUT_S, threads=1)
        for name, *_ in cases:
            parts = [r[name] for r in ranks]
            if name.endswith("-ring"):
                got[name] = _assemble(parts, seq_blocks=True)
            else:
                # every sp rank ends with the same merged rows
                for i, j, out in parts:
                    same = [o for ii, jj, o in parts if jj == j]
                    for o in same:
                        np.testing.assert_array_equal(o, out)
                got[name] = _assemble(
                    [(0, j, o) for i, j, o in parts if i == 0],
                    seq_blocks=False)
    return got, want


@pytest.mark.parametrize("plan", [p for p, _ in PLANS])
def test_ring_attention_matches_jax(results, plan):
    got, want = results
    g, w = got[f"{plan}-ring"], want[plan][0]
    assert g.shape == w.shape == (B, T, HQ * D)
    assert float(np.abs(g - w).max()) <= TOL


@pytest.mark.parametrize("plan", [p for p, _ in PLANS])
def test_sp_cache_attention_matches_jax(results, plan):
    got, want = results
    g, w = got[f"{plan}-cache"], want[plan][1]
    assert g.shape == w.shape == (B, T_CACHE, HQ * D)
    assert float(np.abs(g - w).max()) <= TOL


def _qkv(seed, t, s, hq=HQ, hkv=HKV):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(B, t, hq, D, generator=gen),
            torch.randn(B, s, hkv, D, generator=gen),
            torch.randn(B, s, hkv, D, generator=gen))


@pytest.mark.parametrize("q_offset", [0, 5, T, 3 * T])
def test_lse_plain_version_against_logsumexp(q_offset):
    """Each row's LSE is ``torch.logsumexp`` of its visible scaled
    scores, taken row by row; the output is the causal plain version's."""
    q, k, v = _qkv(q_offset, T, T)
    out, lse = flash_attention_lse_ref(q, k, v, SCALE, q_offset)
    assert out.dtype == lse.dtype == torch.float32
    assert out.shape == (B, T, HQ * D) and lse.shape == (B, HQ, T)
    g = HQ // HKV
    for b in range(B):
        for h in range(HQ):
            for t in range(T):
                keys = min(T, q_offset + t + 1)
                s = (q[b, t, h] @ k[b, :keys, h // g].T) * SCALE
                want = torch.logsumexp(s, dim=0)
                assert abs(float(lse[b, h, t] - want)) <= 1e-5
    want = flash_attention_prefill_ref(q, k, v, SCALE, q_offset)
    assert float((out - want).abs().max()) <= TOL


def test_lse_wrapper_takes_the_plain_version_on_the_cpu():
    q, k, v = _qkv(1, T, T)
    before = flash_attention_prefill.launches
    got = flash_attention_lse(q, k, v, SCALE, 7)
    want = flash_attention_lse_ref(q, k, v, SCALE, 7)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert flash_attention_prefill.launches == before


@pytest.mark.parametrize("blocks", [2, 4])
def test_merged_blocks_equal_the_whole(blocks):
    """The last query block of a sequence against each key block (the
    visible ones whole, its own causal), merged, against one causal pass
    over all the keys: what rank ``blocks - 1`` of a ring computes."""
    n = T // blocks
    q, k, v = _qkv(blocks, T, T)
    qb = q[:, -n:]
    outs, lses = [], []
    for src in range(blocks):
        o, lse = flash_attention_lse_ref(
            qb, k[:, src * n:(src + 1) * n], v[:, src * n:(src + 1) * n],
            SCALE, (blocks - 1 - src) * n)
        outs.append(o)
        lses.append(lse)
    merged = ra.merge_partials(outs, lses)
    whole = flash_attention_prefill_ref(q, k, v, SCALE)[:, -n:]
    assert float((merged - whole).abs().max()) <= TOL


def test_merge_of_one_block_is_that_block():
    q, k, v = _qkv(9, 8, 8)
    o, lse = flash_attention_lse_ref(q, k, v, SCALE)
    assert ra.merge_partials([o], [lse]) is o
