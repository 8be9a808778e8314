"""The routed MoE path of the PyTorch port: its bookkeeping and the plain
versions of its grouped expert kernels, against numpy and the JAX package.

``moe_dispatch`` (the pairs' sorted order, the experts' segment bounds and
the inverse) against a numpy reference, at the routings that stress the
kernels: an expert no token picked, every token on one expert, segments
ending exactly at and one past a tile of 64 and of 128 rows, one token,
and k = E. A Python mirror of the grouped ``wgmma`` CTA's prologue (the
tile walk in ``csrc/w8a16_gemm.cu`` ``find_tile``) covers every routed row
once and stays within the grid the host sizes without the counts. The
grouped plain versions (``w8a16_grouped_plain``, ``bf16_grouped_plain``)
against the 2-D plain version per segment (bit for bit) and against the
JAX ``_mm`` / ``einsum`` over the expert axis at each pair's (token,
expert) (fp32, 1e-5: summation order only). The wrappers refuse what the
kernel cannot take. Inputs come from numpy with a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpustack_tpu.models import quant as jq
from gpustack_tpu.models import transformer as jt
from gpustack_tpu_torch.models import transformer as pt  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models.quant import QuantW  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.ops import w8a16  # analysis: ignore[metrics-drift]

FP32_TOL = dict(rtol=1e-5, atol=1e-5)


def _routing(kind, rng):
    """(top_idx [n, k] int64, E) for one routing kind: each token's k
    distinct experts."""
    if kind == "random":
        n, k, E = 37, 3, 8
        top = [rng.choice(E, size=k, replace=False) for _ in range(n)]
    elif kind == "empty_expert":
        n, k, E = 20, 2, 8
        top = [rng.choice([0, 1, 2, 4, 5, 6, 7], size=k, replace=False)
               for _ in range(n)]
    elif kind == "one_expert":
        n, k, E = 50, 1, 8
        top = [[5]] * n
    elif kind.startswith("tile"):
        # expert 0's segment ends at (or one past) a tile of BM rows: BM
        # (+ 1) tokens pick 0, the rest spread over 1..3
        bm, extra = {"tile64": (64, 0), "tile64_plus1": (64, 1),
                     "tile128": (128, 0), "tile128_plus1": (128, 1)}[kind]
        n, k, E = 150, 2, 4
        top = [[0, 1 + i % 3] if i < bm + extra else
               list(rng.choice([1, 2, 3], size=2, replace=False))
               for i in range(n)]
    elif kind == "single_token":
        n, k, E = 1, 2, 8
        top = [[6, 2]]
    elif kind == "k_equals_e":
        n, k, E = 9, 4, 4
        top = [rng.permutation(E) for _ in range(n)]
    else:
        raise ValueError(kind)
    return torch.from_numpy(np.asarray(top, dtype=np.int64)), E


KINDS = ["random", "empty_expert", "one_expert", "tile64", "tile64_plus1",
         "tile128", "tile128_plus1", "single_token", "k_equals_e"]


@pytest.mark.parametrize("kind", KINDS)
def test_dispatch_matches_numpy(kind):
    rng = np.random.default_rng(KINDS.index(kind))
    top, E = _routing(kind, rng)
    perm, offsets, inv = pt.moe_dispatch(top, E)
    pairs = top.flatten().numpy()
    want_perm = np.argsort(pairs, kind="stable")
    want_off = np.concatenate(
        [[0], np.cumsum(np.bincount(pairs, minlength=E))]
    )
    assert offsets.dtype == torch.int32 and offsets.shape == (E + 1,)
    np.testing.assert_array_equal(perm.numpy(), want_perm)
    np.testing.assert_array_equal(offsets.numpy(), want_off)
    np.testing.assert_array_equal(inv.numpy(), np.argsort(want_perm))
    # each segment holds its expert's pairs in token order
    sorted_e = pairs[want_perm]
    for e in range(E):
        seg = slice(want_off[e], want_off[e + 1])
        assert (sorted_e[seg] == e).all()
        assert (np.diff(want_perm[seg]) > 0).all()


def _tile_walk(offsets, tile, bm):
    """Mirror of ``find_tile`` (``csrc/w8a16_gemm.cu``) as the warp runs
    it: lanes take experts 32 at a time, an inclusive scan of their tile
    counts places each expert's first tile, and the lane whose expert
    holds ``tile`` answers (expert, first row, end row); None past the
    last tile."""
    E = len(offsets) - 1
    before, found = 0, None
    for e0 in range(0, E, 32):
        lanes = range(e0, e0 + 32)
        lo = [offsets[e] if e < E else 0 for e in lanes]
        hi = [offsets[e + 1] if e < E else 0 for e in lanes]
        nt = [-(-(h - lo_) // bm) for lo_, h in zip(lo, hi)]
        incl = np.cumsum(nt)
        for lane in range(32):
            first = before + incl[lane] - nt[lane]
            if first <= tile < first + nt[lane]:
                assert found is None
                found = (e0 + lane, lo[lane] + (tile - first) * bm, hi[lane])
        before += int(incl[31])
    return found


@pytest.mark.parametrize("bm", [64, 128])
@pytest.mark.parametrize("kind", KINDS)
def test_tile_walk_covers_every_row_once(kind, bm):
    """Every grouped CTA of the worst-case grid (ceil(P / bm) + E row
    tiles) runs the walk: the tiles found cover each routed row exactly
    once, each with its own expert, rows stored only before the segment's
    end; the others exit. A 33-expert variant crosses the warp's lanes."""
    rng = np.random.default_rng(KINDS.index(kind))
    top, E = _routing(kind, rng)
    _, offsets, _ = pt.moe_dispatch(top, E)
    cases = [offsets.tolist()]
    counts = rng.integers(0, 3 * bm, size=33)
    counts[[0, 31, 32]] = [0, bm, bm + 1]
    cases.append([0] + np.cumsum(counts).tolist())
    for off in cases:
        E_, P = len(off) - 1, off[-1]
        grid = w8a16.grouped_tiles(P, E_) if bm == 128 else (
            -(-P // bm) + E_
        )
        covered = np.zeros(P, dtype=np.int64)
        used = 0
        for t in range(grid):
            found = _tile_walk(off, t, bm)
            if found is None:
                continue
            used += 1
            e, m0, m_end = found
            assert off[e] <= m0 < m_end == off[e + 1]
            covered[m0:min(m0 + bm, m_end)] += 1
        assert used == sum(-(-(b - a) // bm) for a, b in zip(off, off[1:]))
        assert used <= grid
        np.testing.assert_array_equal(covered, np.ones(P, dtype=np.int64))


def _gemv_ctas(offsets):
    """Mirror of the grouped GEMV's early exit: the experts whose CTAs
    read weights (a segment with rows), each over its own rows."""
    return [(e, a, b - a) for e, (a, b) in enumerate(zip(offsets,
                                                          offsets[1:]))
            if b > a]


@pytest.mark.parametrize("kind", KINDS)
def test_gemv_reads_only_picked_experts(kind):
    rng = np.random.default_rng(KINDS.index(kind))
    top, E = _routing(kind, rng)
    _, offsets, _ = pt.moe_dispatch(top, E)
    ctas = _gemv_ctas(offsets.tolist())
    assert [e for e, _, _ in ctas] == sorted(set(top.flatten().tolist()))
    # a token picks an expert at most once: its chunk's rows bound every
    # segment (the GEMV's B tiles are sized by that bound)
    assert max(rows for _, _, rows in ctas) <= top.shape[0]


def _pairs_inputs(kind, K, seed):
    rng = np.random.default_rng(seed)
    top, E = _routing(kind, rng)
    n, k = top.shape
    perm, offsets, _ = pt.moe_dispatch(top, E)
    tok, ex = perm // k, top.flatten()[perm]
    return rng, top, E, n, perm, offsets, tok, ex


@pytest.mark.parametrize("kind", ["random", "empty_expert", "one_expert",
                                  "single_token", "k_equals_e"])
def test_grouped_int8_plain_matches_jax_mm(kind):
    K, N = 24, 32
    rng, top, E, n, perm, offsets, tok, ex = _pairs_inputs(kind, K, 1)
    w = (rng.standard_normal((1, E, K, N)) / np.sqrt(K)).astype(np.float32)
    jw = jq._quantize_leaf("we_gate", jnp.asarray(w))
    jqw = jq.QuantW(q=jw.q[0], s=jw.s[0])
    q = torch.from_numpy(np.array(jqw.q))
    s = torch.from_numpy(np.array(jqw.s.astype(jnp.float32))).bfloat16()
    x = rng.standard_normal((1, n, K)).astype(np.float32)
    want = jt._mm("btd,edf->btef", jnp.asarray(x),
                  jq.QuantW(q=jqw.q, s=jnp.asarray(s.float().numpy())))
    xs = torch.from_numpy(x[0])[tok]
    got = w8a16.w8a16_grouped(xs, q, s, offsets, n)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(want)[0][tok.numpy(), ex.numpy()],
        **FP32_TOL
    )
    bounds = offsets.tolist()
    for dtype in (torch.float32, torch.bfloat16):
        got = w8a16.w8a16_grouped_plain(xs.to(dtype), q, s, offsets)
        assert got.dtype == dtype
        for e in range(E):
            rows = slice(bounds[e], bounds[e + 1])
            assert torch.equal(
                got[rows], w8a16.w8a16_plain(xs.to(dtype)[rows], q[e], s[e])
            )


@pytest.mark.parametrize("kind", ["random", "empty_expert", "one_expert",
                                  "single_token", "k_equals_e"])
def test_grouped_bf16_plain_matches_jax_einsum(kind):
    K, N = 24, 32
    rng, top, E, n, perm, offsets, tok, ex = _pairs_inputs(kind, K, 2)
    w = (rng.standard_normal((E, K, N)) / np.sqrt(K)).astype(np.float32)
    x = rng.standard_normal((1, n, K)).astype(np.float32)
    want = jt._mm("btd,edf->btef", jnp.asarray(x), jnp.asarray(w))
    xs = torch.from_numpy(x[0])[tok]
    got = w8a16.bf16_grouped(xs, torch.from_numpy(w), offsets, n)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(want)[0][tok.numpy(), ex.numpy()],
        **FP32_TOL
    )
    # bf16: each segment's fp32 product rounded once
    xb, wb = xs.bfloat16(), torch.from_numpy(w).bfloat16()
    got = w8a16.bf16_grouped_plain(xb, wb, offsets)
    bounds = offsets.tolist()
    for e in range(E):
        rows = slice(bounds[e], bounds[e + 1])
        assert torch.equal(
            got[rows], (xb[rows].float() @ wb[e].float()).bfloat16()
        )


def test_grouped_wrappers_take_the_plain_version_on_the_cpu():
    """A CPU tensor never launches: the counts stay."""
    rng, top, E, n, perm, offsets, tok, ex = _pairs_inputs("random", 16, 3)
    xs = torch.from_numpy(rng.standard_normal((len(perm), 16))).float()
    q = torch.from_numpy(rng.integers(-127, 128, (E, 16, 16))).to(torch.int8)
    s = torch.rand(E, 16).bfloat16()
    before = (w8a16.w8a16_grouped.launches, w8a16.bf16_grouped.launches)
    w8a16.w8a16_grouped(xs, q, s, offsets, n)
    w8a16.bf16_grouped(xs, q.float(), offsets, n)
    assert (w8a16.w8a16_grouped.launches,
            w8a16.bf16_grouped.launches) == before


def _good(E=4, P=12, K=16, N=32, int8=True):
    x = torch.zeros(P, K, dtype=torch.bfloat16)
    w = torch.zeros(E, K, N, dtype=torch.int8 if int8 else torch.bfloat16)
    s = torch.zeros(E, N, dtype=torch.bfloat16) if int8 else None
    return x, w, s, torch.zeros(E + 1, dtype=torch.int32)


@pytest.mark.parametrize("bad,error", [
    ("x_fp32", TypeError), ("offsets_int64", TypeError),
    ("w_fp32", TypeError), ("n_ragged", ValueError), ("k_ragged", ValueError),
    ("offsets_short", ValueError), ("w_strided", ValueError),
    ("s_shape", ValueError),
])
def test_grouped_kernel_refuses_what_it_cannot_take(bad, error):
    """The checks a card tensor meets before the launch (device-free
    metadata, so they run here on CPU tensors)."""
    x, w, s, offsets = _good()
    if bad == "x_fp32":
        x = x.float()
    elif bad == "offsets_int64":
        offsets = offsets.long()
    elif bad == "w_fp32":
        w = w.float()
    elif bad == "n_ragged":
        x, w, s, offsets = _good(N=24)
    elif bad == "k_ragged":
        x, w, s, offsets = _good(K=12)
    elif bad == "offsets_short":
        offsets = offsets[:-1]
    elif bad == "w_strided":
        w = torch.zeros(4, 16, 64, dtype=torch.int8)[:, :, :32]
    elif bad == "s_shape":
        s = s[:, :16]
    with pytest.raises(error):
        w8a16._check_grouped(x, w, s, offsets)
    x, w, _, offsets = _good(int8=False)
    w8a16._check_grouped(x, w, None, offsets)          # bf16 experts pass
    with pytest.raises(TypeError):
        w8a16._check_grouped(x, w.to(torch.int8), None, offsets)


def test_moe_mlp_int8_routes_through_the_grouped_product():
    """``_moe_mlp`` over int8 ``QuantW`` experts on the CPU equals a
    per-token loop over each token's own experts through ``w8a16_plain``
    (fp32): the routed formulation, summed in fp32."""
    import dataclasses

    from gpustack_tpu_torch.models.config import get_config  # analysis: ignore[metrics-drift]

    D, E, F, k = 16, 6, 32, 2
    cfg = dataclasses.replace(
        get_config("tiny-moe"), num_experts=E, num_experts_per_tok=k,
        moe_intermediate_size=F, hidden_size=D, dtype="float32",
    )
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((1, 11, D)).astype(np.float32))
    router = torch.from_numpy(rng.standard_normal((D, E)).astype(np.float32))

    def qw(*shape):
        return QuantW(
            q=torch.from_numpy(rng.integers(-127, 128, shape)).to(torch.int8),
            s=(torch.rand(shape[0], shape[-1]) * 0.01).bfloat16(),
        )

    wg, wu, wd = qw(E, D, F), qw(E, D, F), qw(E, F, D)
    got = pt._moe_mlp(x, router, wg, wu, wd, cfg)[0]
    top, combine = pt.moe_route(x[0], router, cfg)
    want = torch.zeros(11, D)
    for t in range(11):
        for e in top[t].tolist():
            xt = x[0, t:t + 1]
            h = torch.nn.functional.silu(
                w8a16.w8a16_plain(xt, wg.q[e], wg.s[e])
            ) * w8a16.w8a16_plain(xt, wu.q[e], wu.s[e])
            want[t] += combine[t, e] * w8a16.w8a16_plain(h, wd.q[e], wd.s[e])[0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), **FP32_TOL)
