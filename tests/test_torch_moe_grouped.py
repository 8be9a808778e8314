"""The routed MoE path of the PyTorch port: its bookkeeping and the plain
versions of its grouped expert kernels, against numpy and the JAX package.

``moe_dispatch`` (the pairs' sorted order, the experts' segment bounds and
the inverse) against a numpy reference, at the routings that stress the
kernels: an expert no token picked, every token on one expert, segments
ending exactly at and one past a tile of 64 and of 128 rows, one token,
and k = E. A Python mirror of the persistent grouped kernel's schedule
(``csrc/w8a16_gemm.cu`` ``Walk`` and ``grouped_wgmma``: the units the
offsets make, each CTA's share of them) stores every routed output once,
by its own expert, with CTAs' shares within one unit of each other; the
plan (``grouped_plan``) at every served MoE product. The
grouped plain versions (``w8a16_grouped_plain``, ``bf16_grouped_plain``)
against the 2-D plain version per segment (bit for bit) and against the
JAX ``_mm`` / ``einsum`` over the expert axis at each pair's (token,
expert) (fp32, 1e-5: summation order only). The wrappers refuse what the
kernel cannot take. Inputs come from numpy with a seed.
"""

import importlib.util
import os

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


class _Walk:
    """Mirror of ``Walk`` (``csrc/w8a16_gemm.cu``): expert e's rows [lo,
    hi) make R = ceil((hi - lo) / bm) row units in each of T column
    strips, units [ub, ue) strip by strip; ``at`` only steps forward
    through the experts, as each role of a CTA asks for its units in
    rising order."""

    def __init__(self, off, bm, bn, T):
        self.off, self.bm, self.bn, self.T = off, bm, bn, T
        self.e, self.lo, self.hi, self.ub = 0, off[0], off[1], 0
        self.ue = self.row_units(self.hi - self.lo) * T

    def row_units(self, rows):
        return (max(rows, 0) + self.bm - 1) // self.bm

    def at(self, u):
        while u >= self.ue:
            self.e += 1
            self.lo, self.hi = self.hi, self.off[self.e + 1]
            self.ub = self.ue
            self.ue += self.row_units(self.hi - self.lo) * self.T
        c, r = divmod(u - self.ub, self.row_units(self.hi - self.lo))
        return self.e, self.lo + r * self.bm, self.hi, c * self.bn


def _cta_units(off, bm, bn, N, grid):
    """Mirror of ``grouped_wgmma``'s schedule: the prologue's total of
    units (each lane sums experts lane, lane + 32, ...; the warp adds them
    up), then CTA b's units b, b + grid, ... through its own walk; a CTA
    with none leaves. Returns [[(expert, m0, m_end, n0), ...] per CTA]."""
    E, T = len(off) - 1, -(-N // bn)
    probe = _Walk(off, bm, bn, T)
    lanes = [sum(probe.row_units(off[e + 1] - off[e])
                 for e in range(lane, E, 32)) for lane in range(32)]
    U = sum(lanes) * T
    ctas = []
    for b in range(grid):
        mine = (U - b - 1) // grid + 1 if U > b else 0
        walk = _Walk(off, bm, bn, T)
        ctas.append([walk.at(b + i * grid) for i in range(mine)])
    return ctas


def _check_schedule(off, bm, bn, N, grid):
    """Every routed (row, column) stored exactly once, by its own expert's
    unit; rows outside [off[0], off[E]) never stored; CTAs' unit counts
    within one of each other; in ping-pong (bm 64) the two consumers'
    shares (units i % 2) also within one."""
    E = len(off) - 1
    P = max(off[-1], 1)
    hits = np.zeros((P, N), dtype=np.int64)
    ctas = _cta_units(off, bm, bn, N, grid)
    for units in ctas:
        for e, m0, m_end, n0 in units:
            assert off[e] <= m0 < m_end == off[e + 1]
            assert 0 <= n0 < N and n0 % bn == 0
            hits[m0:min(m0 + bm, m_end), n0:n0 + bn] += 1
    want = np.zeros_like(hits)
    want[off[0]:off[E]] = 1
    np.testing.assert_array_equal(hits, want)
    counts = [len(u) for u in ctas]
    assert max(counts) - min(counts) <= 1
    T = -(-N // bn)
    assert sum(counts) == T * sum(-(-(b - a) // bm)
                                  for a, b in zip(off, off[1:]))
    for units in ctas:
        assert len(units[0::2]) - len(units[1::2]) in (0, 1)
    return ctas


@pytest.mark.parametrize("bm", [64, 128])
@pytest.mark.parametrize("kind", KINDS)
def test_unit_walk_stores_every_output_once(kind, bm):
    """The grouped kernel's units over each routing's offsets, at a width
    that pads its last column tile (N 320 at BN 128)
    and one that fits (N 384 at BN 192), on a grid of 7 CTAs and on one
    of 132 (more CTAs than units leave at once)."""
    rng = np.random.default_rng(KINDS.index(kind))
    top, E = _routing(kind, rng)
    _, offsets, _ = pt.moe_dispatch(top, E)
    off = offsets.tolist()
    for N, bn in ((320, 128), (384, 192)):
        for grid in (7, 132):
            _check_schedule(off, bm, bn, N, grid)


def _segments(counts, start=0):
    return [start] + (start + np.cumsum(counts)).tolist()


@pytest.mark.parametrize("bm", [64, 128])
@pytest.mark.parametrize("case", [
    "ep_slice", "e33", "e129", "segment_bm", "segment_bm_plus1",
    "above_the_table",
])
def test_unit_walk_edge_offsets(case, bm):
    """Offsets the routing kinds do not reach: an ``ep`` rank's slice
    (offsets[0] > 0, offsets[E] < P: the other ranks' rows unwritten),
    33 and 129 experts (past a warp's lanes, once and four times), every
    segment exactly BM or BM + 1 rows, and more experts than a CTA copies
    into shared memory (its walk reads the same bounds from memory)."""
    rng = np.random.default_rng(len(case) + bm)
    if case == "ep_slice":
        full = _segments(rng.integers(0, 3 * bm, size=8))
        off = full[2:7]
        assert off[0] > 0 and off[-1] < full[-1]
    elif case in ("e33", "e129"):
        E = int(case[1:])
        counts = rng.integers(0, 3 * bm, size=E)
        counts[[0, 31, 32]] = [0, bm, bm + 1]
        off = _segments(counts)
    elif case == "above_the_table":
        E = w8a16.GROUPED_TABLE_EXPERTS + 9
        off = _segments(rng.integers(0, 3, size=E))
    else:
        extra = case.endswith("plus1")
        off = _segments([bm + extra] * 5)
    for N, bn in ((320, 128), (384, 192), (256, 256)):
        for grid in (5, 132):
            ctas = _check_schedule(off, bm, bn, N, grid)
            rows = [m0 for units in ctas for _, m0, _, _ in units]
            assert min(rows) == off[0] and max(rows) < off[-1]


def _served_products():
    """chip_smoke.py's GROUPED_PRODUCTS, the products its phase c times:
    {name: (E, top-k, K, N, weight types served)}."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.GROUPED_PRODUCTS


_PRODUCTS = _served_products()


@pytest.mark.parametrize("n", [8, 2048])
@pytest.mark.parametrize("product", sorted(_PRODUCTS))
def test_grouped_plan_at_the_served_products(product, n):
    """The plan of every served MoE product at a decode step's 8 tokens
    and the 2048 bucket. BM: int8 128 always, bf16 128 only from
    GROUPED_BM128_ROWS mean rows an expert. BN: the width whose units load
    the fewest bytes of x and weight tiles (each column tile reloads its
    x rows), so 256 at every served width, 2880 and 1408 included, where
    the fitted 192 and 128 would pad nothing but load more. Grid: at most
    one CTA per SM, no more than the worst case of units, and a
    uniform routing's units spread over it within one a CTA."""
    E, k, K, N, types = _PRODUCTS[product]
    P = n * k
    for sms in (132, 114):
        for wtype in types:
            int8 = wtype == "int8"
            bm, bn, grid = w8a16.grouped_plan(P, E, N, sms, int8)
            assert bm == (128 if int8 or P >= w8a16.GROUPED_BM128_ROWS * E
                          else 64)
            wb = 1 if int8 else 2
            assert bn in w8a16.GROUPED_BN[wtype]
            loaded = {w: (-(-N // w) * 64 * (2 * bm + wb * w), -(-N // w))
                      for w in w8a16.GROUPED_BN[wtype]}
            assert loaded[bn] == min(loaded.values())
            assert bn == 256
            if N in (2880, 1408):
                assert -(-N // bn) * bn - N == {2880: 192, 1408: 128}[N]
            worst = (-(-P // bm) + min(E, P)) * -(-N // bn)
            assert 1 <= grid == min(sms, worst) <= sms
            counts = np.bincount(np.arange(P) % E, minlength=E)
            _check_schedule(_segments(counts), bm, bn, min(N, 512), grid)


def test_grouped_plan_fits_narrow_widths():
    """Where a narrower tile loads fewer bytes it wins: 192 at N 320 (two
    tiles of 192 against two of 256) and 1040, and at the gate shards of a
    tensor-parallel rank that ``hack/torch_grouped_ab.py --narrow`` times
    (qwen3-30b-a3b's 192 under tp4 and 384 under tp2, deepseek-v2-lite's
    352 under tp4), 128 at N 128; int8 never takes 192 (its widening
    stage maps 128 and 256)."""
    plan = w8a16.grouped_plan
    for E, k, N in ((128, 8, 192), (128, 8, 384), (64, 6, 352)):
        assert plan(2048 * k, E, N, 132, False)[:2] == (64, 192)
    assert plan(300, 4, 320, 132, False)[1] == 192
    assert plan(300, 4, 1040, 132, False)[1] == 192
    assert plan(300, 4, 128, 132, False)[1] == 128
    assert plan(300, 4, 320, 132, True)[:2] == (128, 256)
    assert plan(300, 4, 128, 132, True)[:2] == (128, 128)


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
