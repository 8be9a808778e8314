"""Host KV tiers of the PyTorch port against the JAX package's.

The port keeps its own copies of ``kv_host_cache`` (radix block trie,
leaf-only eviction, int8 tier), ``kv_spill`` (one file per evicted block)
and the ``kv_transfer`` frame codec; bf16 K/V live on the host as
``uint16`` bit patterns instead of ``ml_dtypes.bfloat16``.

The parity tests drive one scripted sequence of inserts, probes, an
eviction with spill, fault-backs, an export and an import through both
packages' caches on the same numpy K/V (the JAX side gets its
``ml_dtypes`` bf16 arrays, the port the same bits as ``uint16``) and
require the two traces to be equal: every count, every chain key, the
eviction order, and every byte of the gathered K/V, the int8 blocks and
scales, the spill files and the wire frames. Tolerance: none (bit for
bit). The unit tests below mirror ``tests/engine/test_kv_host_cache.py``,
``tests/engine/test_kv_spill.py`` and the codec tests of
``tests/engine/test_kv_transfer.py`` on the port alone.
"""

import os

import ml_dtypes
import numpy as np
import pytest

from gpustack_tpu.engine import kv_host_cache as jax_cache_mod
from gpustack_tpu.engine import kv_spill as jax_spill_mod
from gpustack_tpu.engine import kv_transfer as jax_kt
from gpustack_tpu_torch.engine import kv_host_cache as port_cache_mod  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine import kv_spill as port_spill_mod  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine import kv_transfer as port_kt  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.host_bf16 import bf16_bits_to_f32  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.kv_host_cache import HostKVCache  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.kv_spill import (  # analysis: ignore[metrics-drift]
    SPILL_SUFFIX,
    DiskKVSpill,
    encode_spill_frame,
)

L, H, HD = 2, 2, 4   # toy KV dims, as the JAX package's tests
BT = 4

JAX = (jax_cache_mod, jax_spill_mod, jax_kt)
PORT = (port_cache_mod, port_spill_mod, port_kt)


def _kv32(n_tokens, seed=0):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((L, n_tokens, H, HD)).astype(np.float32)
    v = rng.standard_normal((L, n_tokens, H, HD)).astype(np.float32)
    return k, v


def _as(side, dtype, arrs):
    """The same K/V in each package's host form."""
    if dtype == "float32":
        return arrs
    bf = [a.astype(ml_dtypes.bfloat16) for a in arrs]
    return bf if side is JAX else [a.view(np.uint16) for a in bf]


def _bytes(a):
    return None if a is None else np.ascontiguousarray(a).tobytes()


def _trace(side, dtype, int8, spill_dir):
    """Run the script through one package; return what it observed."""
    cache_mod, spill_mod, kt = side

    def kv(n, seed):
        return _as(side, dtype, _kv32(n, seed))

    probe = cache_mod.HostKVCache(1 << 30, block_tokens=BT, int8=int8)
    probe.insert_sequence(list(range(BT)), *kv(BT, 99))
    cache = cache_mod.HostKVCache(
        5 * probe.bytes_used, block_tokens=BT, int8=int8
    )
    if spill_dir is not None:
        cache.spill = spill_mod.DiskKVSpill(spill_dir, 1 << 20)
    a = list(range(1, 13))                        # 3 blocks
    b = a[:BT] + list(range(21, 29))              # shares a's first block
    c = list(range(41, 53))
    out = []
    out.append(cache.insert_sequence(a, *kv(12, 1)))
    kb, vb = _kv32(12, 2)
    ka, va = _kv32(12, 1)
    kb[:, :BT], vb[:, :BT] = ka[:, :BT], va[:, :BT]
    out.append(cache.insert_sequence(b, *_as(side, dtype, (kb, vb))))
    for p in (a + [99], b + [99], [5, 6, 7, 8, 9], a + [99]):
        out.append(cache.match_prefix_len(p))
    out.append(cache.insert_sequence(c, *kv(12, 3)))   # evicts (and spills)
    out.append(sorted(k.hex() for k in cache._blocks))
    out += [cache.entries, cache.bytes_used, cache.blocks_evicted,
            cache.hits, cache.misses]
    for blk in sorted(cache._blocks.values(), key=lambda x: x.key):
        out += [_bytes(blk.k), _bytes(blk.v), _bytes(blk.k_scale),
                _bytes(blk.v_scale)]
    if cache.spill is not None:
        out.append(cache.spill.snapshot())
        for name in sorted(os.listdir(spill_dir)):
            with open(os.path.join(spill_dir, name), "rb") as f:
                out.append((name, f.read()))
    for p in (a + [99], b + [99], c + [99]):
        n = cache.peek_prefix_len(p)
        out.append(n)
        got = cache.gather_prefix(p, n) if n else None
        out.append(None if got is None else (_bytes(got[0]), _bytes(got[1])))
    out.append(cache.faultbacks)
    if cache.spill is not None:
        out.append(cache.spill.snapshot())
    out.append(cache.prefix_keys(c + [99]))
    wire = b"".join(kt.export_frames(cache, c + [99]))
    out.append(wire)
    for tier in (False, True):
        dst = cache_mod.HostKVCache(1 << 24, block_tokens=BT, int8=tier)
        out.append(kt.import_frames(dst, kt.decode_stream(wire)))
        n = dst.peek_prefix_len(c + [99])
        got = dst.gather_prefix(c + [99], n)
        out.append((n, None if got is None else _bytes(got[0])))
    return out


@pytest.mark.parametrize("spill", [False, True])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_spill_and_codec_trace_matches_jax(tmp_path, dtype, int8,
                                                 spill):
    want = _trace(
        JAX, dtype, int8, str(tmp_path / "jax") if spill else None
    )
    got = _trace(
        PORT, dtype, int8, str(tmp_path / "port") if spill else None
    )
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"trace entry {i} differs"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quant", [False, True])
def test_frames_cross_decode(dtype, quant):
    """A frame the port encodes is byte for byte the JAX frame for the
    same block, and each package decodes the other's to the same bits."""
    k, v = _kv32(BT, 7)
    ks = vs = None
    if quant:
        (k, ks), (v, vs) = (
            port_cache_mod._quantize_block(k), port_cache_mod._quantize_block(v)
        )
        jk = jax_cache_mod._quantize_block(_kv32(BT, 7)[0])
        np.testing.assert_array_equal(jk[0], k)
        np.testing.assert_array_equal(jk[1], ks)
    jk_, jv_ = (k, v) if quant else _as(JAX, dtype, (k, v))
    pk_, pv_ = (k, v) if quant else _as(PORT, dtype, (k, v))
    kw = dict(k_scale=ks, v_scale=vs, dtype=dtype)
    jwire = jax_kt.MAGIC + jax_kt.encode_frame("ab", range(BT), k=jk_, v=jv_, **kw)
    pwire = port_kt.MAGIC + port_kt.encode_frame("ab", range(BT), k=pk_, v=pv_, **kw)
    assert pwire == jwire
    (pf,) = port_kt.decode_stream(jwire)
    (jf,) = jax_kt.decode_stream(pwire)
    assert pf.dtype == jf.dtype == dtype and pf.tokens == jf.tokens
    assert _bytes(pf.k) == _bytes(jf.k) and _bytes(pf.v) == _bytes(jf.v)
    assert _bytes(pf.k_scale) == _bytes(jf.k_scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_dequantize_matches_jax_bit_for_bit(dtype):
    k32, _ = _kv32(8, 11)
    (jx,) = _as(JAX, dtype, (k32,))
    (px,) = _as(PORT, dtype, (k32,))
    jq, js = jax_cache_mod._quantize_block(jx)
    pq, ps = port_cache_mod._quantize_block(px)
    np.testing.assert_array_equal(pq, jq)
    np.testing.assert_array_equal(ps, js)
    want = jax_cache_mod._dequantize_block(jq, js, jx.dtype)
    got = port_cache_mod._dequantize_block(pq, ps, px.dtype)
    assert got.dtype == px.dtype
    assert _bytes(got) == _bytes(want)


# ---------------------------------------------------------------------------
# unit: radix trie (mirrors tests/engine/test_kv_host_cache.py)
# ---------------------------------------------------------------------------


def test_match_prefix_block_granular():
    cache = HostKVCache(max_bytes=1 << 20, block_tokens=4)
    seq = list(range(1, 13))
    k, v = _kv32(12)
    assert cache.insert_sequence(seq, k, v) == 3
    mk, mv, plen = cache.match_prefix(seq + [99, 98])
    assert plen == 12
    np.testing.assert_array_equal(mk, k)
    np.testing.assert_array_equal(mv, v)
    # only PROPER prefixes match: >= 1 suffix token always remains
    assert cache.match_prefix(seq)[2] == 8
    assert cache.match_prefix(seq[:8] + [77, 77, 77, 77, 1])[2] == 8
    assert cache.match_prefix([5, 1, 2, 3, 4, 5]) is None
    assert cache.hits == 3 and cache.misses == 1


def test_insert_dedup_shares_blocks_and_skips_partial_tail():
    cache = HostKVCache(max_bytes=1 << 20, block_tokens=4)
    shared = list(range(1, 9))
    k, v = _kv32(12)
    assert cache.insert_sequence(shared + [10, 11, 12, 13], k, v) == 3
    k2, v2 = _kv32(12, seed=1)
    k2[:, :8], v2[:, :8] = k[:, :8], v[:, :8]
    assert cache.insert_sequence(shared + [20, 21, 22, 23], k2, v2) == 1
    assert cache.entries == 4
    part = HostKVCache(max_bytes=1 << 20, block_tokens=4)
    assert part.insert_sequence(list(range(7)), *_kv32(7)) == 1


def test_eviction_is_leaf_only():
    cache = HostKVCache(max_bytes=1 << 20, block_tokens=4)
    shared = [1, 2, 3, 4]
    k, v = _kv32(8)
    cache.insert_sequence(shared + [11, 12, 13, 14], k, v)
    k2, v2 = _kv32(8, seed=1)
    k2[:, :4], v2[:, :4] = k[:, :4], v[:, :4]
    cache.insert_sequence(shared + [21, 22, 23, 24], k2, v2)
    cache.max_bytes = 3 * (cache.bytes_used // 3)
    assert cache.match_prefix(shared + [21, 22, 23, 24, 0])[2] == 8
    cache.insert_sequence([31, 32, 33, 34], *_kv32(4, seed=2))
    assert cache.bytes_used <= cache.max_bytes
    # the shared root block (refs > 0) survives although it is oldest;
    # the touched leaf survives; the cold leaf is gone
    assert cache.match_prefix(shared + [21, 22, 23, 24, 0])[2] == 8
    assert cache.match_prefix(shared + [11, 12, 13, 14, 0])[2] == 4
    assert cache.blocks_evicted >= 1


def test_block_larger_than_budget_refused():
    cache = HostKVCache(max_bytes=64, block_tokens=4)
    assert cache.insert_sequence([1, 2, 3, 4], *_kv32(4)) == 0
    assert cache.bytes_used == 0


def test_int8_roundtrip_close_and_smaller():
    f32 = HostKVCache(max_bytes=1 << 20, block_tokens=4)
    i8 = HostKVCache(max_bytes=1 << 20, block_tokens=4, int8=True)
    seq = list(range(1, 9))
    k, v = _kv32(8)
    f32.insert_sequence(seq, k, v)
    i8.insert_sequence(seq, k, v)
    assert i8.bytes_used < 0.6 * f32.bytes_used
    mk, mv, plen = i8.match_prefix(seq + [99])
    assert plen == 8 and mk.dtype == k.dtype
    scale = np.max(np.abs(k), axis=(1, 3), keepdims=True)
    np.testing.assert_allclose(mk, k, atol=(scale / 120).max())


def test_int8_tier_keeps_bf16_as_bits():
    """bf16 (uint16) blocks quantize from their exact float32 values and
    dequantize back to bf16 bits within the int8 step."""
    k32, v32 = _kv32(8)
    k, v = (a.astype(ml_dtypes.bfloat16).view(np.uint16) for a in (k32, v32))
    cache = HostKVCache(max_bytes=1 << 20, block_tokens=4, int8=True)
    cache.insert_sequence(list(range(1, 9)), k, v)
    mk, _, plen = cache.match_prefix(list(range(1, 9)) + [99])
    assert plen == 8 and mk.dtype == np.uint16
    exact = bf16_bits_to_f32(k)
    step = np.max(np.abs(exact), axis=(1, 3), keepdims=True) / 127
    np.testing.assert_allclose(
        bf16_bits_to_f32(mk), exact, atol=float(step.max()) * 0.51 + 0.02
    )


def test_lookup_is_radix_not_linear_scan():
    cache = HostKVCache(max_bytes=1 << 30, block_tokens=4)
    for s in range(50):
        cache.insert_sequence(
            [1000 + 10 * s + i for i in range(8)], *_kv32(8, seed=s)
        )
    probes = []
    orig = cache._child_key

    def counting(parent_key, tokens):
        probes.append(1)
        return orig(parent_key, tokens)

    cache._child_key = counting
    assert cache.match_prefix([7, 7, 7, 7, 7]) is None
    assert len(probes) == 1


# ---------------------------------------------------------------------------
# unit: disk spill tier (mirrors tests/engine/test_kv_spill.py)
# ---------------------------------------------------------------------------


def _block_bytes():
    return 2 * L * BT * H * HD * 4


def _spill_cache(tmp_path, ram_blocks=2, disk_mb=4):
    cache = HostKVCache(max_bytes=ram_blocks * _block_bytes(), block_tokens=BT)
    cache.spill = DiskKVSpill(str(tmp_path / "spill"), max_bytes=disk_mb << 20)
    return cache


def _spill_tail(tmp_path):
    """Sequence a's TAIL block on disk, RAM with headroom for it."""
    cache = _spill_cache(tmp_path, ram_blocks=4)
    a = list(range(1, 13))
    ka, va = _kv32(12)
    cache.insert_sequence(a, ka, va)
    cache.insert_sequence(list(range(101, 109)), *_kv32(8, seed=7))
    assert cache.blocks_evicted >= 1 and cache.spill.entries >= 1
    return cache, a, ka, va


def test_evicted_blocks_spill_and_fault_back_with_parity(tmp_path):
    cache, a, ka, va = _spill_tail(tmp_path)
    assert cache.spill.blocks_spilled == cache.blocks_evicted
    probe = a + [99]
    assert cache.match_prefix_len(probe) == 12
    gk, gv = cache.gather_prefix(probe, 12)
    assert cache.faultbacks >= 1 and cache.spill.blocks_loaded >= 1
    np.testing.assert_array_equal(gk, ka)
    np.testing.assert_array_equal(gv, va)


def test_disk_extension_capped_by_ram_budget(tmp_path):
    cache = _spill_cache(tmp_path, ram_blocks=2)
    seq = list(range(1, 13))
    cache.insert_sequence(seq, *_kv32(12))
    assert cache.spill.entries >= 1
    assert cache.match_prefix_len(seq + [99]) == 2 * BT
    assert cache.gather_prefix(seq + [99], 2 * BT) is not None
    assert cache.faultbacks == 0


def test_spill_tier_survives_restart(tmp_path):
    cache = _spill_cache(tmp_path, ram_blocks=2)
    seq = list(range(1, 13))
    k, v = _kv32(12)
    cache.insert_sequence(seq, k, v)
    spilled = cache.spill.entries
    cache2 = HostKVCache(max_bytes=4 * _block_bytes(), block_tokens=BT)
    cache2.spill = DiskKVSpill(str(tmp_path / "spill"), max_bytes=4 << 20)
    assert cache2.spill.entries == spilled
    cache2.insert_sequence(seq[:8], k[:, :8], v[:, :8])
    assert cache2.match_prefix_len(seq + [99]) == 12
    got = cache2.gather_prefix(seq + [99], 12)
    np.testing.assert_array_equal(got[0], k)


def test_truncated_spill_file_reads_as_miss(tmp_path):
    cache, a, _, _ = _spill_tail(tmp_path)
    spill = cache.spill
    spilled = spill.entries
    spill_dir = str(tmp_path / "spill")
    for name in os.listdir(spill_dir):
        if name.endswith(SPILL_SUFFIX):
            path = os.path.join(spill_dir, name)
            with open(path, "r+b") as f:
                f.truncate(max(1, os.path.getsize(path) // 2))
    probe = a + [99]
    assert cache.match_prefix_len(probe) == 12
    assert cache.gather_prefix(probe, 12) is None
    assert spill.corrupt >= 1 and spill.entries < spilled
    assert cache.match_prefix_len(probe) == 2 * BT


def test_misfiled_spill_frame_fails_token_check(tmp_path):
    cache, a, _, _ = _spill_tail(tmp_path)
    spill_dir = str(tmp_path / "spill")
    names = [n for n in os.listdir(spill_dir) if n.endswith(SPILL_SUFFIX)]
    foreign = encode_spill_frame(cache._blocks[next(iter(cache._blocks))])[1]
    with open(os.path.join(spill_dir, names[0]), "wb") as f:
        f.write(port_kt.MAGIC + foreign)
    probe = a + [99]
    assert cache.match_prefix_len(probe) == 12
    assert cache.gather_prefix(probe, 12) is None
    assert cache.spill.corrupt >= 1
    assert cache.match_prefix_len(probe) == 2 * BT


def test_spill_budget_evicts_oldest_files(tmp_path):
    cache = _spill_cache(tmp_path, ram_blocks=2)
    cache.insert_sequence(list(range(1, 13)), *_kv32(12))
    frame = encode_spill_frame(cache._blocks[next(iter(cache._blocks))])[1]
    tiny = DiskKVSpill(str(tmp_path / "tiny"), max_bytes=int(len(frame) * 2.5))
    for i in range(4):
        assert tiny.store(f"{i:02x}" * 4, frame)
    assert tiny.evictions >= 1
    assert tiny.bytes_used <= int(len(frame) * 2.5)
    assert tiny.has("03" * 4) and not tiny.has("00" * 4)


def test_touches_protect_hot_blocks():
    cache = HostKVCache(max_bytes=2 * _block_bytes(), block_tokens=BT)
    a, b = list(range(1, 5)), list(range(21, 25))
    cache.insert_sequence(a, *_kv32(4, seed=1))
    cache.insert_sequence(b, *_kv32(4, seed=2))
    for _ in range(6):
        assert cache.match_prefix_len(a + [99]) == BT
    cache.insert_sequence(list(range(41, 45)), *_kv32(4, seed=3))
    assert cache.match_prefix_len(a + [99]) == BT
    assert cache.match_prefix_len(b + [99]) == 0


# ---------------------------------------------------------------------------
# unit: frame codec (mirrors tests/engine/test_kv_transfer.py codec tests)
# ---------------------------------------------------------------------------


def _filled(tokens, int8=False, seed=0, bt=8):
    cache = HostKVCache(1 << 24, block_tokens=bt, int8=int8)
    k, v = _kv32(len(tokens), seed)
    cache.insert_sequence(tokens, k, v)
    return cache, k, v


def test_codec_roundtrip_fp32():
    tokens = list(range(100, 124))
    src, k, v = _filled(tokens)
    frames = port_kt.decode_stream(
        b"".join(port_kt.export_frames(src, tokens + [7]))
    )
    assert len(frames) == 3 and not any(f.skipped for f in frames)
    dst = HostKVCache(1 << 24, block_tokens=8)
    attached, n_tokens, bytes_in = port_kt.import_frames(dst, frames)
    assert attached == 3 and n_tokens == 24 and bytes_in > 0
    gk, gv = dst.gather_prefix(tokens + [7], 24)
    np.testing.assert_array_equal(gk, k)
    np.testing.assert_array_equal(gv, v)


def test_codec_int8_travels_quantized():
    tokens = list(range(16))
    src, k, _ = _filled(tokens, int8=True)
    frames = port_kt.decode_stream(
        b"".join(port_kt.export_frames(src, tokens + [1]))
    )
    assert all(f.k_scale is not None for f in frames)
    assert all(f.nbytes < k[:, :8].nbytes * 2 for f in frames)
    dst8 = HostKVCache(1 << 24, block_tokens=8, int8=True)
    port_kt.import_frames(dst8, frames)
    sk, _ = src.gather_prefix(tokens + [1], 16)
    np.testing.assert_array_equal(dst8.gather_prefix(tokens + [1], 16)[0], sk)
    dstf = HostKVCache(1 << 24, block_tokens=8)
    port_kt.import_frames(dstf, frames)
    np.testing.assert_allclose(
        dstf.gather_prefix(tokens + [1], 16)[0], sk, rtol=0, atol=1e-6
    )


def test_have_dedup_and_gaps():
    tokens = list(range(24))
    src, k, v = _filled(tokens)
    dst = HostKVCache(1 << 24, block_tokens=8)
    dst.insert_sequence(tokens[:8], k[:, :8], v[:, :8])
    have = dst.prefix_keys(tokens + [1])
    frames = port_kt.decode_stream(
        b"".join(port_kt.export_frames(src, tokens + [1], have=have))
    )
    assert [f.skipped for f in frames] == [True, False, False]
    assert port_kt.import_frames(dst, frames)[0] == 2
    assert dst.peek_prefix_len(tokens + [1]) == 24
    # a skipped frame for a block the importer lacks ends the run
    empty = HostKVCache(1 << 24, block_tokens=8)
    assert port_kt.import_frames(empty, frames)[0] == 0


def test_truncated_stream_keeps_prefix_and_corruption_raises():
    tokens = list(range(24))
    src, _, _ = _filled(tokens)
    wire = b"".join(port_kt.export_frames(src, tokens + [1]))
    last = port_kt.decode_stream(wire)[-1]
    frames = port_kt.FrameDecoder().feed(wire[: len(wire) - last.nbytes // 2])
    assert len(frames) == 2
    dst = HostKVCache(1 << 24, block_tokens=8)
    assert port_kt.import_frames(dst, frames)[0] == 2
    bad = bytearray(wire)
    bad[-3] ^= 0xFF
    with pytest.raises(ValueError, match="crc"):
        port_kt.decode_stream(bytes(bad))
    with pytest.raises(ValueError, match="magic"):
        port_kt.decode_stream(b"XXXXXX" + wire[6:])
    with pytest.raises(ValueError, match="block_tokens"):
        port_kt.import_frames(HostKVCache(1 << 24, block_tokens=4), frames)
