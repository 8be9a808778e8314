"""Int8 weight-only quantization of the PyTorch port against the JAX
package: the quantized trees, the int8 forward and the int8 engine.

Inputs are made with numpy from a seed; the JAX side runs on the CPU.
Tolerances:
- ``quantize_params`` on the same fp32 tree: identical int8 ``q`` and
  identical bf16 ``s`` bits (same fp32 division, half-to-even rounding,
  clip and bf16 cast); ``dequantize`` identical bf16 bits.
- int8 forward, fp32 activations, a JAX quantized tree carried across:
  logits within rtol = atol = 1e-4 of JAX ``forward`` (summation order
  only), and the top-1 token equal to the unquantized forward's.
- The W8A16 wrapper's plain version against the JAX ``_mm`` int8 branch:
  fp32 within 1e-5 relative; bf16 within one bf16 rounding of the output
  plus the JAX side's bf16 product rounding (2e-2 of the row scale).
- The int8 engine: greedy ``output_ids`` identical to the JAX engine's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpustack_tpu.engine.engine import GenRequest as JaxGenRequest
from gpustack_tpu.engine.engine import LLMEngine as JaxLLMEngine
from gpustack_tpu.models import transformer as jt
from gpustack_tpu.models import quant as jq
from gpustack_tpu.models.config import PRESETS as JAX_PRESETS
from gpustack_tpu_torch.engine.engine import GenRequest, LLMEngine  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.weights import params_from_numpy  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models import quant as pq  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models import transformer as pt  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models.config import get_config  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.ops import w8a16  # analysis: ignore[metrics-drift]

TOL = dict(rtol=1e-4, atol=1e-4)


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _trees(name="tiny"):
    """(cfg, jcfg, JAX fp32 tree, JAX int8 tree, port int8 tree carried
    across from the JAX int8 tree)."""
    cfg = dataclasses.replace(get_config(name), dtype="float32")
    jcfg = dataclasses.replace(JAX_PRESETS[name], dtype="float32")
    jparams = jt.init_params(jcfg, jax.random.key(0), dtype=jnp.float32)
    jq_params = jq.quantize_params(jparams)
    tq = params_from_numpy(jax.tree.map(np.asarray, jq_params), "cpu")
    return cfg, jcfg, jparams, jq_params, tq


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("name", ["tiny", "tiny-qwen3"])
def test_quantize_params_bits_match_jax(name):
    _, _, jparams, jq_params, _ = _trees(name)
    fp = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    got = dict(_leaves(pq.quantize_params(fp)))
    want = dict(_leaves(jq_params))
    assert got.keys() == want.keys()
    n_quant = 0
    for key, w in want.items():
        g = got[key]
        if isinstance(w, jq.QuantW):
            assert isinstance(g, pq.QuantW), key
            assert g.q.dtype == torch.int8 and g.s.dtype == torch.bfloat16
            np.testing.assert_array_equal(g.q.numpy(), np.asarray(w.q))
            np.testing.assert_array_equal(_bits(g.s), _jbits(w.s))
            n_quant += 1
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert n_quant == 9          # 7 layer weights, embed, lm_head


def test_quantize_rounds_half_to_even_and_clips():
    # a row whose absmax is 127: w / scale lands on .5 exactly for 2.5
    # and 3.5; half to even gives 2 and 4
    w = torch.tensor([[2.5, 3.5, -127.0, 0.0]]).T.contiguous()   # [4, 1]
    q = pq._quantize_leaf("lm_head", w)
    want = jq._quantize_leaf("lm_head", jnp.asarray(w.numpy()))
    np.testing.assert_array_equal(q.q.numpy(), np.asarray(want.q))
    assert q.q[:, 0].tolist() == [2, 4, -127, 0]
    np.testing.assert_array_equal(_bits(q.s), _jbits(want.s))


@pytest.mark.parametrize("stacked", [None, False])
def test_dequantize_matches_jax(stacked):
    _, _, _, jq_params, tq = _trees()
    for name in ("wq", "w_down"):
        jw, tw = jq_params["layers"][name], tq["layers"][name]
        if stacked is False:
            jw = jq.QuantW(q=jw.q[1], s=jw.s[1])
            tw = tw[1]
        want = jq.dequantize(name, jw, stacked=stacked)
        got = pq.dequantize(name, tw, stacked=stacked)
        np.testing.assert_array_equal(_bits(got), _jbits(want))
    got = pq.dequantize("embed", tq["embed"])
    np.testing.assert_array_equal(
        _bits(got), _jbits(jq.dequantize("embed", jq_params["embed"]))
    )
    plain = tq["final_norm"]
    assert pq.dequantize("final_norm", plain) is plain


@pytest.mark.parametrize("name", ["tiny", "tiny-qwen3"])
def test_init_quantized_params_matches_jax_structure(name):
    cfg = get_config(name)
    want = jq.init_quantized_params(JAX_PRESETS[name], seed=0)
    got = pq.init_quantized_params(cfg, seed=0, device="cpu")

    def desc(tree, quant_cls):
        out = {}
        for key, v in _leaves(tree):
            if isinstance(v, quant_cls):
                out[key] = (
                    ("q", tuple(v.q.shape), str(v.q.dtype).split(".")[-1]),
                    ("s", tuple(v.s.shape), str(v.s.dtype).split(".")[-1]),
                )
            else:
                out[key] = (tuple(v.shape), str(v.dtype).split(".")[-1])
        return out

    assert desc(got, pq.QuantW) == desc(want, jq.QuantW)
    # the same scale bits: 3 / sqrt(fan_in) / 127 through fp32 to bf16
    np.testing.assert_array_equal(
        _bits(got["layers"]["w_down"].s), _jbits(want["layers"]["w_down"].s)
    )
    q = got["layers"]["wq"].q
    assert int(q.min()) >= -127 and int(q.max()) <= 127
    toks = torch.tensor([[1, 2, 3]])
    pos = torch.arange(3)[None, :]
    logits, _ = pt.forward(got, cfg, toks, pos)
    assert torch.isfinite(logits).all()


def test_init_quantized_params_is_seeded():
    cfg = get_config("tiny")
    a = pq.init_quantized_params(cfg, seed=3, device="cpu")
    b = pq.init_quantized_params(cfg, seed=3, device="cpu")
    c = pq.init_quantized_params(cfg, seed=4, device="cpu")
    assert torch.equal(a["layers"]["wq"].q, b["layers"]["wq"].q)
    assert not torch.equal(a["layers"]["wq"].q, c["layers"]["wq"].q)


@pytest.mark.parametrize("name", ["tiny", "tiny-qwen3"])
def test_int8_forward_matches_jax(name):
    cfg, jcfg, jparams, jq_params, tq = _trees(name)
    rng = np.random.default_rng(7)
    toks = rng.integers(1, cfg.vocab_size, (2, 9)).astype(np.int32)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9)).copy()
    want, _ = jt.forward(jq_params, jcfg, jnp.asarray(toks), jnp.asarray(pos))
    got, _ = pt.forward(
        tq, cfg, torch.from_numpy(toks).long(), torch.from_numpy(pos).long()
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the JAX test's prompt: int8 keeps the unquantized top-1 token
    toks = np.asarray([[5, 17, 42, 99]], np.int32)
    pos = np.arange(4, dtype=np.int32)[None, :]
    ref, _ = jt.forward(jparams, jcfg, jnp.asarray(toks), jnp.asarray(pos))
    got, _ = pt.forward(
        tq, cfg, torch.from_numpy(toks).long(), torch.from_numpy(pos).long()
    )
    assert int(got[0, -1].argmax()) == int(np.asarray(ref[0, -1]).argmax())


def test_int8_prefill_and_decode_with_cache_match_jax():
    cfg, jcfg, _, jq_params, tq = _trees()
    rng = np.random.default_rng(11)
    toks = rng.integers(1, cfg.vocab_size, (2, 7)).astype(np.int32)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32), (2, 7)).copy()
    jcache = jt.KVCache.create(jcfg, 2, 16)
    want, jcache = jt.forward(
        jq_params, jcfg, jnp.asarray(toks), jnp.asarray(pos), jcache
    )
    cache = pt.KVCache.create(cfg, 2, 16, torch.device("cpu"))
    got, cache = pt.forward(
        tq, cfg, torch.from_numpy(toks).long(), torch.from_numpy(pos).long(),
        cache, attn_impl="flash",
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    nxt = np.asarray([[5], [9]], np.int32)
    p1 = np.asarray([[7], [7]], np.int32)
    want, _ = jt.forward(
        jq_params, jcfg, jnp.asarray(nxt), jnp.asarray(p1), jcache
    )
    got, _ = pt.forward(
        tq, cfg, torch.from_numpy(nxt).long(), torch.from_numpy(p1).long(),
        cache,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("M,K,N", [(1, 64, 48), (8, 128, 96), (33, 40, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_w8a16_plain_matches_jax_mm(M, K, N, dtype):
    rng = np.random.default_rng(M * 1000 + K)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32) / np.sqrt(K)
    jw = jq._quantize_leaf("lm_head", jnp.asarray(w))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = np.asarray(
        jt._mm("md,dv->mv", jnp.asarray(x).astype(jdt), jw), np.float32
    )
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    before = w8a16.w8a16_matmul.launches
    got = w8a16.w8a16_matmul(
        torch.from_numpy(x).to(tdt), torch.from_numpy(np.array(jw.q)),
        torch.from_numpy(
            np.asarray(jw.s).view(np.int16).copy()
        ).view(torch.bfloat16),
    )
    assert w8a16.w8a16_matmul.launches == before      # CPU: plain version
    assert got.dtype == tdt and got.shape == (M, N)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        scale = np.abs(want).max(axis=1, keepdims=True)
        assert (np.abs(got - want) <= 2e-2 * scale).all()


def test_w8a16_keeps_leading_axes():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 3, 32)).astype(np.float32))
    q = torch.from_numpy(rng.integers(-127, 128, (32, 16)).astype(np.int8))
    s = torch.rand(16).to(torch.bfloat16)
    got = w8a16.w8a16_matmul(x, q, s)
    assert got.shape == (2, 3, 16)
    want = w8a16.w8a16_plain(x.reshape(6, 32), q, s).reshape(2, 3, 16)
    assert torch.equal(got, want)


@pytest.mark.parametrize(
    "N,K", [
        (14336, 4096), (4096, 14336), (1024, 4096),
        (4096, 4096), (128256, 4096), (4112, 4104), (16, 8),
    ],
)
def test_gemv_plan_covers_k_in_bounded_slices(N, K):
    sms = 132
    kchunk, ksplit = w8a16.gemv_plan(N, K, sms)
    assert kchunk % w8a16.GEMV_KSTEP == 0
    assert 1 <= ksplit <= w8a16.MAX_KSPLIT
    assert (ksplit - 1) * kchunk < K <= ksplit * kchunk
    # every warp of every CTA has a 16-row step, unless K is too short to
    # split at all
    assert ksplit == 1 or kchunk >= w8a16.GEMV_WARPS * w8a16.GEMV_KSTEP
    # K is split only until the grid has a CTA for every SM
    nb = -(-N // w8a16.GEMV_BN)
    assert ksplit == 1 or nb * (ksplit - 1) < sms


@pytest.mark.parametrize(
    "M,N,K", [
        (2048, 14336, 4096), (2048, 4096, 14336), (2048, 1024, 4096),
        (512, 14336, 4096), (512, 4096, 14336), (512, 1024, 4096),
        (64, 4096, 14336), (64, 1024, 4096), (17, 1024, 4096),
        (100, 4112, 4104), (2048, 4112, 4104), (333, 1040, 14336),
        (129, 16, 136), (40, 16, 8),
    ],
)
@pytest.mark.parametrize("sms", [132, 114])
def test_wgmma_plan_covers_every_output_once(M, N, K, sms):
    """The large-M grid: its CTAs of WGMMA_BM x BN outputs over kchunk
    rows of K, clipped to [M, N, K], cover every (output, k) exactly once;
    BN is 256 only when that grid still has a CTA for every SM, and K is
    split (into a cluster of at most MAX_KSPLIT) only while the grid has
    fewer CTAs than SMs."""
    bn, grid_m, grid_n, kchunk, ksplit = w8a16.wgmma_plan(M, N, K, sms)
    assert bn in (128, 256)
    assert kchunk % w8a16.WGMMA_BK == 0
    assert 1 <= ksplit <= w8a16.MAX_KSPLIT
    hits = np.zeros((M, N), np.int32)
    for bm_i in range(grid_m):
        for bn_i in range(grid_n):
            m0, n0 = bm_i * w8a16.WGMMA_BM, bn_i * bn
            assert m0 < M and n0 < N            # no CTA without outputs
            hits[m0:m0 + w8a16.WGMMA_BM, n0:n0 + bn] += 1
    assert (hits == 1).all()
    # every split has k rows, and together they cover K once
    assert (ksplit - 1) * kchunk < K <= ksplit * kchunk
    tiles_256 = -(-M // w8a16.WGMMA_BM) * -(-N // 256)
    assert (bn == 256) == (tiles_256 >= sms)
    if ksplit > 1:
        assert grid_m * grid_n * ksplit <= sms
        assert kchunk >= w8a16.WGMMA_MIN_KTILES * w8a16.WGMMA_BK


def _cpu_inputs(M=4, K=64, N=32, x_dtype=torch.bfloat16):
    x = torch.zeros((M, K), dtype=x_dtype)
    q = torch.zeros((K, N), dtype=torch.int8)
    s = torch.ones(N, dtype=torch.bfloat16)
    return x, q, s


@pytest.mark.parametrize(
    "case,exc,match",
    [
        ("k_not_mult_8", ValueError, "K % 8"),
        ("n_not_mult_16", ValueError, "N % 16"),
        ("x_fp32", TypeError, "bf16"),
        ("q_fp", TypeError, "int8"),
        ("shapes", ValueError, "want x"),
        ("q_transposed", ValueError, "16-byte aligned"),
    ],
)
def test_cuda_input_checks_refuse_clearly(case, exc, match):
    """The checks the wrapper runs before a launch (pure shape and dtype
    logic, exercised here on CPU tensors)."""
    if case == "k_not_mult_8":
        x, q, s = _cpu_inputs(K=60)
    elif case == "n_not_mult_16":
        x, q, s = _cpu_inputs(N=40)
    elif case == "x_fp32":
        x, q, s = _cpu_inputs(x_dtype=torch.float32)
    elif case == "q_fp":
        x, q, s = _cpu_inputs()
        q = q.to(torch.bfloat16)
    elif case == "shapes":
        x, q, s = _cpu_inputs()
        s = s[:16]
    else:
        x, q, s = _cpu_inputs(K=32, N=32)
        q = q.T
    with pytest.raises(exc, match=match):
        w8a16._check_cuda_inputs(x, q, s)
    w8a16._check_cuda_inputs(*_cpu_inputs())       # a good set passes


# ---------------------------------------------------------------------------
# the int8 engine against the JAX int8 engine
# ---------------------------------------------------------------------------

PROMPTS = [[3, 1, 4], [15, 9, 2, 6], [5, 3], [5, 8, 9, 7, 9], [31, 41]]
LONG = np.random.default_rng(5).integers(1, 264, 90).tolist()
MAX_TOKENS = 6
CHUNK = dict(prefill_chunk=32, host_kv_cache_mb=64, kv_block_tokens=16)


def _serve(eng, gen_cls, scripts):
    eng.start()
    try:
        outs = []
        for batch in scripts:
            reqs = [
                eng.submit(gen_cls(
                    prompt_ids=p, max_tokens=MAX_TOKENS, temperature=0.0
                ))
                for p in batch
            ]
            for r in reqs:
                assert r.done.wait(300), r.request_id
            if eng._kv_copy_pool is not None:
                eng._kv_copy_pool.submit(lambda: None).result(timeout=60)
            outs += [r.output_ids for r in reqs]
        return outs
    finally:
        eng.stop()


# the chunked script: a 90-token prompt (three chunks of 32 through
# prefill_with_prefix), then an extension of it (a prefix hit)
SCRIPTS = {
    "plain": ({}, [PROMPTS]),
    "chunk": (CHUNK, [[LONG], [LONG + [7, 7, 7]]]),
}


@pytest.fixture(scope="module")
def int8_models():
    return _trees()


@pytest.fixture(scope="module")
def jax_int8_runs(int8_models):
    _, jcfg, _, jq_params, _ = int8_models
    runs = {}
    for name, (kw, scripts) in SCRIPTS.items():
        eng = JaxLLMEngine(
            jcfg, jq_params, max_slots=4, max_seq_len=128,
            pipeline_depth=0, **kw,
        )
        runs[name] = _serve(eng, JaxGenRequest, scripts)
    return runs


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("name", list(SCRIPTS))
def test_int8_engine_matches_jax_engine(int8_models, jax_int8_runs, name,
                                        depth):
    cfg, _, _, _, tq = int8_models
    kw, scripts = SCRIPTS[name]
    eng = LLMEngine(
        cfg, tq, max_slots=4, max_seq_len=128, pipeline_depth=depth,
        device="cpu", **kw,
    )
    got = _serve(eng, GenRequest, scripts)
    assert got == jax_int8_runs[name]
    assert all(len(o) == MAX_TOKENS for o in got)
