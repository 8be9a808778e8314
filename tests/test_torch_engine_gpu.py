"""The engine on a card (marker ``gpu``; each test skips where there is no
CUDA card): the host KV tier's side-stream device→host store into pinned
buffers, the staged upload on a second stream, and a continuation prefill
from the uploaded prefix; a speculative verify block that the runner
clamps inside the cache for a row frozen at its end (out of range it
would be a device-side assert); the embedding forward through the flash
kernel against the plain attention; a profile capture whose trace
holds the card's kernels; the MoE block (dense dispatch) on the card
against the same call on the CPU; an MLA prefill (DeepSeek's widths per
head: K 192, V 128 padded to 192) through the flash kernel at head_dim
192 against the plain attention; and a GPT-OSS prefill (sinks, a sliding
window, biases) at its per-head widths, which launches no flash kernel,
against the fp32 forward with its expert picks replayed.

JAX-free like ``test_torch_kernels_gpu.py``: ``python -m pytest
--noconftest -m gpu tests/test_torch_engine_gpu.py``. The model is
``tiny`` widened to head_dim 64 (the flash kernel takes 64 and 128),
bf16, random weights on the card.
"""

import dataclasses
import json
import os

import pytest
import torch

from gpustack_tpu_torch.engine.engine import GenRequest, LLMEngine, _ChunkJob  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.runner import ModelRunner  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models.config import get_config  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models.transformer import init_params  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.ops.flash_attention import flash_attention_prefill  # analysis: ignore[metrics-drift]


def _model():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: these engine paths run only there")
    cfg = dataclasses.replace(
        get_config("tiny"), head_dim=64, dtype="bfloat16",
        max_position_embeddings=512,
    )
    gen = torch.Generator(device="cuda").manual_seed(0)
    return cfg, init_params(cfg, gen, dtype=torch.bfloat16, device="cuda")


def _engine(**kw):
    cfg, params = _model()
    return LLMEngine(
        cfg, params, max_slots=2, max_seq_len=512, device="cuda",
        **(kw or dict(prefill_chunk=64, host_kv_cache_mb=64,
                      kv_block_tokens=32)),
    )


def _drain(eng):
    eng._kv_copy_pool.submit(lambda: None).result(timeout=60)
    eng._check_kv_copies()


@pytest.mark.gpu
def test_store_gather_upload_keep_the_bits():
    """A prefill's K/V stored through the copy stream, gathered from host
    RAM and uploaded through the upload stream come back bit for bit."""
    eng = _engine()
    try:
        ids = list(range(1, 201))
        with torch.no_grad():
            _, k, v = eng.runner.prefill(ids + [0] * 56, 200)
        eng._submit_kv_copy(ids, k, v, 200)
        _drain(eng)
        assert eng.host_kv_cache.entries == 200 // 32
        pk, pv = eng.host_kv_cache.gather_prefix(ids, 192)
        uk, uv, event = eng._upload_prefix(pk, pv, 192)
        torch.cuda.current_stream().wait_event(event)
        assert uk.shape[1] == eng.runner.bucket_for(192)
        assert torch.equal(uk[:, :192], k[:, :192])
        assert torch.equal(uv[:, :192], v[:, :192])
        assert not uk[:, 192:].any()
    finally:
        eng.stop()


@pytest.mark.gpu
def test_continuation_from_uploaded_prefix_matches_one_prefill():
    """The served continuation path on the card: a prefix that went
    device→host→device, then the suffix at ``q_offset`` = 192 through the
    flash kernel; its last logits against one prefill of the prompt (the
    smoke's bound: 5% of the logit scale, cosine 0.999)."""
    eng = _engine()
    try:
        r = eng.runner
        ids = [1 + (7 * i) % 250 for i in range(230)]
        with torch.no_grad():
            full, k, v = r.prefill(ids + [0] * 26, 230)
            eng._submit_kv_copy(ids, k, v, 230)
            _drain(eng)
            pk, pv = eng.host_kv_cache.gather_prefix(ids, 192)
            uk, uv, event = eng._upload_prefix(pk, pv, 192)
            job = _ChunkJob(req=None, ids=ids)
            eng._adopt_prefix(job, (uk, uv, 192, event))
            suffix = ids[192:] + [0] * (64 - 38)
            last, _, _ = r.prefill_with_prefix(
                job.k, job.v, 192, suffix, 38, r.bucket_for(192 + 64)
            )
        scale = full.abs().max().item()
        err = (last - full).abs().max().item()
        cos = torch.nn.functional.cosine_similarity(last, full, dim=0).item()
        assert err <= 5e-2 * scale and cos >= 0.999, (err, scale, cos)
    finally:
        eng.stop()


@pytest.mark.gpu
def test_verify_block_of_a_row_at_the_cache_end_stays_inside():
    """Slot 0 decodes; slot 1 is inactive at the last position, where a
    block of 4 would write past the cache. The runner clamps it, as the
    JAX write does, and the active row advances by what it produced."""
    cfg, params = _model()
    r = ModelRunner(cfg, params, torch.device("cuda"), max_slots=2,
                    max_seq_len=128)
    with torch.no_grad():
        _, k, v = r.prefill(list(range(1, 33)), 32)
        state = r.insert(r.new_state(), k, v, 0, 32, 5, 0.0, 0, 1.0)
        state.positions[1] = 127
        state, tokens, produced = r.verify_step(
            state, torch.zeros((2, 4), dtype=torch.int64)
        )
        torch.cuda.synchronize()
    n = produced.tolist()
    assert n[1] == 0 and 1 <= n[0] <= 4
    assert state.positions.tolist() == [32 + n[0], 127]
    assert tokens.shape == (2, 4)


@pytest.mark.gpu
def test_embed_through_flash_matches_plain_attention():
    """B = 4 (3 rows padded), T = 64: the kernel's embeddings against the
    same forward through the plain attention, cosine >= 0.999 per row;
    the kernel launches once per layer."""
    cfg, params = _model()
    r = ModelRunner(cfg, params, torch.device("cuda"), max_slots=2,
                    max_seq_len=128)
    rows = [[1 + (i * j) % 250 for j in range(64)] for i in range(1, 4)]
    lens = [64, 40, 7]
    before = flash_attention_prefill.launches
    with torch.no_grad():
        got = r.embed(rows, lens)
        assert flash_attention_prefill.launches - before == cfg.num_layers
        r.attn_impl_for = lambda bucket: "plain"
        want = r.embed(rows, lens)
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1)
    assert got.shape == (3, cfg.hidden_size)
    assert bool((cos >= 0.999).all()), cos.tolist()


@pytest.mark.gpu
def test_profile_capture_traces_the_card(tmp_path):
    """A capture over a decoding request writes a Chrome trace with the
    card's kernels in it."""
    eng = _engine(pipeline_depth=2)
    eng.start()
    try:
        req = eng.submit(GenRequest(prompt_ids=list(range(1, 20)),
                                    max_tokens=200, temperature=0.0))
        out_dir = str(tmp_path / "prof")
        result = eng.capture_profile(6, out_dir=out_dir, timeout_s=60)
        assert req.done.wait(120)
    finally:
        eng.stop()
    assert result["profiler"] == "torch", result["error"]
    with open(os.path.join(out_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "kernel" for e in events)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_mlp_on_the_card_matches_the_cpu(dtype):
    """``_moe_mlp`` (dense dispatch, a gated shared expert, token chunks)
    on the card against the same call on the CPU, at tiny widths: the
    same experts picked, the output within 1e-4 (fp32; TF32 is off for
    matmuls) or 2% of its scale (bf16, the two devices' rounding)."""
    from gpustack_tpu_torch.models import transformer as tf  # analysis: ignore[metrics-drift]

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    cfg = dataclasses.replace(
        get_config("tiny-moe"), num_experts=16, num_experts_per_tok=4,
        shared_expert_intermediate_size=48, shared_expert_gated=True,
    )
    gen = torch.Generator().manual_seed(0)
    D, E, F = cfg.hidden_size, cfg.num_experts, cfg.moe_intermediate_size

    def w(*shape):
        return (torch.randn(shape, generator=gen) / shape[-2] ** 0.5).to(dtype)

    args = [torch.randn(3, 37, D, generator=gen).to(dtype), w(D, E),
            w(E, D, F), w(E, D, F), w(E, F, D)]
    shared = (w(D, 48), w(D, 48), w(48, D), w(D, 1))
    cpu = tf._moe_mlp(*args, cfg, shared=shared, chunk_tokens=50).float()
    card = tf._moe_mlp(
        *(a.cuda() for a in args), cfg,
        shared=tuple(s.cuda() for s in shared), chunk_tokens=50,
    ).float().cpu()
    x2 = args[0].reshape(-1, D)
    idx_cpu, _ = tf.moe_route(x2, args[1], cfg)
    idx_card, _ = tf.moe_route(x2.cuda(), args[1].cuda(), cfg)
    assert torch.equal(idx_cpu, idx_card.cpu())
    if dtype == torch.float32:
        torch.testing.assert_close(card, cpu, rtol=1e-4, atol=1e-4)
    else:
        assert (card - cpu).abs().max() <= 2e-2 * cpu.abs().max()


@pytest.mark.gpu
def test_mla_prefill_through_the_kernel_matches_plain_attention():
    """Two dense MLA layers at deepseek-v2-lite's per-head widths (nope
    128 + rope 64 = 192, V 128 zero-padded, YaRN), narrow elsewhere: a
    bf16 prefill on the card through the flash kernel at d 192 (one launch
    a layer) against the same prefill through the plain attention, within
    the smoke's logit gate: 5% of the logit scale and cosine 0.999 (the
    plain attention rounds its probabilities to bf16 where the kernel
    rounds P for its P V product; on the CPU the plain version against
    the plain attention parts by 2.2% here)."""
    from gpustack_tpu_torch.models import transformer as tf  # analysis: ignore[metrics-drift]

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    cfg = dataclasses.replace(
        get_config("deepseek-v2-lite"), name="mla-narrow", vocab_size=264,
        hidden_size=256, intermediate_size=512, num_layers=2, num_heads=2,
        num_kv_heads=2, kv_lora_rank=64, num_experts=0,
        num_experts_per_tok=0, moe_intermediate_size=0, n_shared_experts=0,
        shared_expert_intermediate_size=0, first_k_dense=0,
    )
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, gen, dtype=torch.bfloat16, device="cuda")
    tokens = torch.randint(1, 264, (1, 100), generator=gen, device="cuda")
    pos = torch.arange(100, device="cuda")[None, :]

    def prefill(impl):
        cache = tf.KVCache.create(cfg, 1, 128, torch.device("cuda"))
        return tf.forward(params, cfg, tokens, pos, cache,
                          attn_impl=impl)[0][0].float()

    before = flash_attention_prefill.launches
    got = prefill("flash")
    torch.cuda.synchronize()
    assert flash_attention_prefill.launches == before + 2
    want = prefill("plain")
    assert (got - want).abs().max() <= 5e-2 * want.abs().max()
    assert torch.nn.functional.cosine_similarity(
        got.flatten(), want.flatten(), dim=0
    ) >= 0.999


@pytest.mark.gpu
def test_gptoss_prefill_matches_the_fp32_forward_with_its_picks_replayed():
    """Two GPT-OSS layers at its per-head widths (64 q heads on 8 kv
    heads, head_dim 64, a window of 128 on layer 0, sinks, q/k/v/o and
    expert biases drawn nonzero, YaRN), narrow elsewhere: a bf16 prefill
    of 300 tokens on the card (the runner asks for ``"flash"``; the
    kernel is never launched, as the JAX ``forward`` never takes it with
    sinks or a window) against the fp32 forward of the same weights on
    the card, the bf16 run's expert picks replayed (a top-k pick near a
    tie flips on any rounding change): within the smoke's logit gate, 5%
    of the logit scale and cosine 0.999."""
    from gpustack_tpu_torch.models import transformer as tf  # analysis: ignore[metrics-drift]

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    cfg = dataclasses.replace(
        get_config("gpt-oss-20b"), name="gptoss-narrow", vocab_size=264,
        hidden_size=512, intermediate_size=256, moe_intermediate_size=256,
        num_layers=2, layer_sliding=(True, False), num_experts=8,
    )
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, gen, dtype=torch.bfloat16, device="cuda")
    for key in ("bq", "bk", "bv", "bo", "sinks", "router_bias", "we_gate_b",
                "we_up_b", "we_down_b"):
        params["layers"][key].uniform_(-0.5, 0.5, generator=gen)
    tokens = torch.randint(1, 264, (1, 300), generator=gen, device="cuda")
    pos = torch.arange(300, device="cuda")[None, :]
    picks = []
    route = tf.moe_route

    def prefill(p, c, replay=False):
        def routed(x, router_w, rcfg, router_bias=None):
            if not replay:
                idx, combine = route(x, router_w, rcfg, router_bias)
                picks.append(idx)
                return idx, combine
            idx = picks.pop(0)
            logits = x.float() @ router_w.float() + router_bias.float()
            top_w = torch.softmax(torch.gather(logits, -1, idx), dim=-1)
            return idx, torch.zeros_like(logits).scatter_(-1, idx, top_w)

        tf.moe_route = routed
        try:
            cache = tf.KVCache.create(c, 1, 512, torch.device("cuda"))
            return tf.forward(p, c, tokens, pos, cache,
                              attn_impl="flash")[0][0].float()
        finally:
            tf.moe_route = route

    before = flash_attention_prefill.launches
    got = prefill(params, cfg)
    torch.cuda.synchronize()
    assert flash_attention_prefill.launches == before
    fp32 = {
        k: ({kk: vv.float() for kk, vv in v.items()} if isinstance(v, dict)
            else v.float())
        for k, v in params.items()
    }
    want = prefill(fp32, dataclasses.replace(cfg, dtype="float32"),
                   replay=True)
    assert not picks
    assert (got - want).abs().max() <= 5e-2 * want.abs().max()
    assert torch.nn.functional.cosine_similarity(
        got.flatten(), want.flatten(), dim=0
    ) >= 0.999
