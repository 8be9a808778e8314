"""Gemma 1 in the PyTorch port: the flash kernel's plain version at head_dim
256 against the JAX Pallas kernel, a tiny Gemma 1 config at head_dim 256
through the engine against the JAX engine, and the build-time refusals of
configs the card's kernels cannot serve.

- Flash at d 256 (gemma-7b's and gemma-2b's head width), fp32 on both
  sides: the port's plain version (what its wrapper takes for CPU tensors)
  against ``flash_attention_prefill`` in interpret mode, rtol/atol 2e-4 as
  in ``test_torch_flash_attention.py``, at ``q_offset`` 0 and above. The
  CUDA kernel at d 256 is held to the same plain version on the card
  (``test_torch_kernels_gpu.py``).
- The engine: a tiny Gemma 1 (``(1 + w)`` norms, the scaled and tied
  embedding, the tanh GELU, no window, softcap or sinks: a config the
  flash kernel takes) widened to head_dim 256, its unit gains drawn at
  random; greedy ids identical to the JAX engine's, and an embedding
  within 1e-5.
- Refusals, raised by ``build_engine_from_args`` before any weight is
  read: a flash-eligible head_dim the kernel does not take, and an int8
  leaf the W8A16 kernel cannot read (an untied ``lm_head`` over a vocab
  of 32001). The card is stood in for by the device resolver; the weight
  loaders fail the test if called.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpustack_tpu.engine.engine import GenRequest as JaxGenRequest
from gpustack_tpu.engine.engine import LLMEngine as JaxLLMEngine
from gpustack_tpu.models import transformer as jt
from gpustack_tpu.models.config import PRESETS as JAX_PRESETS
from gpustack_tpu.ops.flash_attention import (
    flash_attention_prefill as jax_flash,
)
from gpustack_tpu_torch import device as port_device  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine import weights as pw  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.api_server import (  # analysis: ignore[metrics-drift]
    build_engine_from_args,
    build_parser,
)
from gpustack_tpu_torch.engine.engine import GenRequest, LLMEngine  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models import quant as pq  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models import transformer as pt  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models.config import get_config  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.ops import flash_attention as port_flash  # analysis: ignore[metrics-drift]

RTOL = ATOL = 2e-4
FP32_TOL = dict(rtol=1e-5, atol=1e-5)
GEMMA1 = dict(hidden_act="gelu_tanh", norm_delta_gain=True, embed_scale=True,
              tie_word_embeddings=True, rms_norm_eps=1e-6, head_dim=256)


@pytest.mark.parametrize("B,T,S,off,Hq,Hkv", [
    (1, 128, 128, 0, 2, 2),       # gemma-7b's shape: q heads = kv heads
    (1, 64, 192, 128, 4, 1),      # gemma-2b's MQA, a continuation
    (2, 100, 100, 0, 2, 1),       # ragged T, a batch
    (1, 40, 130, 90, 2, 2),       # ragged chunk mid-cache
])
def test_plain_flash_at_d256_matches_jax_kernel(B, T, S, off, Hq, Hkv):
    rng = np.random.default_rng(B * 1000 + T + off)
    d = 256
    q = rng.standard_normal((B, T, Hq, d), dtype=np.float32)
    k = rng.standard_normal((B, S, Hkv, d), dtype=np.float32)
    v = rng.standard_normal((B, S, Hkv, d), dtype=np.float32)
    scale = d ** -0.5
    out = port_flash.flash_attention_prefill(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        scale, q_offset=off,
    ).numpy()
    assert out.shape == (B, T, Hq * d)
    want = np.asarray(jax_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
        interpret=True, q_offset=off,
    ))
    np.testing.assert_allclose(out, want, rtol=RTOL, atol=ATOL)


def _gemma1():
    cfg = dataclasses.replace(get_config("tiny"), dtype="float32", **GEMMA1)
    jcfg = dataclasses.replace(JAX_PRESETS["tiny"], dtype="float32",
                               **GEMMA1)
    tree = jax.tree.map(np.asarray, jt.init_params(
        jcfg, jax.random.key(0), dtype=jnp.float32
    ))
    rng = np.random.default_rng(100)
    for key in ("attn_norm", "mlp_norm"):
        tree["layers"][key] = rng.uniform(
            -0.5, 0.5, tree["layers"][key].shape
        ).astype(np.float32)
    tree["final_norm"] = rng.uniform(
        -0.5, 0.5, tree["final_norm"].shape
    ).astype(np.float32)
    return cfg, jcfg, tree


PROMPTS = [list(range(3, 33)), [15, 9, 2, 6] * 6, [7, 7, 7, 7, 9]]
MAX_TOKENS = 10


def test_gemma1_at_head_dim_256_engine_matches_jax():
    cfg, jcfg, tree = _gemma1()
    assert pt.flash_eligible(cfg) and cfg.head_dim == 256
    jeng = JaxLLMEngine(jcfg, jax.tree.map(jnp.asarray, tree), max_slots=4,
                        max_seq_len=64, pipeline_depth=0)
    jeng.start()
    try:
        reqs = [jeng.submit(JaxGenRequest(
            prompt_ids=p, max_tokens=MAX_TOKENS, temperature=0.0))
            for p in PROMPTS]
        for r in reqs:
            assert r.done.wait(300), r.request_id
        want = [r.output_ids for r in reqs]
        want_vec = np.asarray(jeng.embed([PROMPTS[0]]))
    finally:
        jeng.stop()
    eng = LLMEngine(cfg, pw.params_from_numpy(tree, "cpu"), max_slots=4,
                    max_seq_len=64, device="cpu")
    eng.start()
    try:
        reqs = [eng.submit(GenRequest(
            prompt_ids=p, max_tokens=MAX_TOKENS, temperature=0.0))
            for p in PROMPTS]
        for r in reqs:
            assert r.done.wait(300), r.request_id
        got = [r.output_ids for r in reqs]
        vec = eng.embed([PROMPTS[0]])
    finally:
        eng.stop()
    assert got == want
    assert all(len(ids) == MAX_TOKENS for ids in got)
    np.testing.assert_allclose(np.asarray(vec), want_vec, **FP32_TOL)


# ---------------------------------------------------------------------------
# build-time refusals
# ---------------------------------------------------------------------------


@pytest.fixture
def on_the_card(monkeypatch):
    """``build_engine_from_args`` as on the card, with every weight loader
    failing the test if it is reached."""
    monkeypatch.setattr(port_device, "resolve_device",
                        lambda device=None: torch.device("cuda", 0))

    def no_weights(*args, **kw):
        raise AssertionError("a weight was read before the refusal")

    monkeypatch.setattr(pw, "load_or_init_params", no_weights)
    monkeypatch.setattr(pq, "init_quantized_params", no_weights)


def _model_dir(tmp_path, **fields):
    hf = {
        "architectures": ["GemmaForCausalLM"], "model_type": "gemma",
        "hidden_size": 3072, "intermediate_size": 24576,
        "num_hidden_layers": 2, "num_attention_heads": 16,
        "num_key_value_heads": 16, "head_dim": 256, "vocab_size": 256000,
        "rope_theta": 10000.0, "rms_norm_eps": 1e-6,
        "max_position_embeddings": 8192, "hidden_act": "gelu_pytorch_tanh",
        "tie_word_embeddings": True, **fields,
    }
    (tmp_path / "config.json").write_text(json.dumps(hf))
    return str(tmp_path)


def _build(model_dir, *extra):
    return build_engine_from_args(build_parser().parse_args(
        ["--model-dir", model_dir, *extra]
    ))


def test_flash_head_dim_the_kernel_lacks_is_refused_at_build(
    tmp_path, on_the_card
):
    with pytest.raises(ValueError, match="head_dim 80"):
        _build(_model_dir(tmp_path, head_dim=80, hidden_size=1280,
                          num_attention_heads=16, num_key_value_heads=16))


def test_gemma1_at_head_dim_256_passes_the_build_check(
    tmp_path, on_the_card
):
    """gemma-7b's config gets past the kernels' check (to the loader,
    which the fixture stops): the flash kernel takes d 256."""
    with pytest.raises(AssertionError, match="weight was read"):
        _build(_model_dir(tmp_path))


def test_int8_leaf_the_kernel_cannot_read_is_refused_at_build(
    tmp_path, on_the_card
):
    md = _model_dir(
        tmp_path, architectures=["LlamaForCausalLM"], model_type="llama",
        hidden_size=1024, intermediate_size=2048, num_attention_heads=8,
        num_key_value_heads=8, head_dim=128, vocab_size=32001,
        tie_word_embeddings=False, hidden_act="silu",
    )
    with pytest.raises(ValueError, match=r"lm_head of shape \(1024, 32001\)"):
        _build(md, "--quantization", "int8")
    # the same checkpoint in bf16 reaches the loader
    with pytest.raises(AssertionError, match="weight was read"):
        _build(md)
