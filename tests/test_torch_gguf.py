"""The port's copy of the GGUF module against the JAX package's, file by
file: the same GGUF files (written here with the JAX suite's own test
writer, from numpy seeds) go through both, and the port must give what
the JAX module gives. Mirrors the dense cases of
``tests/engine/test_gguf.py``; its MoE cases are in
``test_torch_moe_loaders.py``.

Tolerances: parsed metadata, dequantized tensors (every format), configs,
token ids and decoded text identical; K-quant dequantization also within
rtol 1e-5 of the scalar ggml transliterations; loaded param trees
identical bf16 bits; logits of the served model within 1e-4 (fp32
compute) and greedy ids identical.
"""

import dataclasses
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpustack_tpu.engine import gguf as jg
from gpustack_tpu.engine.engine import GenRequest as JaxGenRequest
from gpustack_tpu.engine.engine import LLMEngine as JaxLLMEngine
from gpustack_tpu.engine.weights import load_or_init_params as jax_load
from gpustack_tpu.models import transformer as jt
from gpustack_tpu_torch.engine import gguf as pg  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.engine import GenRequest, LLMEngine  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.tokenizer import ByteTokenizer, load_tokenizer  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.weights import load_or_init_params  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models import transformer as pt  # analysis: ignore[metrics-drift]


def _jax_suite():
    """The JAX suite's GGUF writer and ggml references (a test module,
    loaded by path: ``tests/`` is no package)."""
    path = os.path.join(os.path.dirname(__file__), "engine", "test_gguf.py")
    spec = importlib.util.spec_from_file_location("_jax_gguf_suite", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


G = _jax_suite()


def _same_tensors(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), k)


def _bits(t):
    t = t.detach().cpu()
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else (
        t.numpy()
    )


def _jbits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _same_tree(got, want, prefix=""):
    assert sorted(got) == sorted(want), prefix
    for k, w in want.items():
        if isinstance(w, dict):
            _same_tree(got[k], w, f"{prefix}{k}/")
        else:
            np.testing.assert_array_equal(
                _bits(got[k]), _jbits(w), f"{prefix}{k}"
            )


def test_parse_and_dequantize_roundtrip(tmp_path):
    path = str(tmp_path / "tiny.gguf")
    written = G._tiny_gguf(path)
    meta, infos, start, _ = pg.read_gguf(path)
    jmeta, jinfos, jstart, _ = jg.read_gguf(path)
    assert meta == jmeta and infos == jinfos and start == jstart
    tensors = pg.load_gguf_tensors(path)
    _same_tensors(tensors, jg.load_gguf_tensors(path))
    np.testing.assert_allclose(
        tensors["model.layers.0.self_attn.q_proj.weight"].numpy(),
        written["blk.0.attn_q.weight"][0], atol=1e-6,
    )


def test_quantized_tensors_dequantize_within_block_error(tmp_path):
    path = str(tmp_path / "q.gguf")
    written = G._tiny_gguf(path, quantized=True)
    tensors = pg.load_gguf_tensors(path)
    _same_tensors(tensors, jg.load_gguf_tensors(path))
    q8 = tensors["model.layers.0.self_attn.q_proj.weight"].numpy()
    ref = written["blk.0.attn_q.weight"][0]
    assert np.max(np.abs(q8 - ref)) < np.max(np.abs(ref)) / 100


def test_config_from_gguf(tmp_path):
    path = str(tmp_path / "cfg.gguf")
    G._tiny_gguf(path)
    cfg = pg.config_from_gguf(path, name="g")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jg.config_from_gguf(path, name="g")
    )
    assert cfg.num_layers == G.L and cfg.tie_word_embeddings is False
    assert pg.gguf_file_in(str(tmp_path)) == path


def test_vocab_tokenizer_roundtrip(tmp_path):
    path = str(tmp_path / "tok.gguf")
    G._tiny_gguf(path)
    tok = pg.GGUFVocabTokenizer.from_file(path)
    jtok = jg.GGUFVocabTokenizer.from_file(path)
    for text in ("hello world", "héllo", "lo he"):
        assert tok.encode(text) == jtok.encode(text)
        assert tok.decode(tok.encode(text)) == text
    assert tok.eos_ids == jtok.eos_ids == (2,)
    msgs = [{"role": "user", "content": "hello"}]
    assert tok.apply_chat_template(msgs) == jtok.apply_chat_template(msgs)
    # the engine's loader picks the embedded vocab, and the .gguf path too
    assert isinstance(load_tokenizer(str(tmp_path)), pg.GGUFVocabTokenizer)
    assert isinstance(load_tokenizer(path), pg.GGUFVocabTokenizer)


def test_gguf_path_honours_tokenizer_sidecar(tmp_path, monkeypatch):
    """A ``.gguf`` path looks for HF tokenizer files in its directory."""
    from gpustack_tpu_torch.engine import tokenizer as ptok  # analysis: ignore[metrics-drift]

    path = str(tmp_path / "tok.gguf")
    G._tiny_gguf(path)
    (tmp_path / "tokenizer.json").write_text("{}")
    seen = []
    monkeypatch.setattr(ptok, "HFTokenizer", lambda d: seen.append(d) or d)
    assert ptok.load_tokenizer(path) == str(tmp_path)
    assert seen == [str(tmp_path)]


def test_gpt2_vocab_roundtrip(tmp_path):
    path = str(tmp_path / "g2.gguf")
    vocab = ["<|end|>", "hello", "Ġworld", "Ġhe", "llo", "h", "Ġ"]
    b2u, _ = pg._gpt2_byte_tables()
    assert (b2u, _) == jg._gpt2_byte_tables()
    vocab += sorted(set(b2u.values()) - set(vocab))
    G.write_gguf(path, {
        "general.architecture": "llama",
        "tokenizer.ggml.model": "gpt2",
        "tokenizer.ggml.tokens": vocab,
        "tokenizer.ggml.eos_token_id": 0,
    }, {})
    tok = pg.GGUFVocabTokenizer.from_file(path)
    jtok = jg.GGUFVocabTokenizer.from_file(path)
    for text in ("hello world", "héllo wörld"):
        assert tok.encode(text) == jtok.encode(text)
        assert tok.decode(tok.encode(text)) == text


def test_corrupt_gguf_is_valueerror(tmp_path):
    good = str(tmp_path / "good.gguf")
    G._tiny_gguf(good)
    with open(good, "rb") as f:
        data = f.read()
    bad_dir = tmp_path / "baddir"
    bad_dir.mkdir()
    path = str(bad_dir / "bad.gguf")
    with open(path, "wb") as f:
        f.write(data[:100])          # truncated mid-metadata
    with pytest.raises(ValueError, match="corrupt"):
        pg.read_gguf(path)
    with pytest.raises(ValueError, match="corrupt"):
        jg.read_gguf(path)
    assert isinstance(load_tokenizer(str(bad_dir)), ByteTokenizer)


def _greedy_port(cfg, params, prompt, n=6):
    eng = LLMEngine(cfg, params, max_slots=1, max_seq_len=128, device="cpu")
    eng.start()
    try:
        return eng.generate(GenRequest(
            prompt_ids=prompt, max_tokens=n, temperature=0.0, stop_ids=(),
        ), timeout=600).output_ids
    finally:
        eng.stop()


def _greedy_jax(cfg, params, prompt, n=6):
    eng = JaxLLMEngine(cfg, params, max_slots=1, max_seq_len=128)
    eng.start()
    try:
        return eng.generate(JaxGenRequest(
            prompt_ids=prompt, max_tokens=n, temperature=0.0, stop_ids=(),
        ), timeout=600).output_ids
    finally:
        eng.stop()


def test_engine_serves_gguf(tmp_path):
    """A GGUF dir loads into the tree the JAX loader builds from it, and
    the port's engine serves it with the JAX engine's greedy ids (fp32
    compute over the bf16 tree on both sides)."""
    model_dir = tmp_path / "model"
    model_dir.mkdir()
    path = str(model_dir / "tiny.gguf")
    G._tiny_gguf(path)
    cfg = dataclasses.replace(
        pg.config_from_gguf(path, name="gguf-tiny"), dtype="float32"
    )
    jcfg = dataclasses.replace(
        jg.config_from_gguf(path, name="gguf-tiny"), dtype="float32"
    )
    params = load_or_init_params(cfg, str(model_dir), device="cpu")
    jparams = jax_load(jcfg, str(model_dir))
    _same_tree(params, jparams)
    prompt = [5, 9, 33, 7]
    assert _greedy_port(cfg, params, prompt) == _greedy_jax(
        jcfg, jparams, prompt
    )


def test_unsupported_quant_is_loud():
    for mod in (pg, jg):
        with pytest.raises(ValueError, match="16"):
            mod._dequantize("t", np.zeros(144, np.uint8), (256,), 16)


@pytest.mark.parametrize("gtype,nbytes,f16_at,ref", [
    (10, 84, (80, 82), "_ref_q2_k"),
    (11, 110, (108,), "_ref_q3_k"),
    (12, 144, (0, 2), "_ref_q4_k"),
    (13, 176, (0, 2), "_ref_q5_k"),
    (14, 210, (208,), "_ref_q6_k"),
    (6, 22, (0,), "_ref_q5_0"),
    (7, 24, (0, 2), "_ref_q5_1"),
])
def test_kquant_dequant_matches_ggml_reference(gtype, nbytes, f16_at, ref):
    rng = np.random.default_rng(gtype)
    n = 8
    elems = 32 if gtype in (6, 7) else 256
    blocks = G._rand_blocks(rng, n, nbytes, f16_at)
    got = pg._dequantize("t", blocks.reshape(-1), (n * elems,), gtype)
    np.testing.assert_array_equal(
        got, jg._dequantize("t", blocks.reshape(-1), (n * elems,), gtype)
    )
    want = np.stack([getattr(G, ref)(blocks[i]) for i in range(n)])
    np.testing.assert_allclose(
        got.reshape(n, elems), want, rtol=1e-5, atol=1e-7
    )


def test_q4k_q6k_file_roundtrip_within_tolerance():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((4, 256)).astype(np.float32) * 0.1
    for quantize, gtype, bound in (
        (G._quantize_q4_k, G.GGML_Q4_K, 0.05),
        (G._quantize_q6_k, G.GGML_Q6_K, 0.012),
    ):
        blob = np.frombuffer(quantize(w), np.uint8)
        deq = pg._dequantize("t", blob, w.shape, gtype)
        np.testing.assert_array_equal(
            deq, jg._dequantize("t", blob, w.shape, gtype)
        )
        assert np.max(np.abs(deq - w)) < bound


def test_engine_serves_q4k_gguf(tmp_path):
    """A Q4_K/Q6_K GGUF: the port's tree is the JAX loader's, bit for bit,
    and its logits match JAX ``forward`` on the same tree."""
    model_dir = tmp_path / "m"
    model_dir.mkdir()
    path = str(model_dir / "q4k.gguf")
    G._tiny_gguf_kquant(path)
    cfg = dataclasses.replace(pg.config_from_gguf(path), dtype="float32")
    jcfg = dataclasses.replace(jg.config_from_gguf(path), dtype="float32")
    params = load_or_init_params(cfg, str(model_dir), device="cpu")
    jparams = jax_load(jcfg, str(model_dir))
    _same_tree(params, jparams)
    toks = np.asarray([[5, 9, 33, 7]], np.int32)
    pos = np.asarray([[0, 1, 2, 3]], np.int32)
    want, _ = jt.forward(jparams, jcfg, jnp.asarray(toks), jnp.asarray(pos))
    got, _ = pt.forward(
        params, cfg, torch.from_numpy(toks).long(),
        torch.from_numpy(pos).long(),
    )
    np.testing.assert_allclose(
        got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4
    )


def test_split_gguf_loads_all_shards(tmp_path):
    p1, p2, written = G._split_tiny_gguf(tmp_path)
    assert pg.gguf_shard_paths(p1) == jg.gguf_shard_paths(p1) == [p1, p2]
    tensors = pg.load_gguf_tensors(p1)
    _same_tensors(tensors, jg.load_gguf_tensors(p1))
    got_q = tensors[f"model.layers.{G.L-1}.self_attn.q_proj.weight"].numpy()
    np.testing.assert_allclose(
        got_q, written[f"blk.{G.L-1}.attn_q.weight"][0], atol=1e-6
    )
    assert dataclasses.asdict(pg.config_from_gguf(p1)) == dataclasses.asdict(
        jg.config_from_gguf(p1)
    )
    assert pg.gguf_file_in(str(tmp_path)) == p1


def test_split_gguf_missing_shard_is_loud(tmp_path):
    p1, p2, _ = G._split_tiny_gguf(tmp_path)
    os.remove(p2)
    for mod in (pg, jg):
        with pytest.raises(ValueError, match="missing shard"):
            mod.gguf_shard_paths(p1)


def test_gguf_yarn_metadata_reaches_config(tmp_path):
    path = str(tmp_path / "yarn.gguf")
    rng = np.random.default_rng(0)
    G.write_gguf(path, {
        "general.architecture": "llama",
        "llama.block_count": 1,
        "llama.embedding_length": G.D,
        "llama.feed_forward_length": G.I,
        "llama.attention.head_count": G.H,
        "llama.context_length": 4096,
        "llama.rope.scaling.type": "yarn",
        "llama.rope.scaling.factor": 8.0,
        "llama.rope.scaling.original_context_length": 512,
    }, {"token_embd.weight": (
        rng.standard_normal((G.V, G.D)).astype(np.float32), G.GGML_F32)})
    cfg = pg.config_from_gguf(path)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jg.config_from_gguf(path)
    )
    inv, att = pt.rope_params(cfg)
    jinv, jatt = jt.rope_params(jg.config_from_gguf(path))
    assert att > 1.0 and att == pytest.approx(jatt)
    np.testing.assert_allclose(inv.numpy(), np.asarray(jinv), rtol=1e-6)


def test_gguf_rope_freqs_tensor_reaches_config(tmp_path):
    path = str(tmp_path / "l31.gguf")
    rng = np.random.default_rng(1)
    factors = np.linspace(1.0, 8.0, G.HD // 2).astype(np.float32)
    G.write_gguf(path, {
        "general.architecture": "llama",
        "llama.block_count": 1,
        "llama.embedding_length": G.D,
        "llama.feed_forward_length": G.I,
        "llama.attention.head_count": G.H,
        "llama.attention.head_count_kv": G.KV,
        "llama.context_length": 131072,
        "llama.rope.freq_base": 500000.0,
    }, {
        "token_embd.weight": (
            rng.standard_normal((G.V, G.D)).astype(np.float32), G.GGML_F32),
        "rope_freqs.weight": (factors, G.GGML_F32),
    })
    cfg = pg.config_from_gguf(path)
    np.testing.assert_allclose(cfg.rope_scaling["factors"], factors)
    inv, att = pt.rope_params(cfg)
    base = pt._inv_freq(cfg.rope_theta, cfg.head_dim).numpy()
    np.testing.assert_allclose(inv.numpy(), base / factors, rtol=1e-6)
    assert att == 1.0
    assert "rope_freqs.weight" not in pg.load_gguf_tensors(path)


def test_gguf_unknown_rope_scaling_rejected(tmp_path):
    path = str(tmp_path / "bad_rope.gguf")
    rng = np.random.default_rng(2)
    G.write_gguf(path, {
        "general.architecture": "llama",
        "llama.block_count": 1,
        "llama.embedding_length": G.D,
        "llama.feed_forward_length": G.I,
        "llama.attention.head_count": G.H,
        "llama.context_length": 4096,
        "llama.rope.scaling.type": "su",
    }, {"token_embd.weight": (
        rng.standard_normal((G.V, G.D)).astype(np.float32), G.GGML_F32)})
    for mod in (pg, jg):
        with pytest.raises(ValueError, match="rope scaling"):
            mod.config_from_gguf(path)


def test_moe_gguf_is_refused_before_any_tensor_is_read(tmp_path):
    """llama.cpp's ``deepseek2`` export (DeepSeek's MoE with MLA tensor
    names and its own cache layout) is refused by both packages' config
    reader, before any tensor is read: DeepSeek serves from safetensors
    (``test_torch_deepseek_loaders.py``), and the MoE family's fused-expert
    GGUFs load (``test_torch_moe_loaders.py``)."""
    path = str(tmp_path / "deepseek2.gguf")
    rng = np.random.default_rng(0)
    G.write_gguf(path, {
        "general.architecture": "deepseek2",
        "deepseek2.block_count": 1,
        "deepseek2.embedding_length": G.D,
        "deepseek2.feed_forward_length": G.I,
        "deepseek2.attention.head_count": G.H,
        "deepseek2.expert_count": 4,
        "deepseek2.expert_used_count": 2,
        "deepseek2.attention.kv_lora_rank": 16,
    }, {"token_embd.weight": (
        rng.standard_normal((G.V, G.D)).astype(np.float32), G.GGML_F32)})
    for mod in (pg, jg):
        with pytest.raises(ValueError, match="'deepseek2' is not supported"):
            mod.config_from_gguf(path)


def _write_tiny(tmp_path):
    path = str(tmp_path / "tiny.gguf")
    G._tiny_gguf(path)
    return path
