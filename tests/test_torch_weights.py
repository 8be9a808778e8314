"""Checkpoint loading of the PyTorch port against the JAX package: the
port's own safetensors reader, ``load_hf_checkpoint``, npz checkpoints in
both directions, PEFT LoRA merges, and the server's ``--model-dir``,
``--lora`` and ``--quantization`` flags on the CPU.

Checkpoints are written here from numpy seeds (the ``safetensors``
package writes the files; the port never imports it). Tolerances:
- the reader: every tensor identical to what ``safetensors`` reads;
- loaded trees: identical bf16 bits to the JAX loader's on the same files;
- npz: bit for bit in both directions, and identical logits;
- LoRA merges on an fp32 tree: within 1e-6 of the JAX merge (the fp32
  delta products' summation order), with the same errors raised.
"""

import dataclasses
import http.client
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import save_file

from gpustack_tpu.engine import weights as jw
from gpustack_tpu.models import init_params as jax_init_params
from gpustack_tpu.models import quant as jq
from gpustack_tpu.models import transformer as jt
from gpustack_tpu.models.config import get_config as jax_get_config
from gpustack_tpu_torch.engine import weights as pw  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.api_server import (  # analysis: ignore[metrics-drift]
    OpenAIServer,
    build_engine_from_args,
    build_parser,
)
from gpustack_tpu_torch.models import quant as pq  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models import transformer as pt  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models.config import get_config  # analysis: ignore[metrics-drift]


def _bits(t):
    t = t.detach().cpu()
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else (
        t.numpy()
    )


def _jbits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _same_tree(got, want, prefix=""):
    """Port tree vs JAX tree: same keys, identical bits, QuantW for
    QuantW."""
    assert sorted(got) == sorted(want), prefix
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            _same_tree(g, w, f"{prefix}{k}/")
        elif isinstance(w, jq.QuantW):
            assert isinstance(g, pq.QuantW), f"{prefix}{k}"
            np.testing.assert_array_equal(_bits(g.q), _jbits(w.q))
            np.testing.assert_array_equal(_bits(g.s), _jbits(w.s))
        else:
            assert not isinstance(g, pq.QuantW), f"{prefix}{k}"
            np.testing.assert_array_equal(_bits(g), _jbits(w), f"{prefix}{k}")


# ---------------------------------------------------------------------------
# the safetensors reader
# ---------------------------------------------------------------------------


def _mixed_tensors():
    g = torch.Generator().manual_seed(0)
    return {
        "a.bf16": torch.randn(3, 5, generator=g).to(torch.bfloat16),
        "b.fp16": torch.randn(4, generator=g).to(torch.float16),
        "c.fp32": torch.randn(2, 3, 4, generator=g),
        "d.int8": torch.randint(-128, 128, (7, 3), generator=g).to(
            torch.int8
        ),
        "e.uint8": torch.randint(0, 256, (9,), generator=g).to(torch.uint8),
        "f.int32": torch.randint(-1000, 1000, (2, 2), generator=g).to(
            torch.int32
        ),
        "g.scalar": torch.tensor(1.5),
        "h.empty": torch.zeros(0, 4),
    }


def test_reader_matches_safetensors_over_two_shards(tmp_path):
    from safetensors import safe_open

    tensors = _mixed_tensors()
    names = sorted(tensors)
    save_file({n: tensors[n] for n in names[:4]},
              str(tmp_path / "model-00001-of-00002.safetensors"),
              metadata={"format": "pt"})
    save_file({n: tensors[n] for n in names[4:]},
              str(tmp_path / "model-00002-of-00002.safetensors"))
    got = pw._read_safetensors(str(tmp_path))
    assert sorted(got) == names
    for f in sorted(os.listdir(tmp_path)):
        with safe_open(str(tmp_path / f), framework="pt") as st:
            for name in st.keys():
                want = st.get_tensor(name)
                assert got[name].dtype == want.dtype, name
                assert got[name].shape == want.shape, name
                assert torch.equal(got[name], want), name
    for name, t in tensors.items():
        assert torch.equal(got[name], t), name


def test_reader_needs_a_file(tmp_path):
    with pytest.raises(FileNotFoundError):
        pw._read_safetensors(str(tmp_path))


def _corrupt(path, case):
    with open(path, "rb") as f:
        raw = f.read()
    (n,) = np.frombuffer(bytes(raw[:8]), "<u8")
    header = json.loads(bytes(raw[8:8 + int(n)]))
    if case == "length":
        return b"\xff" * 8 + bytes(raw[8:])
    if case == "truncated":
        return bytes(raw[:5])
    if case == "not_json":
        return bytes(raw[:8]) + b"{" * int(n) + bytes(raw[8 + int(n):])
    if case == "offsets":
        header["w"]["data_offsets"][1] += 4
    elif case == "dtype":
        header["w"]["dtype"] = "F64"
    elif case == "past_end":
        header["w"]["data_offsets"] = [10**6, 10**6 + 24]
    body = json.dumps(header).encode()
    return (
        np.asarray([len(body)], "<u8").tobytes() + body
        + bytes(raw[8 + int(n):])
    )


@pytest.mark.parametrize(
    "case", ["length", "truncated", "not_json", "offsets", "dtype",
             "past_end"],
)
def test_corrupt_header_is_valueerror(tmp_path, case):
    path = str(tmp_path / "m.safetensors")
    save_file({"w": torch.ones(2, 3)}, path)
    data = _corrupt(path, case)
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(ValueError):
        pw._read_safetensors(str(tmp_path))


# ---------------------------------------------------------------------------
# load_hf_checkpoint against the JAX loader
# ---------------------------------------------------------------------------


def _hf_tensors(cfg, seed=0, lm_head=True):
    """HF-named fp32 torch tensors for a dense llama-family ``cfg``."""
    rng = np.random.default_rng(seed)
    d, f = cfg.hidden_size, cfg.intermediate_size

    def w(*shape):
        return torch.from_numpy(
            (rng.standard_normal(shape) * 0.05).astype(np.float32)
        )

    def gain(n):
        return torch.from_numpy(
            (1.0 + rng.standard_normal(n) * 0.05).astype(np.float32)
        )

    t = {
        "model.embed_tokens.weight": w(cfg.vocab_size, d),
        "model.norm.weight": gain(d),
    }
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        t.update({
            p + "input_layernorm.weight": gain(d),
            p + "self_attn.q_proj.weight": w(cfg.q_dim, d),
            p + "self_attn.k_proj.weight": w(cfg.kv_dim, d),
            p + "self_attn.v_proj.weight": w(cfg.kv_dim, d),
            p + "self_attn.o_proj.weight": w(d, cfg.q_dim),
            p + "post_attention_layernorm.weight": gain(d),
            p + "mlp.gate_proj.weight": w(f, d),
            p + "mlp.up_proj.weight": w(f, d),
            p + "mlp.down_proj.weight": w(d, f),
        })
        if cfg.qkv_bias:
            t[p + "self_attn.q_proj.bias"] = w(cfg.q_dim)
            t[p + "self_attn.k_proj.bias"] = w(cfg.kv_dim)
            t[p + "self_attn.v_proj.bias"] = w(cfg.kv_dim)
        if cfg.qk_norm:
            t[p + "self_attn.q_norm.weight"] = gain(cfg.head_dim)
            t[p + "self_attn.k_norm.weight"] = gain(cfg.head_dim)
    if lm_head:
        t["lm_head.weight"] = w(cfg.vocab_size, d)
    return t


def _hf_config_json(cfg):
    return {
        "architectures": ["LlamaForCausalLM"],
        "model_type": "llama",
        "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads,
        "head_dim": cfg.head_dim,
        "vocab_size": cfg.vocab_size,
        "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.rms_norm_eps,
        "max_position_embeddings": cfg.max_position_embeddings,
        "tie_word_embeddings": cfg.tie_word_embeddings,
    }


def _write_checkpoint(path, cfg, seed=0, lm_head=True, shards=2):
    path.mkdir(parents=True, exist_ok=True)
    tensors = _hf_tensors(cfg, seed, lm_head)
    names = sorted(tensors)
    step = -(-len(names) // shards)
    for i in range(shards):
        save_file(
            {n: tensors[n] for n in names[i * step:(i + 1) * step]},
            str(path / f"model-{i + 1:05d}-of-{shards:05d}.safetensors"),
        )
    (path / "config.json").write_text(json.dumps(_hf_config_json(cfg)))
    return str(path)


CASES = {
    "untied": ("tiny", {}, True),
    "missing_lm_head": ("tiny", {}, False),
    "tied": ("tiny", {"tie_word_embeddings": True}, True),
    "qkv_bias": ("tiny", {"qkv_bias": True}, True),
    "qk_norm": ("tiny-qwen3", {}, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_load_hf_checkpoint_matches_jax_loader(tmp_path, case):
    preset, changes, lm_head = CASES[case]
    cfg = dataclasses.replace(get_config(preset), **changes)
    jcfg = dataclasses.replace(jax_get_config(preset), **changes)
    model_dir = _write_checkpoint(tmp_path / "m", cfg, lm_head=lm_head)
    got = pw.load_hf_checkpoint(cfg, model_dir)
    want = jw.load_hf_checkpoint(jcfg, model_dir)
    _same_tree(got, want)
    assert ("lm_head" in got) == (not cfg.tie_word_embeddings)
    # and through load_or_init_params onto the device, QuantW-free
    placed = pw.load_or_init_params(cfg, model_dir, device="cpu")
    _same_tree(placed, want)
    assert pw.checkpoint_source(model_dir) == ("safetensors", model_dir)


def test_safetensors_wins_over_gguf_in_a_mixed_dir(tmp_path):
    model_dir = _write_checkpoint(tmp_path / "m", get_config("tiny"))
    (tmp_path / "m" / "x.gguf").write_bytes(b"GGUF")
    assert pw.checkpoint_source(model_dir) == jw.checkpoint_source(
        model_dir
    ) == ("safetensors", model_dir)
    assert pw.checkpoint_source(None) == ("none", None)


def test_bf16_checkpoint_loads_bit_for_bit(tmp_path):
    cfg = get_config("tiny")
    tensors = {
        k: v.to(torch.bfloat16) for k, v in _hf_tensors(cfg, 1).items()
    }
    (tmp_path / "m").mkdir()
    save_file(tensors, str(tmp_path / "m" / "model.safetensors"))
    got = pw.load_hf_checkpoint(cfg, str(tmp_path / "m"))
    want = jw.load_hf_checkpoint(jax_get_config("tiny"), str(tmp_path / "m"))
    _same_tree(got, want)
    assert torch.equal(
        got["layers"]["wq"][1], tensors[
            "model.layers.1.self_attn.q_proj.weight"
        ].T
    )


def test_unsupported_family_raises_before_reading(monkeypatch):
    """gpt-oss-20b serves in bf16; with ``--quantization int8`` the server
    refuses it (int8 MoE) before any weight is read or drawn."""
    from gpustack_tpu_torch.engine import api_server  # analysis: ignore[metrics-drift]

    def no_load(*a, **k):
        raise AssertionError("weights were read")

    monkeypatch.setattr(pw, "load_or_init_params", no_load)
    monkeypatch.setattr(pq, "init_quantized_params", no_load)
    args = api_server.build_parser().parse_args([
        "--preset", "gpt-oss-20b", "--device", "cpu", "--quantization",
        "int8",
    ])
    with pytest.raises(NotImplementedError, match="int8 MoE"):
        api_server.build_engine_from_args(args)


# ---------------------------------------------------------------------------
# npz checkpoints, both directions
# ---------------------------------------------------------------------------


def _jax_quantized():
    jcfg = jax_get_config("tiny")
    return jcfg, jq.quantize_params(jax_init_params(jcfg, jax.random.key(0)))


def _forward_both(cfg, jcfg, tparams, jparams):
    toks = np.asarray([[5, 17, 42]], np.int32)
    pos = np.arange(3, dtype=np.int32)[None, :]
    want, _ = jt.forward(jparams, jcfg, jnp.asarray(toks), jnp.asarray(pos))
    got, _ = pt.forward(
        tparams, cfg, torch.from_numpy(toks).long(),
        torch.from_numpy(pos).long(),
    )
    return got, want


def test_checkpoint_roundtrip_quantized(tmp_path):
    cfg = get_config("tiny")
    params = pq.init_quantized_params(cfg, seed=1, device="cpu")
    path = str(tmp_path / "ckpt.npz")
    pw.save_checkpoint(params, path)
    loaded = pw.load_checkpoint(path, device="cpu")
    assert isinstance(loaded["layers"]["wq"], pq.QuantW)
    toks = torch.tensor([[5, 17, 42]])
    pos = torch.arange(3)[None, :]
    ref, _ = pt.forward(params, cfg, toks, pos)
    out, _ = pt.forward(loaded, cfg, toks, pos)
    assert torch.equal(ref, out)


def test_jax_saves_port_loads(tmp_path):
    jcfg, jparams = _jax_quantized()
    path = str(tmp_path / "jax.npz")
    jw.save_checkpoint(jparams, path)
    loaded = pw.load_checkpoint(path, device="cpu")
    _same_tree(loaded, jparams)
    got, want = _forward_both(get_config("tiny"), jcfg, loaded, jparams)
    # bf16 compute in two frameworks: the same tree, close logits
    np.testing.assert_allclose(
        got.numpy(), np.asarray(want), rtol=5e-2, atol=5e-2
    )


def test_port_saves_jax_loads(tmp_path):
    jcfg, jparams = _jax_quantized()
    tparams = pw.params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu"
    )
    path = str(tmp_path / "port.npz")
    pw.save_checkpoint(tparams, path)
    loaded = jw.load_checkpoint(path)
    _same_tree(tparams, loaded)
    with np.load(path) as a, np.load(_jax_save(jparams, tmp_path)) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], k)


def _jax_save(jparams, tmp_path):
    path = str(tmp_path / "jax-ref.npz")
    jw.save_checkpoint(jparams, path)
    return path


# ---------------------------------------------------------------------------
# LoRA
# ---------------------------------------------------------------------------


def _write_adapter(tmp_path, cfg, r=4, alpha=8, layers=(0,), rslora=False,
                   name="adapter", drop_b=False):
    """A PEFT adapter on q_proj and down_proj (torch convention: lora_A
    [r, in], lora_B [out, r])."""
    rng = np.random.default_rng(0)
    d, f = cfg.hidden_size, cfg.intermediate_size
    tensors = {}
    for i in layers:
        p = f"base_model.model.model.layers.{i}"
        for mod, n_in, n_out in (("self_attn.q_proj", d, cfg.q_dim),
                                 ("mlp.down_proj", f, d)):
            tensors[f"{p}.{mod}.lora_A.weight"] = torch.from_numpy(
                rng.standard_normal((r, n_in)).astype(np.float32) * 0.01
            )
            if not drop_b:
                tensors[f"{p}.{mod}.lora_B.weight"] = torch.from_numpy(
                    rng.standard_normal((n_out, r)).astype(np.float32) * 0.01
                )
    adapter = tmp_path / name
    adapter.mkdir()
    save_file(tensors, str(adapter / "adapter_model.safetensors"))
    acfg = {"r": r, "lora_alpha": alpha}
    if rslora:
        acfg["use_rslora"] = True
    (adapter / "adapter_config.json").write_text(json.dumps(acfg))
    return str(adapter), tensors


def _fp32_pair():
    jcfg = dataclasses.replace(jax_get_config("tiny"), dtype="float32")
    cfg = dataclasses.replace(get_config("tiny"), dtype="float32")
    jparams = jax_init_params(jcfg, jax.random.key(0), dtype=jnp.float32)
    tparams = pw.params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu"
    )
    return cfg, jcfg, tparams, jparams


@pytest.mark.parametrize("rslora", [False, True])
def test_merge_matches_jax_merge(tmp_path, rslora):
    cfg, jcfg, tparams, jparams = _fp32_pair()
    base_wq = tparams["layers"]["wq"][0].clone()
    base_l1 = tparams["layers"]["wq"][1].clone()
    adapter, tensors = _write_adapter(tmp_path, cfg, rslora=rslora)
    pw.merge_lora_adapters(cfg, tparams, [adapter])
    jmerged = jw.merge_lora_adapters(jcfg, jparams, [adapter])
    for name in ("wq", "w_down"):
        np.testing.assert_allclose(
            tparams["layers"][name].numpy(),
            np.asarray(jmerged["layers"][name]), rtol=0, atol=1e-6,
        )
    a = tensors["base_model.model.model.layers.0.self_attn.q_proj.lora_A"
                ".weight"]
    b = tensors["base_model.model.model.layers.0.self_attn.q_proj.lora_B"
                ".weight"]
    scale = 8 / 4 ** 0.5 if rslora else 8 / 4
    torch.testing.assert_close(
        tparams["layers"]["wq"][0], base_wq + (a.T @ b.T) * scale,
        rtol=0, atol=1e-6,
    )
    assert torch.equal(tparams["layers"]["wq"][1], base_l1)   # untouched


def test_merged_model_changes_output_and_matches_jax(tmp_path):
    cfg, jcfg, tparams, jparams = _fp32_pair()
    base, _ = _forward_both(cfg, jcfg, tparams, jparams)
    adapter, _ = _write_adapter(tmp_path, cfg, layers=(0, 1))
    pw.merge_lora_adapters(cfg, tparams, [adapter])
    jw.merge_lora_adapters(jcfg, jparams, [adapter])
    got, want = _forward_both(cfg, jcfg, tparams, jparams)
    assert not torch.allclose(base, got)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(
        got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4
    )


@pytest.mark.parametrize("case,match", [
    ("useless", "no mergeable"),
    ("layer_out_of_range", "targets layer"),
    ("missing_b", "missing"),
])
def test_merge_errors_match_jax(tmp_path, case, match):
    cfg, jcfg, tparams, jparams = _fp32_pair()
    if case == "useless":
        adapter = tmp_path / "bad"
        adapter.mkdir()
        save_file({"unrelated.weight": torch.zeros(2, 2)},
                  str(adapter / "adapter_model.safetensors"))
        adapter = str(adapter)
    elif case == "layer_out_of_range":
        adapter, _ = _write_adapter(tmp_path, cfg, layers=(cfg.num_layers,))
    else:
        adapter, _ = _write_adapter(tmp_path, cfg, drop_b=True)
    with pytest.raises(ValueError, match=match):
        pw.merge_lora_adapters(cfg, tparams, [adapter])
    with pytest.raises(ValueError, match=match):
        jw.merge_lora_adapters(jcfg, jparams, [adapter])


# ---------------------------------------------------------------------------
# the server's flags
# ---------------------------------------------------------------------------


def _chat(port):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", "/v1/chat/completions", body=json.dumps({
            "messages": [{"role": "user", "content": "hi"}],
            "max_tokens": 4, "temperature": 0,
        }), headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _serve_chat(argv):
    args = build_parser().parse_args(
        argv + ["--device", "cpu", "--max-seq-len", "128",
                "--max-slots", "2"]
    )
    engine = build_engine_from_args(args)
    engine.start()
    server = OpenAIServer(engine)
    try:
        status, body = _chat(server.start("127.0.0.1", 0))
        assert status == 200, body
        assert body["usage"]["completion_tokens"] >= 1
        return engine
    finally:
        server.shutdown()
        engine.stop()


def _gguf_dir(tmp_path):
    import importlib.util

    path = os.path.join(os.path.dirname(__file__), "engine", "test_gguf.py")
    spec = importlib.util.spec_from_file_location("_jax_gguf_suite_w", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    d = tmp_path / "g"
    d.mkdir()
    mod._tiny_gguf(str(d / "tiny.gguf"))
    return str(d)


@pytest.mark.parametrize("case", [
    "safetensors", "safetensors+lora+int8", "gguf", "gguf+int8",
    "preset+int8",
])
def test_server_serves_checkpoints_and_int8(tmp_path, case):
    cfg = get_config("tiny")
    argv = []
    if case.startswith("safetensors"):
        model_dir = _write_checkpoint(tmp_path / "m", cfg)
        argv += ["--model-dir", model_dir]
    elif case.startswith("gguf"):
        model_dir = _gguf_dir(tmp_path)
        argv += ["--model-dir", model_dir]
    else:
        argv += ["--preset", "tiny"]
    if "lora" in case:
        adapter, _ = _write_adapter(tmp_path, cfg)
        argv += ["--lora", adapter]
    if "int8" in case:
        argv += ["--quantization", "int8"]
    engine = _serve_chat(argv)
    params = engine.runner.params
    assert isinstance(params["layers"]["w_gate"], pq.QuantW) == (
        "int8" in case
    )
    if case == "safetensors+lora+int8":
        # load, merge, then quantize: the order the JAX server uses
        want = pw.load_or_init_params(cfg, model_dir, device="cpu")
        pw.merge_lora_adapters(cfg, want, [adapter])
        want = pq.quantize_params(want)
        assert torch.equal(params["layers"]["wq"].q, want["layers"]["wq"].q)
        assert torch.equal(params["layers"]["wq"].s, want["layers"]["wq"].s)
    if case.startswith("gguf"):
        assert type(engine.tokenizer).__name__ == "GGUFVocabTokenizer"
