#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: ``python3 chip_smoke.py``.

Phases (each prints one JSON line; any failure raises and exits non-zero):

a. device: the card's name, count and power limit;
b. build: every CUDA source of the port, one ``nvcc`` each, in parallel,
   with each kernel's ``ptxas`` registers, whether ``setmaxnreg`` took
   effect (no C7508 warning) and any ``wgmma`` serialisation ptxas
   reports;
c. kernels: each hand-written kernel against its plain PyTorch version on
   the card, at the shapes the main paths give it, with times (CUDA
   events; the main shape three times, for a spread) beside the least time
   the card could take (``bound_ms``), one PyTorch library call computing
   the same function where there is one (``library_ms``, a yardstick the
   port never calls), and the host's microseconds per call (wall clock
   around back-to-back enqueues), which says whether a row is host- or
   device-bound. W8A16 rows also time cuBLAS on the weight dequantized
   ahead of time and the eager ``(x @ q.to(bf16)) * s``, each over copies
   of the weight larger than L2, as a decode step meets its weights: the
   decode GEMV at every weight, the ``wgmma`` path at M = 64, 512 and 2048
   at every weight and at a speculative verify block's M = 32 (8 slots x
   4 positions, lm_head too), and ragged shapes (M, N and K off the tiles,
   strided x and q views) checked without timing; the flash kernel also at
   the cacheless embedding shapes (B of 2, 4 and 8, T = S), at
   deepseek-v2-lite's heads (16 q and kv heads, d 192: every bucket phase
   i fills, a continuation, its 8 x 2048 embedding batch) and once at
   d 64;
d. main path: the port's OpenAI server in-process, serving llama3-8b at
   full width (bf16, random weights from a seed) with 8 slots and a
   2048-token context: chat, streaming chat, a completion whose prompt
   fills the 2048 bucket, four concurrent chats, and a repeated greedy
   prompt. A kernel prefill's last-position logits are held against a
   prefill through the plain attention. Reported: TTFT of one 2048-bucket
   prompt, decode tokens/s with 8 slots busy, peak memory, and the
   2048-bucket prefill timed with CUDA events;
e. prefix reuse: the same model with ``--prefill-chunk 512
   --host-kv-cache-mb 4096``: continuations against one prefill,
   multi-turn chats with exact hit and reuse counts, a 1900-token prompt
   chunked while four chats decode, ``/metrics``;
f. checkpoints and int8: llama3-8b's full widths at 2 layers written as a
   safetensors checkpoint (the script's own writer) and served through
   ``--model-dir``, the loaded tree and logits identical to the in-memory
   tree's; then llama3-8b int8 at full depth (``--quantization int8``)
   through the server with phase d's requests, its kernel logits against
   the W8A16 plain version, beside phase d's bf16 numbers;
g. speculation, embeddings and profile: llama3-8b int8 with
   ``--speculative ngram`` and bf16 with ``--speculative draft
   --draft-source llama3-8b`` (a perfect draft: the preset's weights come
   from the target's seed), each beside a plain engine over the same
   weights. Eight repetitive greedy chats on each: the speculative ids
   must equal the plain ones or part only where the plain run's top two
   logprobs were closer than twice the logit tolerance (two forwards each
   within 5% of the logit scale); the n-gram server must accept proposals,
   the perfect draft at least 90% of them. On each plain server:
   ``/v1/embeddings`` of 8 inputs at the 2048 bucket (each vector within
   cosine 0.999 of the same forward through the plain attention),
   ``dimensions``, ``base64`` and ``/v1/rerank``; then
   ``/debug/profile?steps=20`` while 8 chats decode, its Chrome trace
   summarised (device-busy share, the 10 ops with the most device time,
   idle time per step);
h. the MoE family: qwen3-30b-a3b (qk-norm, 128 experts, top-8, dense
   dispatch as in the JAX module): its full widths at 2 layers written in
   Qwen3-MoE naming and served through ``--model-dir`` (loaded tree and
   logits identical to the in-memory tree's); then bf16 at full width and
   depth (48 layers, ~61 GB, random weights from a seed) through the
   server with phase d's requests, its kernel logits against the plain
   attention (the kernel run's expert picks replayed in the plain run:
   top-k routing on random weights flips near-tied picks on any rounding
   change; the free-routing comparison is reported beside it), TTFT,
   decode tokens/s, peak memory, the 2048-bucket prefill, and a 20-step
   ``/debug/profile`` while 8 chats decode (``moe_profile``); then a
   ``moe`` line: one MoE layer at the 2048 bucket and at 8 decoding
   slots, held against an fp32 routed reference (each token through its
   own experts), timed with CUDA events beside its dense-dispatch bound
   and its routed bound (the experts the input's routing reaches), with
   its transient memory (no ``[E, tokens, D]`` copy of x) and its device
   time split by kernel. Phase c times the flash kernel at this model's
   heads too (32 q heads on 4 kv heads, a group of 8);
i. the DeepSeek family: deepseek-v2-lite (MLA served decompressed, K 192
   wide and V zero-padded to it; one dense layer then 26 DeepSeek-MoE
   layers of 64 experts, top-6, two shared; YaRN with its mscale² softmax
   scale) once phase h's tree is freed: its full widths at 2 layers (one
   dense, one MoE) written in DeepSeek-V2 naming and served through
   ``--model-dir`` (loaded tree and logits identical to the in-memory
   tree's); then bf16 at full width and depth (27 layers, ~31.4 GB)
   through the server with phase d's requests (flash logits against the
   plain attention with the kernel run's expert picks replayed, free
   routing beside), ``/v1/embeddings`` at the 2048 bucket against the
   plain attention, a 20-step profile, and a ``moe`` line for one of its
   MoE layers with the shared experts in the layer, its reference and its
   bounds;
j. the GPT-OSS family: gpt-oss-20b (attention sinks, a window of 128 on
   the even layers, q/k/v/o biases, YaRN; 32 experts, top-4, the affine
   router, clamped GLU with expert biases) once phase i's tree is freed:
   its full widths at 2 layers written in GPT-OSS naming with the expert
   weights packed as MXFP4 blocks and scales (the script's own packer)
   and served through ``--model-dir`` (the loaded tree and logits
   identical to the in-memory tree rounded to fp4 by that packing); then
   bf16 at full width and depth (24 layers, ~41.8 GB) through the server
   with phase d's requests, ``/v1/embeddings`` at the 2048 bucket, a
   20-step profile, a 2048-bucket prefill split into its attention and
   MoE time (CUDA events), and a ``moe`` line. Its prefills take the plain
   attention, as the JAX ``forward``'s do (no flash for sliding windows,
   softcaps or sinks), so its served logits and embeddings are held
   against the fp32 plain forward over the same weights, with the served
   run's expert picks replayed (free routing beside it);
k. the Gemma family: gemma2-9b (delta-gain sandwich norms, the scaled and
   tied embedding, tanh GELU, ``query_pre_attn_scalar`` 256, attention
   and final softcaps, a window of 4096 on the even layers): its full
   widths at 2 layers as a tied Gemma2 checkpoint through ``--model-dir``;
   bf16 at full width and depth (42 layers, ~18.5 GB) with phase d's
   requests and embeddings, held against the fp32 plain forward; then
   ``--quantization int8`` with phase d's requests, its W8A16 kernel
   logits against the plain version; each path's 2048-bucket prefill
   split into its attention time. Phase c times the W8A16 kernel at this
   model's widths too.

In d to k every kernel's launches are counted around the served
requests alone and must equal what that path's model forwards need,
derived from the runners' calls (a draft model's too): the flash kernel
once per layer of every prefill and embedding forward of a model whose
config takes it (none with a sliding window, softcap or sinks: phases j
and k launch it never); on the int8 path the W8A16 kernel 7 per layer at
M = B·T plus an untied lm_head at the rows it reads (a prefill's last
position, a decode step's slots, every position of a verify block; none
for an embedding; a tied lm_head is the bf16 embedding's transpose),
never on a bf16 path, and counted per path by M: M ≤ 16 the GEMV, above
it the ``wgmma`` path. Each kernel must launch on at least one path.

The last lines are the ``kernels`` line, the ``nvidia-smi`` name and
power-limit line, and ``{"ok": true, "device": {...}}``. Without CUDA, or
outside a checkout of the repository, it exits non-zero and prints no
result.
"""

import base64
import dataclasses
import gc
import json
import os
import re
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import torch

PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES_S = 3.35e12        # H100 SXM HBM3
# bf16 kernel output against the fp32 plain version of the same bf16
# inputs: bf16 output rounding (2^-8 relative) plus the kernel's bf16
# probabilities in the P.V product
KERNEL_RTOL = KERNEL_ATOL = 2e-2
# the same error per output row (one q row of one head, d values), relative
# to the row's norm: late rows average v over ~2000 keys and have |out| of
# ~0.03, where the bound above would let a kernel be tens of percent wrong
KERNEL_ROW_RTOL = 1e-2
# last-position logits, kernel prefill vs plain prefill, llama3-8b bf16:
# 32 layers of bf16 activations amplify the attention rounding; bounded
# relative to the logit scale, and the two must point the same way
LOGIT_REL_TOL = 5e-2
LOGIT_MIN_COSINE = 0.999
# W8A16 bf16 output against the fp32 plain version of the same int8 and
# bf16 inputs: bf16 output rounding and the fp32 summation order; each
# output row also within 1% of its norm, so a wrong K slice or a missing
# scale cannot hide under the element bound
W8A16_RTOL = W8A16_ATOL = 2e-2
W8A16_ROW_RTOL = 1e-2
# llama3-8b's weight products, K x N ([in, out], the JAX layout)
LLAMA3_8B_MATMULS = {
    "wq/wo": (4096, 4096),
    "wk/wv": (4096, 1024),
    "w_gate/w_up": (4096, 14336),
    "w_down": (14336, 4096),
    "lm_head": (4096, 128256),
}
# gemma2-9b's (phase k's int8 path): head_dim 256 (16 q heads, 8 kv), d
# 3584, F 14336
GEMMA2_9B_MATMULS = {
    "wq": (3584, 4096),
    "wk/wv": (3584, 2048),
    "wo": (4096, 3584),
    "w_gate/w_up": (3584, 14336),
    "w_down": (14336, 3584),
}
# the weights a decode step reads back to back never sit in the 50 MB L2:
# time each shape over copies of its weight totalling at least this much
L2_FLUSH_BYTES = 128 * 2**20


_T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line; ``t_s`` is the seconds since the script started (the
    run's time budget, phase by phase)."""
    print(json.dumps({"phase": phase, **fields,
                      "t_s": time.perf_counter() - _T0}), flush=True)


def cuda_time_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us_per_call(fn, iters: int = 200) -> float:
    """Host wall clock per call over back-to-back enqueues (no sync
    between them; one at the end): above the device time, a row is
    host-bound."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


# ---------------------------------------------------------------------------
# a + b
# ---------------------------------------------------------------------------


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit("device", kind=kind, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    return kind, smi


def _kernel_name(mangled: str) -> str:
    """``name`` or ``name<N>`` from an Itanium-mangled kernel name: the last
    of its length-prefixed identifiers, with an ``int`` template argument
    if one follows."""
    pos = 3 if mangled.startswith("_ZN") else 2
    name = mangled
    while True:
        d = re.match(r"\d+", mangled[pos:])
        if not d:
            break
        start = pos + len(d.group())
        end = start + int(d.group())
        name, pos = mangled[start:end], end
    t = re.match(r"ILi(\d+)E", mangled[pos:])
    return f"{name}<{t.group(1)}>" if t else name


def _ptxas_kernels(log: str) -> dict:
    """{kernel: registers} from an ``-Xptxas -v`` log."""
    regs, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = _kernel_name(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            regs[name] = int(m.group(1))
    return regs


def phase_build():
    from gpustack_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build_all(ptxas=True)
    seconds = time.perf_counter() - t0
    report = {
        name: {
            "registers": _ptxas_kernels(log),
            "spills": [
                line.strip() for line in log.splitlines()
                if "spill" in line and "0 bytes spill stores, 0 bytes "
                "spill loads" not in line
            ],
            # C7508: ptxas could not place setmaxnreg and ignored it
            "setmaxnreg_applied": "C7508" not in log
            and "setmaxnreg ignored" not in log,
            # C75xx "Potential Performance Loss": each wgmma waits for the
            # one before it
            "wgmma_serialized": [
                line.strip() for line in log.splitlines()
                if "wgmma" in line and "serialized" in line
            ],
            "warnings": [
                line.strip() for line in log.splitlines()
                if "warning" in line.lower()
            ],
        }
        for name, log in logs.items()
    }
    emit("build", seconds=seconds, sources=_build.sources(), ptxas=report)


# ---------------------------------------------------------------------------
# c: kernels against their plain versions
# ---------------------------------------------------------------------------


def _check_flash(out, q, k, v, scale, off):
    from gpustack_tpu_torch.ops import flash_attention as fa

    ref = fa.flash_attention_prefill_ref(
        q.float(), k.float(), v.float(), scale, off
    )
    err = (out.float() - ref).abs()
    bad = err > KERNEL_ATOL + KERNEL_RTOL * ref.abs()
    rows = ref.reshape(*ref.shape[:2], q.shape[2], q.shape[3])
    row_rel = (
        (out.float().reshape(rows.shape) - rows).norm(dim=-1)
        / rows.norm(dim=-1).clamp_min(1e-30)
    ).max().item()
    if (
        not torch.isfinite(out.float()).all() or bad.any()
        or not row_rel <= KERNEL_ROW_RTOL
    ):
        raise AssertionError(
            f"flash kernel disagrees at {tuple(q.shape)} k {tuple(k.shape)} "
            f"offset {off}: max |err| {err.max().item()} "
            f"({int(bad.sum())} elements outside tolerance), max row "
            f"|err|/|ref| {row_rel}"
        )
    return err.max().item(), row_rel


def _flash_case(B, T, S, off, Hq, Hkv, d, gen, repeats=1):
    from gpustack_tpu_torch.ops import flash_attention as fa

    q = torch.randn(B, T, Hq, d, generator=gen, device="cuda").bfloat16()
    k = torch.randn(B, S, Hkv, d, generator=gen, device="cuda").bfloat16()
    v = torch.randn(B, S, Hkv, d, generator=gen, device="cuda").bfloat16()
    scale = d ** -0.5
    out = fa.flash_attention_prefill(q, k, v, scale, off)
    torch.cuda.synchronize()
    max_err, row_rel = _check_flash(out, q, k, v, scale, off)

    def kernel():
        return fa.flash_attention_prefill(q, k, v, scale, off)

    ms_runs = [cuda_time_ms(kernel) for _ in range(repeats)]
    host_us = host_us_per_call(kernel)
    plain_ms = cuda_time_ms(
        lambda: fa.flash_attention_prefill_ref(q, k, v, scale, off),
        warmup=1, iters=5,
    )
    # one library call computing the same function (yardstick only)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    if off == 0 and T == S:
        mask = None
    else:
        mask = (
            torch.arange(S, device="cuda")[None, :]
            <= off + torch.arange(T, device="cuda")[:, None]
        )
    library_ms = cuda_time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask, is_causal=mask is None,
            scale=scale, enable_gqa=True,
        )
    )
    # least time: each input read once, the output written once; the
    # operations this causal offset needs (two products per visible pair)
    pairs = sum(min(S, off + t + 1) for t in range(T))
    flops = 4 * B * Hq * d * pairs
    nbytes = 2 * (2 * B * T * Hq * d + 2 * B * S * Hkv * d)
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    ms = statistics.median(ms_runs)
    return {
        "shape": {"B": B, "T": T, "S": S, "q_offset": off, "Hq": Hq,
                  "Hkv": Hkv, "d": d},
        "max_abs_err": max_err, "max_row_rel_err": row_rel,
        "ms": ms, "ms_runs": ms_runs, "plain_ms": plain_ms,
        "library_ms": library_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "host_us_per_call": host_us,
        "limited_by": "host" if host_us / 1e3 >= ms else "device",
        "tflops": flops / ms / 1e9,
        "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
    }


def phase_kernels():
    """Returns {kernel name: the row for the main path's shape}."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    # llama3-8b attention widths (32 q heads, 8 kv heads, d 128): every
    # bucket the main path fills (2048 long prompts, 1024 the logit check,
    # 64 the chats, 32 the short decode-rate prompts), a chunk
    # continuation against a 2048 cache, and a ragged T
    cases = [
        (1, 2048, 2048, 0, 32, 8, 128),
        (1, 1024, 1024, 0, 32, 8, 128),
        (1, 64, 64, 0, 32, 8, 128),
        (1, 32, 32, 0, 32, 8, 128),
        (1, 512, 2048, 1536, 32, 8, 128),
        (1, 1000, 1000, 0, 32, 8, 128),
        # continuations phase e serves: a 512 chunk at 1024, a 32-token
        # suffix after a 256-block prefix hit, and offsets off the
        # kernel's 128-row/128-key tiles (16-token block granularity)
        (1, 512, 2048, 1024, 32, 8, 128),
        (1, 32, 2048, 1792, 32, 8, 128),
        (1, 64, 1024, 784, 32, 8, 128),
        (1, 128, 2048, 1888, 32, 8, 128),
        # embedding forwards (phase g): cacheless, the batch padded to a
        # power of two, T = S = the bucket
        (8, 2048, 2048, 0, 32, 8, 128),
        (4, 2048, 2048, 0, 32, 8, 128),
        (2, 512, 512, 0, 32, 8, 128),
        (8, 64, 64, 0, 32, 8, 128),
        # qwen3-30b-a3b (phase h): 32 q heads on 4 kv heads, a group of 8,
        # at every bucket phase h fills
        (1, 2048, 2048, 0, 32, 4, 128),
        (1, 1024, 1024, 0, 32, 4, 128),
        (1, 64, 64, 0, 32, 4, 128),
        (1, 32, 32, 0, 32, 4, 128),
        # deepseek-v2-lite (phase i): MLA served decompressed, 16 heads at
        # d 192 (64-key tiles, 3 stages), at every bucket phase i fills, a
        # continuation and its cacheless embedding batch
        (1, 2048, 2048, 0, 16, 16, 192),
        (1, 1024, 1024, 0, 16, 16, 192),
        (1, 64, 64, 0, 16, 16, 192),
        (1, 32, 32, 0, 16, 16, 192),
        (1, 512, 2048, 1536, 16, 16, 192),
        (8, 2048, 2048, 0, 16, 16, 192),
        # d 64 (no served model has it): its code and time are kept
        (1, 2048, 2048, 0, 32, 8, 64),
    ]
    group8 = cases.index((1, 2048, 2048, 0, 32, 4, 128))
    mla = cases.index((1, 2048, 2048, 0, 16, 16, 192))
    rows = [
        _flash_case(*c, gen, repeats=3 if i in (0, group8, mla) else 1)
        for i, c in enumerate(cases)
    ]
    from gpustack_tpu_torch.ops import _build
    from gpustack_tpu_torch.ops import flash_attention as fa

    smem = _build.load("flash_attention").flash_prefill_smem_bytes
    emit("kernels", name="flash_attention_prefill",
         tolerance={"rtol": KERNEL_RTOL, "atol": KERNEL_ATOL,
                    "row_rtol": KERNEL_ROW_RTOL},
         smem_bytes_per_cta={d: smem(d) for d in fa.SUPPORTED_HEAD_DIMS},
         cases=rows)
    # W8A16 at the shapes the int8 path gives it: decode (8 slots) for
    # every weight and the prefill's last position through lm_head (the
    # GEMV); the 2048 bucket, a 512 chunk and a 64-token bucket for every
    # layer weight (the wgmma path)
    layer_weights = ("w_gate/w_up", "w_down", "wq/wo", "wk/wv")
    w8_cases = [(8, *LLAMA3_8B_MATMULS[n], n) for n in (
        "w_gate/w_up", "wq/wo", "wk/wv", "w_down", "lm_head",
    )] + [(1, *LLAMA3_8B_MATMULS["lm_head"], "lm_head")] + [
        (M, *LLAMA3_8B_MATMULS[n], n)
        for M in (2048, 512, 64) for n in layer_weights
    ] + [
        # a speculative verify block (8 slots x 4 positions), lm_head too
        (32, *LLAMA3_8B_MATMULS[n], n)
        for n in layer_weights + ("lm_head",)
    ] + [
        # gemma2-9b's int8 path (phase k): a decode step's 8 slots and the
        # 2048 bucket, every layer weight (its tied lm_head stays bf16)
        (M, *GEMMA2_9B_MATMULS[n], f"gemma2-9b {n}")
        for M in (8, 2048) for n in GEMMA2_9B_MATMULS
    ]
    large = w8_cases.index((2048, *LLAMA3_8B_MATMULS["w_gate/w_up"],
                            "w_gate/w_up"))
    gemma2 = w8_cases.index((2048, *GEMMA2_9B_MATMULS["w_gate/w_up"],
                             "gemma2-9b w_gate/w_up"))
    w8_rows = [
        _w8a16_case(*c, gen, repeats=3 if i in (0, large, gemma2) else 1)
        for i, c in enumerate(w8_cases)
    ]
    # ragged shapes, checked only: M, N and K off the tiles (N % 16 but not
    # % 64, K % 8 but not % 64), q a column slice of a wider stacked layer
    # (rows ldq != N apart), x rows wider than K
    ragged = [
        _w8a16_check_strided(M, K, N, gen)
        for M, K, N in ((17, 4104, 4112), (100, 4104, 1040),
                        (2048, 4104, 4112), (333, 14336, 4112))
    ]
    smem = _build.load("w8a16_gemm").w8a16_wgmma_smem_bytes
    emit("kernels", name="w8a16_matmul",
         tolerance={"rtol": W8A16_RTOL, "atol": W8A16_ATOL,
                    "row_rtol": W8A16_ROW_RTOL},
         wgmma_smem_bytes_per_cta={bn: smem(bn) for bn in (128, 256)},
         cases=w8_rows, ragged=ragged)
    return {"flash_attention_prefill": rows[0], "w8a16_matmul": w8_rows[0],
            "w8a16_large_m": w8_rows[large], "w8a16_gemma2": w8_rows[gemma2],
            "flash_group8": rows[group8], "flash_mla": rows[mla]}


def _check_w8a16(out, x, q, s):
    from gpustack_tpu_torch.ops import w8a16

    ref = w8a16.w8a16_plain(x.float(), q, s)
    err = (out.float() - ref).abs()
    bad = err > W8A16_ATOL + W8A16_RTOL * ref.abs()
    row_rel = (
        err.norm(dim=-1) / ref.norm(dim=-1).clamp_min(1e-30)
    ).max().item()
    if (
        not torch.isfinite(out.float()).all() or bad.any()
        or not row_rel <= W8A16_ROW_RTOL
    ):
        raise AssertionError(
            f"W8A16 kernel disagrees at x {tuple(x.shape)} q "
            f"{tuple(q.shape)}: max |err| {err.max().item()} "
            f"({int(bad.sum())} elements outside tolerance), max row "
            f"|err|/|ref| {row_rel}"
        )
    return err.max().item(), row_rel


def _rotating(fn, args):
    """A call that walks ``args`` round robin, one set per call."""
    state = {"i": 0}

    def call():
        a = args[state["i"] % len(args)]
        state["i"] += 1
        return fn(*a)

    return call


def _int8pack_ms(x, qs, s):
    """The one CUDA call torch might offer for this function:
    ``torch._weight_int8pack_mm`` (q as [N, K]), a few calls only above
    the decode shapes (it takes ~0.26 s at 2048 x 4096 x 14336). Returns
    (ms or None, what was timed or why nothing was)."""
    fn = getattr(torch, "_weight_int8pack_mm", None)
    if fn is None:
        return None, "this torch has no _weight_int8pack_mm"
    qts = [q.T.contiguous() for q in qs]
    try:
        out = fn(x, qts[0], s)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, TypeError) as e:
        return None, (
            "torch._weight_int8pack_mm refused the card's tensors: "
            + str(e).strip().splitlines()[0][:200]
        )
    try:
        _check_w8a16(out, x, qts[0].T, s)
    except AssertionError as e:
        return None, f"torch._weight_int8pack_mm computes another function: {e}"
    few = x.shape[0] > 16
    return cuda_time_ms(
        _rotating(fn, [(x, qt, s) for qt in qts]),
        warmup=1 if few else 3, iters=3 if few else 20,
    ), "torch._weight_int8pack_mm"


def _w8a16_case(M, K, N, weight, gen, repeats=1):
    from gpustack_tpu_torch.ops import w8a16

    x = torch.randn(M, K, generator=gen, device="cuda").bfloat16()
    q = torch.randint(
        -127, 128, (K, N), generator=gen, device="cuda", dtype=torch.int8
    )
    # the int8 init's scale (3 / sqrt(fan_in) / 127), jittered per channel
    s = (
        (0.5 + torch.rand(N, generator=gen, device="cuda"))
        * (3.0 / K ** 0.5 / 127.0)
    ).bfloat16()
    out = w8a16.w8a16_matmul(x, q, s)
    torch.cuda.synchronize()
    max_err, row_rel = _check_w8a16(out, x, q, s)
    copies = max(1, -(-L2_FLUSH_BYTES // (K * N)))
    qs = [q] + [q.clone() for _ in range(copies - 1)]
    kernel = _rotating(w8a16.w8a16_matmul, [(x, qi, s) for qi in qs])
    ms_runs = [cuda_time_ms(kernel) for _ in range(repeats)]
    host_us = host_us_per_call(kernel)
    plain_ms = cuda_time_ms(
        lambda: w8a16.w8a16_plain(x, q, s), warmup=1, iters=3
    )
    # yardsticks the port never calls: cuBLAS on the weight dequantized
    # ahead of time (what bf16 serving pays), and the eager line
    ws = [(qi.float() * s.float()).bfloat16() for qi in qs]
    cublas_ms = cuda_time_ms(_rotating(torch.matmul, [(x, w) for w in ws]))
    del ws
    eager_ms = cuda_time_ms(_rotating(
        lambda xi, qi, si: (xi @ qi.to(torch.bfloat16)) * si,
        [(x, qi, s) for qi in qs],
    ))
    library_ms, library_call = _int8pack_ms(x, qs, s)
    del qs
    flops = 2 * M * N * K
    nbytes = M * K * 2 + K * N + N * 2 + M * N * 2
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    ms = statistics.median(ms_runs)
    sms = w8a16._sm_count(q.device.index)
    if M <= w8a16.GEMV_MAX_M:
        ksplit = w8a16.gemv_plan(N, K, sms)[1]
        plan = {"path": "gemv", "ksplit": ksplit,
                "ctas": -(-N // w8a16.GEMV_BN) * ksplit,
                "ctas_per_sm": w8a16._kernel_lib().w8a16_gemv_ctas_per_sm(M)}
    else:
        bn, grid_m, grid_n, _, ksplit = w8a16.wgmma_plan(M, N, K, sms)
        ctas = grid_m * grid_n * ksplit
        plan = {"path": "wgmma", "bn": bn, "ksplit": ksplit, "ctas": ctas,
                "waves": ctas / sms}
    return {
        "weight": weight, "shape": {"M": M, "K": K, "N": N}, **plan,
        "max_abs_err": max_err, "max_row_rel_err": row_rel,
        "ms": ms, "ms_runs": ms_runs, "plain_ms": plain_ms,
        "library_ms": library_ms, "library_call": library_call,
        "cublas_bf16_dequantized_ms": cublas_ms, "eager_dequant_ms": eager_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "host_us_per_call": host_us,
        "limited_by": "host" if host_us / 1e3 >= ms else "device",
        "weight_copies_timed": copies,
        "gbytes_per_s": nbytes / ms / 1e6, "tflops": flops / ms / 1e9,
        "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
    }


def _w8a16_check_strided(M, K, N, gen):
    """One product on strided views, held to the plain version: q columns
    [0, N) of layer 1 of a stacked [2, K, N + 48] weight, x columns [0, K)
    of [M, K + 64]."""
    from gpustack_tpu_torch.ops import w8a16

    xw = torch.randn(M, K + 64, generator=gen, device="cuda").bfloat16()
    qw = torch.randint(-127, 128, (2, K, N + 48), generator=gen,
                       device="cuda", dtype=torch.int8)
    s = ((0.5 + torch.rand(N, generator=gen, device="cuda"))
         * (3.0 / K ** 0.5 / 127.0)).bfloat16()
    x, q = xw[:, :K], qw[1][:, :N]
    out = w8a16.w8a16_matmul(x, q, s)
    torch.cuda.synchronize()
    max_err, row_rel = _check_w8a16(out, x, q, s)
    return {"shape": {"M": M, "K": K, "N": N}, "ldx": xw.stride(0),
            "ldq": q.stride(0), "max_abs_err": max_err,
            "max_row_rel_err": row_rel}


KERNEL_META = {
    "flash_attention_prefill": {
        "route": "cuda",
        "source": "gpustack_tpu_torch/ops/csrc/flash_attention.cu",
        "replaces": "gpustack_tpu/ops/flash_attention.py:39",
    },
    # no Pallas kernel behind it: the int8 branch of the JAX _mm, an XLA
    # fusion
    "w8a16_matmul": {
        "route": "cuda",
        "source": "gpustack_tpu_torch/ops/csrc/w8a16_gemm.cu",
        "replaces": "gpustack_tpu/models/transformer.py:46",
    },
}


def _wrappers():
    from gpustack_tpu_torch.ops.flash_attention import flash_attention_prefill
    from gpustack_tpu_torch.ops.w8a16 import w8a16_matmul

    return {
        "flash_attention_prefill": flash_attention_prefill,
        "w8a16_matmul": w8a16_matmul,
    }


def launch_counts():
    """Each wrapper's launches, and the W8A16 wrapper's per path."""
    counts = {name: fn.launches for name, fn in _wrappers().items()}
    by_path = _wrappers()["w8a16_matmul"].launches_by_path
    counts.update({f"w8a16_{path}": n for path, n in by_path.items()})
    return counts


def reset_launch_counts():
    for fn in _wrappers().values():
        fn.launches = 0
    by_path = _wrappers()["w8a16_matmul"].launches_by_path
    by_path.update(dict.fromkeys(by_path, 0))


class RunnerCalls:
    """The model forwards a runner runs from here on (instance attributes
    over the methods the engine calls), each as (method, B, T): the rows
    its weight products see are M = B·T."""

    METHODS = ("prefill", "prefill_with_prefix", "decode_step",
               "verify_step", "ingest_step", "embed")

    def __init__(self, runner, int8):
        self.runner, self.int8 = runner, int8
        self.forwards = []
        for name in self.METHODS:
            fn = getattr(runner, name)

            def counted(*args, _fn=fn, _name=name, **kw):
                self.forwards.append((_name, *self._shape(_name, args)))
                return _fn(*args, **kw)

            setattr(runner, name, counted)

    def _shape(self, name, args):
        slots = self.runner.max_slots
        if name == "prefill":
            return 1, len(args[0])
        if name == "prefill_with_prefix":
            return 1, len(args[3])
        if name == "decode_step":
            return slots, 1
        if name in ("verify_step", "ingest_step"):
            return slots, len(args[1][0])
        rows = 1                                    # embed: batch padded
        while rows < len(args[0]):
            rows *= 2
        return rows, len(args[0][0])

    def reset(self):
        self.forwards.clear()

    def counts(self):
        return {name: sum(f[0] == name for f in self.forwards)
                for name in self.METHODS}


def expected_launches(runner_calls):
    """What windows of runner forwards must launch, each
    :class:`RunnerCalls` with its own model: the flash kernel once per
    layer of every prefill forward (bucketed or continuation) and every
    embedding forward where the model's config takes it
    (``flash_eligible``: no sliding window, softcap or sinks, the JAX
    ``forward``'s own condition), else never; with int8 weights the W8A16
    kernel seven times per layer (q, k, v, o, gate, up, down) at M = B·T,
    plus an untied lm_head at the rows it reads (a prefill's last
    position, a decode step's slots, all of a verify block's positions;
    an embedding forward and a draft's ingest read none; a tied lm_head
    is the bf16 embedding's transpose), and never without. Each product
    of M ≤ 16 rows takes the GEMV, any larger one the ``wgmma`` path."""
    from gpustack_tpu_torch.models.transformer import flash_eligible
    from gpustack_tpu_torch.ops.w8a16 import GEMV_MAX_M

    want = {"flash_attention_prefill": 0, "w8a16_matmul": 0,
            "w8a16_gemv": 0, "w8a16_wgmma": 0}
    for calls in runner_calls:
        cfg = calls.runner.cfg
        layers, flash = cfg.num_layers, flash_eligible(cfg)
        for name, B, T in calls.forwards:
            if flash and name in ("prefill", "prefill_with_prefix", "embed"):
                want["flash_attention_prefill"] += layers
            if not calls.int8:
                continue
            head = None if cfg.tie_word_embeddings else {
                "prefill": 1, "prefill_with_prefix": 1,
                "decode_step": B, "verify_step": B * T,
            }.get(name)
            for m, n in ((B * T, 7 * layers), (head, 1)):
                if m is None:
                    continue
                path = "gemv" if m <= GEMV_MAX_M else "wgmma"
                want[f"w8a16_{path}"] += n
                want["w8a16_matmul"] += n
    return want


def check_launches(path, counts, want):
    if counts != want:
        raise AssertionError(
            f"{path}: kernel launches {counts}, the path needs {want}"
        )


# ---------------------------------------------------------------------------
# d: the main path through the API server
# ---------------------------------------------------------------------------


def _post(port, path, body, timeout=600):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        if resp.status != 200:
            raise AssertionError(f"{path}: HTTP {resp.status}")
        return resp.headers.get("Content-Type", ""), resp.read().decode()


def _check_usage(data, prompt_tokens=None):
    usage = data["usage"]
    if usage["completion_tokens"] < 1:
        raise AssertionError(f"no completion tokens: {usage}")
    if prompt_tokens is not None and usage["prompt_tokens"] != prompt_tokens:
        raise AssertionError(f"prompt_tokens {usage} != {prompt_tokens}")
    return usage


class _RoutingTape:
    """Inside ``with``, ``transformer.moe_route`` records the experts each
    MoE call picks (``mode = "record"``) or replays the recorded picks
    (``"replay"``): row by row in order, so a replaying forward over the
    same tokens may run other token chunks (an fp32 forward's are half a
    bf16 one's). The combine weights are recomputed from the call's own
    router logits over those picks (softmax scoring then
    ``norm_topk_prob``, or GPT-OSS's ``softmax_topk``: the affine logits'
    softmax over the picks): the forward's one discrete step held fixed,
    and each call's count of tokens whose own picks would differ kept.
    Any other mode routes freely."""

    def __init__(self):
        self.picks, self.flips, self.mode, self.at = [], [], "record", 0

    def __enter__(self):
        from gpustack_tpu_torch.models import transformer as tf

        self._route = tf.moe_route

        def route(x, router_w, cfg, router_bias=None):
            idx, combine = self._route(x, router_w, cfg, router_bias)
            if self.mode != "replay":
                if self.mode == "record":
                    self.picks.append(idx)
                return idx, combine
            if cfg.moe_scoring not in ("softmax", "softmax_topk"):
                raise ValueError(f"the tape cannot replay {cfg.moe_scoring}")
            if self.at == 0:
                self.picks = [torch.cat(self.picks)]
            want = self.picks[0][self.at:self.at + len(idx)]
            self.at += len(idx)
            self.flips.append(int(
                (idx.sort(-1).values != want.sort(-1).values).any(-1).sum()
            ))
            logits = x.float() @ router_w.float()
            if cfg.moe_scoring == "softmax_topk":
                if router_bias is not None:
                    logits = logits + router_bias.float()
                top_w = torch.softmax(torch.gather(logits, -1, want), -1)
            else:
                gates = torch.softmax(logits, dim=-1)
                top_w = torch.gather(gates, -1, want)
                if cfg.norm_topk_prob:
                    top_w = top_w / top_w.sum(dim=-1, keepdim=True)
            return want, torch.zeros_like(logits).scatter_(-1, want, top_w)

        tf.moe_route = route
        return self

    def __exit__(self, *exc):
        from gpustack_tpu_torch.models import transformer as tf

        tf.moe_route = self._route


class _Widened:
    """A stacked leaf read a layer at a time in fp32 (``lp[key][i]``): an
    fp32 forward over a bf16 tree without an fp32 copy of the tree
    (gpt-oss-20b's would take 84 GB)."""

    def __init__(self, t):
        self.t = t

    @property
    def shape(self):
        return self.t.shape

    def __getitem__(self, i):
        return self.t[i].float()


def _fp32_model(runner):
    """(params, cfg) of the fp32 plain reference over ``runner``'s bf16
    weights: every layer leaf widened as it is read; the embedding, the
    final norm and ``lm_head`` promote in ``_embed_lookup``, ``rms_norm``
    and ``_mm``."""
    params = dict(runner.params)
    for key in ("layers", "dense_layers"):
        if key in params:
            params[key] = {k: _Widened(t) for k, t in params[key].items()}
    return params, dataclasses.replace(runner.cfg, dtype="float32")


def _compare_logits(got, want):
    return {
        "max_abs_err": (got - want).abs().max().item(),
        "logit_scale": want.abs().max().item(),
        "cosine": torch.nn.functional.cosine_similarity(
            got, want, dim=0
        ).item(),
    }


def _logit_check(engine):
    """A served prefill's last-position logits against a reference run of
    the same prompt (outside the counted window). Where the config takes
    the flash kernel, the reference is the same bf16 forward through the
    plain attention; where it does not (sliding windows, softcaps, sinks:
    the plain attention is itself the served path, as in JAX), it is the
    fp32 plain forward over the same weights (:func:`_fp32_model`). For an
    MoE model the reference replays the served run's expert picks: on
    random weights a top-k router flips the picks of tokens near a tie on
    any rounding change, and many layers compound the flips, so replaying
    them leaves the attention (or the rounding) as the only difference
    between the runs. The free-routing comparison and its flips are
    reported beside it."""
    from gpustack_tpu_torch.models import transformer as tf

    runner = engine.runner
    cfg = runner.cfg
    flash = tf.flash_eligible(cfg)
    params, ref_cfg = (
        (runner.params, cfg) if flash else _fp32_model(runner)
    )
    prompt = engine.tokenizer.encode("The port's logit check. " * 40)
    bucket = runner.bucket_for(len(prompt))
    padded = prompt + [0] * (bucket - len(prompt))

    def plain_last():
        tokens = torch.tensor([padded], device=runner.device)
        positions = torch.arange(bucket, device=runner.device)[None, :]
        cache = tf.KVCache.create(ref_cfg, 1, bucket, runner.device)
        hidden, _ = tf.forward(
            params, ref_cfg, tokens, positions, cache,
            return_hidden=True, attn_impl="plain",
        )
        return tf.lm_head(params, ref_cfg, hidden[0, len(prompt) - 1])

    moe = {}
    with torch.no_grad(), _RoutingTape() as tape:
        served_last, _, _ = runner.prefill(padded, len(prompt))
        tape.mode = "replay"
        plain = plain_last()
        if tape.picks:
            tape.mode = "free"
            moe = {
                "routing": "the served run's expert picks replayed",
                "free_routing": {
                    **_compare_logits(served_last, plain_last()),
                    "tokens_with_a_flipped_pick_per_layer": tape.flips,
                },
            }
    if served_last.shape != (cfg.vocab_size,) or not torch.isfinite(
        served_last
    ).all():
        raise AssertionError(f"bad logits {tuple(served_last.shape)}")
    gate = _compare_logits(served_last, plain)
    emit("logit_check", model=cfg.name, prompt_tokens=len(prompt),
         bucket=bucket,
         served="flash kernel" if flash else "plain attention, bf16",
         reference=("plain attention, bf16" if flash
                    else "fp32 plain forward"),
         **gate, **moe,
         tolerance={"rel": LOGIT_REL_TOL, "min_cosine": LOGIT_MIN_COSINE})
    if gate["max_abs_err"] > LOGIT_REL_TOL * gate["logit_scale"] or (
        gate["cosine"] < LOGIT_MIN_COSINE
    ):
        raise AssertionError(f"served prefill logits differ: {gate}")
    return gate["logit_scale"]


def _prefill_ms(engine, reps: int = 5) -> float:
    """One 2048-bucket prefill through the runner, CUDA events around it:
    the median of ``reps`` after a warm-up. It launches the kernels, so it
    runs outside the counted window."""
    runner = engine.runner
    ids = engine.tokenizer.encode("x" * 1500)
    padded = ids + [0] * (runner.bucket_for(len(ids)) - len(ids))
    times = []
    with torch.no_grad():
        for i in range(reps + 1):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            runner.prefill(padded, len(ids))
            end.record()
            torch.cuda.synchronize()
            if i:
                times.append(start.elapsed_time(end))
    return statistics.median(times)


def _prefill_split(engine):
    """One 2048-bucket prefill (after ``_prefill_ms``'s warm-up, outside
    the counted windows) with CUDA events around it and around each plain
    attention (``_attend``) and MoE block (``_moe_mlp``) call in it: the
    stream time each takes of the whole."""
    from gpustack_tpu_torch.models import transformer as tf

    runner = engine.runner
    ids = engine.tokenizer.encode("x" * 1500)
    padded = ids + [0] * (runner.bucket_for(len(ids)) - len(ids))
    spans = {"attend": [], "moe_mlp": []}

    def timed(name, fn):
        def call(*args, **kw):
            pair = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            pair[0].record()
            out = fn(*args, **kw)
            pair[1].record()
            spans[name].append(pair)
            return out
        return call

    attend, moe_mlp = tf._attend, tf._moe_mlp
    tf._attend, tf._moe_mlp = timed("attend", attend), timed("moe_mlp", moe_mlp)
    try:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.no_grad():
            start.record()
            runner.prefill(padded, len(ids))
            end.record()
        torch.cuda.synchronize()
    finally:
        tf._attend, tf._moe_mlp = attend, moe_mlp
    split = {"prefill_ms": start.elapsed_time(end)}
    for name, pairs in spans.items():
        split[f"{name}_calls"] = len(pairs)
        split[f"{name}_ms"] = sum(a.elapsed_time(b) for a, b in pairs)
    return split


def _engine_metrics(engine):
    """TTFT of one 2048-bucket prompt on an idle engine, and decode
    tokens/s with all 8 slots busy (host clock around device work)."""
    from gpustack_tpu_torch.engine.engine import GenRequest

    long_prompt = engine.tokenizer.encode("x" * 1500)
    ttft_ms = engine.generate(
        GenRequest(prompt_ids=long_prompt, max_tokens=2, temperature=0.0),
        timeout=600,
    ).ttft_ms
    reqs = [
        engine.submit(GenRequest(
            prompt_ids=engine.tokenizer.encode(f"slot {i} says"),
            max_tokens=64, temperature=0.0,
        ))
        for i in range(engine.max_slots)
    ]
    for r in reqs:
        if not r.done.wait(600):
            raise AssertionError("decode-rate request timed out")
    t_first = max(r.first_token_at for r in reqs)
    t_end = max(r.finished_at for r in reqs)
    after_first = sum(len(r.output_ids) - 1 for r in reqs)
    return {
        "ttft_ms_2048_bucket": ttft_ms,
        "decode_tokens_per_s_8_slots": after_first / max(t_end - t_first, 1e-9),
        "prefills": 1 + len(reqs),
    }


def _serve_script(engine, port):
    """The main path's requests through the server: chat, streaming chat,
    a completion filling the 2048 bucket, four concurrent chats, and a
    repeated greedy prompt; then TTFT and decode tokens/s. Returns the
    request-derived prefill count, usages, greedy ids and metrics."""
    from gpustack_tpu_torch.engine.engine import GenRequest

    prefills = 0
    tok = engine.tokenizer

    msgs = [{"role": "user", "content": "Say hello to the H100."}]
    chat_prompt = len(tok.apply_chat_template(msgs))
    _, raw = _post(port, "/v1/chat/completions", {
        "messages": msgs, "max_tokens": 16, "temperature": 0,
    })
    prefills += 1
    chat = json.loads(raw)
    chat_usage = _check_usage(chat, chat_prompt)

    ctype, raw = _post(port, "/v1/chat/completions", {
        "messages": msgs, "max_tokens": 16, "temperature": 0,
        "stream": True,
    })
    prefills += 1
    events = [
        line[6:] for line in raw.split("\n") if line.startswith("data: ")
    ]
    if "text/event-stream" not in ctype or events[-1] != "[DONE]":
        raise AssertionError(f"bad stream: {ctype} {events[-1:]}")
    stream_usage = _check_usage(json.loads(events[-2]), chat_prompt)

    long_text = "The quick brown fox jumps over the lazy dog. " * 34
    long_ids = tok.encode(long_text)
    if not 1024 < len(long_ids) < 2048:
        raise AssertionError(f"long prompt is {len(long_ids)} tokens")
    _, raw = _post(port, "/v1/completions", {
        "prompt": long_text, "max_tokens": 8, "temperature": 0,
        "logprobs": 1,
    })
    prefills += 1
    long_data = json.loads(raw)
    long_usage = _check_usage(long_data, len(long_ids))

    results = [None] * 4

    def worker(i):
        _, body = _post(port, "/v1/chat/completions", {
            "messages": [{"role": "user", "content": f"request {i}"}],
            "max_tokens": 24, "temperature": 0.8, "seed": i,
        })
        results[i] = json.loads(body)

    threads = [
        threading.Thread(target=worker, args=(i,)) for i in range(4)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if any(t.is_alive() for t in threads) or None in results:
        raise AssertionError("a concurrent request did not finish")
    prefills += 4
    for r in results:
        _check_usage(r)

    # repeated greedy prompt: identical token ids and logprobs
    _, raw = _post(port, "/v1/completions", {
        "prompt": long_text, "max_tokens": 8, "temperature": 0,
        "logprobs": 1,
    })
    prefills += 1
    again = json.loads(raw)
    if again["choices"][0]["logprobs"]["token_logprobs"] != (
        long_data["choices"][0]["logprobs"]["token_logprobs"]
    ):
        raise AssertionError("repeated greedy prompt diverged")
    first = engine.generate(GenRequest(
        prompt_ids=long_ids, max_tokens=8, temperature=0.0), timeout=600)
    second = engine.generate(GenRequest(
        prompt_ids=long_ids, max_tokens=8, temperature=0.0), timeout=600)
    prefills += 2
    if first.output_ids != second.output_ids or not first.output_ids:
        raise AssertionError(
            f"greedy ids differ: {first.output_ids} {second.output_ids}"
        )

    metrics = _engine_metrics(engine)
    prefills += metrics.pop("prefills")
    return {
        "prefills": prefills,
        "usage": {"chat": chat_usage, "stream": stream_usage,
                  "long_completion": long_usage},
        "greedy_ids": first.output_ids, **metrics,
    }


def _serve_counted(engine, logit_check, int8, profile="", embed=False):
    """Start ``engine`` behind the server, run ``logit_check`` outside the
    counted window, then the main path's requests with every kernel's
    launches counted and checked against what the runner's forwards need;
    with a ``profile`` label, then a counted window of :func:`_profile`;
    with ``embed``, a counted window of the embedding requests
    (:func:`_embed_checks`) and their reference. Returns
    (report, {window: counts})."""
    from gpustack_tpu_torch.engine.api_server import OpenAIServer

    calls = RunnerCalls(engine.runner, int8)
    engine.start()
    server = OpenAIServer(engine)
    port = server.start("127.0.0.1", 0)
    try:
        logit_check(engine)
        reset_launch_counts()
        calls.reset()
        report = _serve_script(engine, port)
        counts = launch_counts()
        window = calls.counts()
        health = engine.health()
        if health["status"] != "ok":
            raise AssertionError(f"engine unhealthy: {health}")
        if window["prefill"] != report["prefills"] or window[
            "prefill_with_prefix"
        ]:
            raise AssertionError(
                f"runner calls {window} for {report['prefills']} prompts"
            )
        want = expected_launches([calls])
        check_launches("int8 path" if int8 else "main path", counts, want)
        report["runner_calls"] = window
        report["prefill_ms_2048_bucket"] = _prefill_ms(engine)
        windows = {"served": counts}
        if embed:
            with _RoutingTape() as tape:     # the served batch's picks
                windows["embed"], (vecs, report["embeddings"]) = _window(
                    "embeddings", [calls], lambda: _embed_checks(engine, port)
                )
            report["embeddings"].update(_embed_reference(engine, vecs, tape))
        if profile:
            windows["profile"], report["profile"] = _window(
                f"{profile} profile", [calls],
                lambda: _profile(port, profile),
            )
        return report, windows
    finally:
        server.shutdown()
        engine.stop()


MAIN_ARGV = [
    "--preset", "llama3-8b", "--max-slots", "8", "--max-seq-len", "2048",
    "--host", "127.0.0.1", "--port", "0",
]


def phase_main_path(kind, smi):
    from gpustack_tpu_torch.engine.api_server import (
        build_engine_from_args,
        build_parser,
    )

    args = build_parser().parse_args(MAIN_ARGV)
    t0 = time.perf_counter()
    engine = build_engine_from_args(args)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    report, windows = _serve_counted(engine, _logit_check, int8=False)
    counts = windows["served"]
    emit("main_path", model=engine.cfg.name, device=kind, nvidia_smi=smi,
         setup_s=setup_s, launches=counts, **report,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return counts, report


# ---------------------------------------------------------------------------
# e: prefix reuse and chunked prefill
# ---------------------------------------------------------------------------

E_ARGV = MAIN_ARGV + ["--prefill-chunk", "512", "--host-kv-cache-mb", "4096"]
CHUNK = 512
BLOCK = 256            # the host cache's default block
# lowercase letters (byte tokenizer: byte b is id b + 1): a reply biased to
# them is text that tokenizes back to the ids generated, as a real
# model's reply does, so turn 2's prompt holds turn 1's generated tokens
LETTERS = {str(ord(c) + 1): 100.0 for c in "abcdefghijklmnopqrstuvwxyz"}
_SAMPLE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? (\S+)$"
)


def parse_prometheus(text):
    """Strict enough for the exporter: every sample's family declared by a
    ``# TYPE`` line first, numeric values, histogram buckets cumulative
    with ``+Inf`` equal to ``_count``. Returns ({(name, labels): value},
    {family: kind})."""
    types, samples = {}, {}
    for n, line in enumerate(text.splitlines(), 1):
        if line.startswith("# TYPE "):
            _, _, family, kind = line.split(" ")
            if family in types:
                raise AssertionError(f"line {n}: {family} declared twice")
            types[family] = kind
            continue
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE.match(line)
        if not m:
            raise AssertionError(f"line {n} is not a sample: {line!r}")
        name, labels, value = m.group(1), m.group(2) or "", float(m.group(3))
        family = re.sub(r"_(bucket|sum|count)$", "", name)
        if name not in types and types.get(family) != "histogram":
            raise AssertionError(f"line {n}: {name} has no # TYPE")
        samples[(name, labels)] = value
    for family, kind in types.items():
        if kind != "histogram":
            continue
        series = {}
        for (name, labels), value in samples.items():
            if name == f"{family}_bucket":
                rest = re.sub(r',?le="[^"]*"', "", labels)
                le = re.search(r'le="([^"]*)"', labels).group(1)
                series.setdefault(rest, []).append(
                    (float("inf") if le == "+Inf" else float(le), value)
                )
        for rest, buckets in series.items():
            counts = [c for _, c in sorted(buckets)]
            count = samples[(f"{family}_count", "" if rest == "{}" else rest)]
            if counts != sorted(counts) or counts[-1] != count:
                raise AssertionError(f"{family}{rest}: bad buckets")
    return samples, types


def _get(port, path):
    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}{path}", timeout=60
    ) as resp:
        return resp.read().decode()


def _stream_chat(port, messages, max_tokens, arrivals=None, started=None):
    """A streaming chat; returns (reply text, TTFT s). ``arrivals`` collects
    the host time of every content chunk; ``started`` is set at the
    first one."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/chat/completions",
        data=json.dumps({
            "messages": messages, "max_tokens": max_tokens,
            "temperature": 0, "stream": True, "logit_bias": LETTERS,
        }).encode(),
        headers={"Content-Type": "application/json"},
    )
    t0 = time.perf_counter()
    ttft, text = None, []
    with urllib.request.urlopen(req, timeout=600) as resp:
        for raw in resp:
            line = raw.decode().strip()
            if not line.startswith("data: ") or line == "data: [DONE]":
                continue
            piece = json.loads(line[6:])["choices"][0]["delta"].get(
                "content"
            )
            if piece:
                now = time.perf_counter()
                if ttft is None:
                    ttft = now - t0
                    if started is not None:
                        started.set()
                if arrivals is not None:
                    arrivals.append(now)
                text.append(piece)
    return "".join(text), ttft


def _forwards(n_tokens, matched):
    """Model forwards (each 32 flash launches) a prompt takes: one-shot
    (with or without a prefix) up to the chunk, else one per chunk of
    what the prefix left."""
    rest = n_tokens - matched
    return 1 if n_tokens <= CHUNK else -(-rest // CHUNK)


def _expected_match(prompt, stored):
    """Block-aligned tokens of ``prompt`` the cache can serve: its longest
    common prefix with any stored sequence, in whole blocks, leaving at
    least one token to prefill."""
    best = 0
    for seq in stored:
        n = 0
        while n < min(len(seq), len(prompt)) and seq[n] == prompt[n]:
            n += 1
        best = max(best, n // BLOCK * BLOCK)
    return min(best, (len(prompt) - 1) // BLOCK * BLOCK)


def _continuation_parity(engine):
    """Runner level, outside the counted window: a continuation's logits
    against one prefill of the same prompt (the flash kernel at
    ``q_offset`` > 0 against offset 0)."""
    runner = engine.runner
    rows = []

    def compare(name, got, want):
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        cos = torch.nn.functional.cosine_similarity(got, want, dim=0).item()
        rows.append({"case": name, "max_abs_err": err, "logit_scale": scale,
                     "cosine": cos})
        if (
            not torch.isfinite(got).all() or err > LOGIT_REL_TOL * scale
            or cos < LOGIT_MIN_COSINE
        ):
            raise AssertionError(
                f"{name}: continuation logits differ, max |err| {err} "
                f"(scale {scale}), cosine {cos}"
            )

    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        ids = torch.randint(1, 257, (1500,), generator=gen).tolist()
        full, k, v = runner.prefill(ids + [0] * (2048 - 1500), 1500)
        suffix = ids[1024:] + [0] * (512 - 476)
        got, _, _ = runner.prefill_with_prefix(
            k[:, :1024], v[:, :1024], 1024, suffix, 476, 2048
        )
        compare("prefix 1024 + suffix 476 (T 512, S 2048, offset 1024)",
                got, full)
        ids = torch.randint(1, 257, (1900,), generator=gen).tolist()
        full, _, _ = runner.prefill(ids + [0] * (2048 - 1900), 1900)
        last = k = v = None
        for start in range(0, 1900, CHUNK):
            part = ids[start:start + CHUNK]
            sb = runner.bucket_for(len(part))
            padded = part + [0] * (sb - len(part))
            if start == 0:
                last, k, v = runner.prefill(padded, len(part))
            else:
                last, k, v = runner.prefill_with_prefix(
                    k, v, start, padded, len(part),
                    runner.bucket_for(start + sb),
                )
        compare("four chunks of 512 (1900 tokens)", last, full)
        # device time of one 512-token forward by where it starts (CUDA
        # events, median of 3): a bucketed prefill, then continuations
        _, k, v = runner.prefill(ids[:2048] + [0] * 148, 1900)
        timing = {}
        for off in (0, 512, 1024, 1536):
            part = ids[off:off + CHUNK]
            runs = []
            for _ in range(4):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                if off == 0:
                    runner.prefill(part, CHUNK)
                else:
                    runner.prefill_with_prefix(
                        k[:, :off], v[:, :off], off,
                        part + [0] * (CHUNK - len(part)),
                        len(part), runner.bucket_for(off + CHUNK),
                    )
                end.record()
                torch.cuda.synchronize()
                runs.append(start.elapsed_time(end))
            timing[str(off)] = statistics.median(runs[1:])
    return rows, timing


def _kv_tier_times(engine):
    """Host KV tier costs, outside the counted window: gathering and
    uploading a 1280-token (5-block) prefix, and storing a 2048-token
    sequence device→host (host clock; each ends on a synchronize)."""
    cache = engine.host_kv_cache
    runner = engine.runner
    out = {"store_ms_2048_tokens": [], "store_blocks": [],
           "gather_ms_1280_tokens": [], "upload_ms_1280_tokens": []}
    # twice, on two sequences: the second call finds the caching host
    # allocator's pinned blocks already made
    for rep in range(2):
        ids = [1 + (i + 7 * rep) % 250 for i in range(2048)]
        with torch.no_grad():
            _, k, v = runner.prefill(ids, 2048)
        torch.cuda.synchronize()
        before = cache.entries
        t0 = time.perf_counter()
        engine._submit_kv_copy(ids, k, v, 2048)
        engine._kv_copy_pool.submit(lambda: None).result(timeout=120)
        out["store_ms_2048_tokens"].append((time.perf_counter() - t0) * 1e3)
        out["store_blocks"].append(cache.entries - before)
        t0 = time.perf_counter()
        pk, pv = cache.gather_prefix(ids, 1280)
        out["gather_ms_1280_tokens"].append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        engine._upload_prefix(pk, pv, 1280)
        out["upload_ms_1280_tokens"].append((time.perf_counter() - t0) * 1e3)
    out["block_mib"] = pk.nbytes * 2 / 5 / 2**20
    return out


def phase_prefix_reuse(kind, smi):
    """The engine with chunked prefill and the host KV cache, through the
    port's server: multi-turn chats that reuse their earlier turns'
    blocks, a long completion chunked while chats decode, exact hit and
    launch counts, and /metrics."""
    from gpustack_tpu_torch.engine.api_server import (
        OpenAIServer,
        build_engine_from_args,
        build_parser,
    )

    args = build_parser().parse_args(E_ARGV)
    engine = build_engine_from_args(args)
    # runner-level checks and KV tier timings before the scheduler starts
    parity, chunk_forward_ms = _continuation_parity(engine)
    kv_tier = _kv_tier_times(engine)
    engine.start()
    server = OpenAIServer(engine)
    port = server.start("127.0.0.1", 0)
    tok = engine.tokenizer

    def drain():
        engine._kv_copy_pool.submit(lambda: None).result(timeout=120)

    def health():
        return json.loads(_get(port, "/healthz"))

    try:
        reset_launch_counts()
        forwards = 0
        stored = []
        conversations = []
        for name, seed_text in (("a", "Tell me about the H100. "),
                                ("b", "Summarise this log line. ")):
            body = (seed_text * 60)[:1226]
            msgs = [{"role": "user", "content": body}]
            p1 = tok.apply_chat_template(msgs)
            h0 = health()
            reply, ttft_cold = _stream_chat(port, msgs, 48)
            out = tok.encode(reply)
            if len(out) != 48:
                raise AssertionError(f"turn 1 replied {len(out)} tokens")
            forwards += _forwards(len(p1), _expected_match(p1, stored))
            stored += [p1, p1 + out[:-1]]
            drain()
            msgs2 = msgs + [{"role": "assistant", "content": reply},
                            {"role": "user", "content": "Go on."}]
            p2 = tok.apply_chat_template(msgs2)
            want = _expected_match(p2, stored)
            h1 = health()
            _, ttft_warm = _stream_chat(port, msgs2, 16)
            h2 = health()
            forwards += _forwards(len(p2), want)
            stored.append(p2)      # its prefill store; reply under a block
            drain()
            hits = h2["kv_cache_prefix_hits"] - h1["kv_cache_prefix_hits"]
            reused = (h2["kv_cache_prefix_tokens_reused"]
                      - h1["kv_cache_prefix_tokens_reused"])
            if want <= len(p1) or hits != 1 or reused != want:
                raise AssertionError(
                    f"conversation {name}: turn 2 ({len(p2)} tokens) reused "
                    f"{reused} tokens in {hits} hits, want {want} in 1"
                )
            if h1["kv_cache_prefix_hits"] != h0["kv_cache_prefix_hits"]:
                raise AssertionError(f"conversation {name}: turn 1 hit")
            conversations.append({
                "turn1_tokens": len(p1), "turn2_tokens": len(p2),
                "reused_tokens": reused, "ttft_ms_cold": ttft_cold * 1e3,
                "ttft_ms_warm": ttft_warm * 1e3,
            })

        # one 1900-token completion while 4 chats decode
        arrivals = [[] for _ in range(4)]
        started = [threading.Event() for _ in range(4)]
        chats = [
            threading.Thread(target=_stream_chat, args=(
                port, [{"role": "user", "content": f"chat {i} " * 4}], 200,
                arrivals[i], started[i],
            ))
            for i in range(4)
        ]
        for t in chats:
            t.start()
        for e in started:
            if not e.wait(120):
                raise AssertionError("a chat never streamed")
        for i in range(4):
            forwards += _forwards(
                len(tok.apply_chat_template(
                    [{"role": "user", "content": f"chat {i} " * 4}]
                )), 0,
            )
        long_text = "".join(
            chr(ord("a") + (i * 7) % 26) for i in range(1900)
        )
        t_submit = time.time()
        p0 = time.perf_counter()
        _, raw = _post(port, "/v1/completions", {
            "prompt": long_text, "max_tokens": 8, "temperature": 0,
        })
        p1_ = time.perf_counter()
        _check_usage(json.loads(raw), 1900)
        forwards += _forwards(1900, 0)
        for t in chats:
            t.join(timeout=600)
        if any(t.is_alive() for t in chats):
            raise AssertionError("a chat did not finish")
        records = json.loads(_get(port, "/debug/flight?limit=2048"))[
            "records"
        ]
        chunks = [
            r for r in records
            if r["ts"] >= t_submit and r["mode"] == "prefill_chunk"
        ]
        if len(chunks) != 4 or sum(r["prompt_tokens"] for r in chunks) != 1900:
            raise AssertionError(
                f"1900-token completion ran as {len(chunks)} chunk steps "
                f"({[r['prompt_tokens'] for r in chunks]})"
            )
        gaps = [
            max((b - a for a, b in zip(ts, ts[1:]) if p0 <= b <= p1_),
                default=0.0)
            for ts in arrivals
        ]
        counts = launch_counts()
        check_launches("prefix reuse", counts, {
            "flash_attention_prefill": engine.cfg.num_layers * forwards,
            "w8a16_matmul": 0, "w8a16_gemv": 0, "w8a16_wgmma": 0,
        })
        samples, types = parse_prometheus(_get(port, "/metrics"))
        h = health()
        if h["status"] != "ok":
            raise AssertionError(f"engine unhealthy: {h}")
        if samples[("gpustack_kv_cache_hits", "")] != h["kv_cache_hits"]:
            raise AssertionError("/metrics kv hits disagree with /healthz")
        emit("prefix_reuse", model=engine.cfg.name, device=kind,
             nvidia_smi=smi, continuation_parity=parity,
             forward_ms_512_tokens_by_offset=chunk_forward_ms,
             conversations=conversations,
             long_prompt={
                 "tokens": 1900, "chunk_steps": len(chunks),
                 "chunk_step_ms": [r["dur_ms"] for r in chunks],
                 "e2e_ms": (p1_ - p0) * 1e3,
                 "max_inter_token_gap_ms_of_running_chats": [
                     g * 1e3 for g in gaps
                 ],
             },
             forwards=forwards, launches=counts, kv_tier=kv_tier,
             kv_cache={k: h[k] for k in (
                 "kv_cache_hits", "kv_cache_misses", "kv_cache_prefix_hits",
                 "kv_cache_prefix_tokens_reused", "kv_cache_blocks",
                 "kv_cache_host_bytes",
             )},
             metrics_families=len(types),
             flight_overhead_ratio=h["flight_overhead_ratio"],
             peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        return counts
    finally:
        server.shutdown()
        engine.stop()


# ---------------------------------------------------------------------------
# f: checkpoints and int8
# ---------------------------------------------------------------------------


def _hf_named(tree, cfg, mxfp4=None):
    """The param tree under HF names (llama; Qwen3-MoE with ``qk_norm`` and
    per-expert tensors; DeepSeek-V2 with MLA, its shared experts and the
    ``dense_layers`` stack first; GPT-OSS with its biases, fp32 sinks and
    router bias and fused experts, gate and up interleaved; Gemma2's
    sandwich norms), linear weights as [out, in]; a tied tree carries no
    ``lm_head.weight``. ``mxfp4`` maps a GPT-OSS expert tensor's name to
    its MXFP4 (blocks, scales), written in its place."""
    out = {
        "model.embed_tokens.weight": tree["embed"],
        "model.norm.weight": tree["final_norm"],
    }
    if "lm_head" in tree:
        out["lm_head.weight"] = tree["lm_head"].T
    attn = "self_attn."
    names = {
        "attn_norm": ("input_layernorm.weight", False),
        "wq": (attn + "q_proj.weight", True),
        "wk": (attn + "k_proj.weight", True),
        "wv": (attn + "v_proj.weight", True),
        "wo": (attn + "o_proj.weight", True),
        "bq": (attn + "q_proj.bias", False),
        "bk": (attn + "k_proj.bias", False),
        "bv": (attn + "v_proj.bias", False),
        "bo": (attn + "o_proj.bias", False),
        "sinks": (attn + "sinks", False),
        "mlp_norm": ("post_attention_layernorm.weight", False),
        "q_norm": (attn + "q_norm.weight", False),
        "k_norm": (attn + "k_norm.weight", False),
        "wq_a": (attn + "q_a_proj.weight", True),
        "q_a_norm": (attn + "q_a_layernorm.weight", False),
        "wq_b": (attn + "q_b_proj.weight", True),
        "wkv_a": (attn + "kv_a_proj_with_mqa.weight", True),
        "kv_a_norm": (attn + "kv_a_layernorm.weight", False),
        "wkv_b": (attn + "kv_b_proj.weight", True),
        "w_gate": ("mlp.gate_proj.weight", True),
        "w_up": ("mlp.up_proj.weight", True),
        "w_down": ("mlp.down_proj.weight", True),
        "router": ("mlp.gate.weight", True),
        "ws_gate": ("mlp.shared_experts.gate_proj.weight", True),
        "ws_up": ("mlp.shared_experts.up_proj.weight", True),
        "ws_down": ("mlp.shared_experts.down_proj.weight", True),
    }
    if cfg.post_norms:
        names.update({
            "post_attn_norm": ("post_attention_layernorm.weight", False),
            "mlp_norm": ("pre_feedforward_layernorm.weight", False),
            "post_mlp_norm": ("post_feedforward_layernorm.weight", False),
        })
    gptoss = cfg.moe_act == "gptoss"
    if gptoss:
        names.update({"router": ("mlp.router.weight", True),
                      "router_bias": ("mlp.router.bias", False)})
    experts = {"we_gate": "gate_proj", "we_up": "up_proj",
               "we_down": "down_proj"}
    stacks = [tree[k] for k in ("dense_layers", "layers") if k in tree]
    blocks = [(lp, j) for lp in stacks for j in range(len(lp["attn_norm"]))]
    for i, (lp, j) in enumerate(blocks):
        for key, (hf, transpose) in names.items():
            if key in lp:
                t = lp[key][j]
                out[f"model.layers.{i}.{hf}"] = t.T if transpose else t
        if gptoss:
            fused = {
                "gate_up_proj": _interleave(lp["we_gate"][j], lp["we_up"][j]),
                "gate_up_proj_bias": _interleave(lp["we_gate_b"][j],
                                                 lp["we_up_b"][j]),
                "down_proj": lp["we_down"][j],
                "down_proj_bias": lp["we_down_b"][j],
            }
            for hf, t in fused.items():
                name = f"model.layers.{i}.mlp.experts.{hf}"
                if name in (mxfp4 or {}):
                    out[name + "_blocks"], out[name + "_scales"] = mxfp4[name]
                else:
                    out[name] = t
            continue
        for key, hf in experts.items():
            for e in range(cfg.num_experts if key in lp else 0):
                out[f"model.layers.{i}.mlp.experts.{e}.{hf}.weight"] = (
                    lp[key][j, e].T
                )
    return out


def _interleave(gate, up):
    """GPT-OSS's fused layout: gate and up alternating on the last axis."""
    return torch.stack([gate, up], dim=-1).flatten(-2)


# MXFP4's e2m1 magnitudes
FP4_STEPS = (0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0)


def _pack_mxfp4(w):
    """An expert weight ``[E, in, out]`` as the GPT-OSS hub checkpoints
    pack it: ``blocks`` uint8 ``[E, out, in/32, 16]`` (two e2m1 nibbles a
    byte, the low one the even element; sign bit high) and e8m0
    ``scales`` uint8 ``[E, out, in/32]`` (biased by 127), each 32-value
    block scaled by the power of two that puts its largest magnitude at
    or under 6. Also returns the weight the packing stands for, each
    value rounded to its nearest step (the lower one on a tie), bf16
    ``[E, in, out]``: computed here, independently of the loader's
    decoding. One expert at a time."""
    steps = torch.tensor(FP4_STEPS, device=w.device)
    mids = (steps[1:] + steps[:-1]) / 2
    blocks, scales, rounded = [], [], []
    for we in w:
        g = we.T.float().reshape(we.shape[1], -1, 32)        # [out, G, 32]
        exp = torch.ceil(torch.log2(
            (g.abs().amax(-1, keepdim=True) / 6.0).clamp_min(1e-30)
        )).clamp(-127, 127)
        e = (exp + 127).to(torch.int32)
        # 2^exp from its exponent bits (exact on any device; e = 0 is the
        # subnormal 2^-127)
        pow2 = torch.where(e > 0, e << 23, torch.full_like(e, 1 << 22)).view(
            torch.float32
        )
        scaled = g / pow2
        idx = torch.bucketize(scaled.abs(), mids)
        neg = scaled < 0
        nib = (idx | (neg.long() << 3)).to(torch.uint8)
        blocks.append(nib[..., 0::2] | (nib[..., 1::2] << 4))
        scales.append(e[..., 0].to(torch.uint8))
        value = torch.where(neg, -steps[idx], steps[idx]) * pow2
        rounded.append(value.reshape(we.shape[1], -1).T.to(torch.bfloat16))
    return torch.stack(blocks), torch.stack(scales), torch.stack(rounded)


def _mxfp4_experts(tree):
    """Pack every GPT-OSS expert weight of ``tree`` as MXFP4 and put the
    rounded weights in the tree in place of the originals: returns {HF
    tensor name: (blocks, scales)}."""
    lp, packed = tree["layers"], {}
    for j in range(len(lp["attn_norm"])):
        name = f"model.layers.{j}.mlp.experts."
        blocks, scales, gu = _pack_mxfp4(
            _interleave(lp["we_gate"][j], lp["we_up"][j])
        )
        packed[name + "gate_up_proj"] = (blocks, scales)
        lp["we_gate"][j].copy_(gu[..., 0::2])
        lp["we_up"][j].copy_(gu[..., 1::2])
        blocks, scales, down = _pack_mxfp4(lp["we_down"][j])
        packed[name + "down_proj"] = (blocks, scales)
        lp["we_down"][j].copy_(down)
    return packed


def _hf_config(cfg):
    """``config.json`` for ``cfg``: LlamaForCausalLM, DeepseekV2ForCausalLM
    for MLA, GptOssForCausalLM for GPT-OSS, Qwen3MoeForCausalLM for the
    other MoE models, or Gemma2ForCausalLM for the sandwich norms."""
    hf = {
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
    layer_types = [
        "sliding_attention" if s else "full_attention"
        for s in cfg.layer_sliding or ()
    ]
    if cfg.is_mla:
        del hf["head_dim"]                  # qk_nope + qk_rope
        hf.update({
            "architectures": ["DeepseekV2ForCausalLM"],
            "model_type": "deepseek_v2",
            "rope_scaling": cfg.rope_scaling,
            "q_lora_rank": cfg.q_lora_rank or None,
            "kv_lora_rank": cfg.kv_lora_rank,
            "qk_nope_head_dim": cfg.qk_nope_head_dim,
            "qk_rope_head_dim": cfg.qk_rope_head_dim,
            "v_head_dim": cfg.v_head_dim,
            "n_routed_experts": cfg.num_experts,
            "n_shared_experts": cfg.n_shared_experts,
            "num_experts_per_tok": cfg.num_experts_per_tok,
            "moe_intermediate_size": cfg.moe_intermediate_size,
            "first_k_dense_replace": cfg.first_k_dense,
            "moe_layer_freq": 1,
            "norm_topk_prob": cfg.norm_topk_prob,
            "routed_scaling_factor": cfg.routed_scaling_factor,
            "scoring_func": "softmax",
            "topk_method": "greedy",
            "n_group": 1,
            "topk_group": 1,
        })
    elif cfg.moe_act == "gptoss":
        hf.update({
            "architectures": ["GptOssForCausalLM"],
            "model_type": "gpt_oss",
            "intermediate_size": cfg.moe_intermediate_size,
            "num_local_experts": cfg.num_experts,
            "num_experts_per_tok": cfg.num_experts_per_tok,
            "rope_scaling": cfg.rope_scaling,
            "sliding_window": cfg.sliding_window,
            "layer_types": layer_types,
            "attention_bias": True,
        })
    elif cfg.is_moe:
        hf.update({
            "architectures": ["Qwen3MoeForCausalLM"],
            "model_type": "qwen3_moe",
            "num_experts": cfg.num_experts,
            "num_experts_per_tok": cfg.num_experts_per_tok,
            "moe_intermediate_size": cfg.moe_intermediate_size,
            "norm_topk_prob": cfg.norm_topk_prob,
            "decoder_sparse_step": 1,
            "mlp_only_layers": [],
        })
    elif cfg.post_norms:
        hf.update({
            "architectures": ["Gemma2ForCausalLM"],
            "model_type": "gemma2",
            "hidden_activation": "gelu_pytorch_tanh",
            "query_pre_attn_scalar": cfg.query_pre_attn_scalar,
            "attn_logit_softcapping": cfg.attn_logit_softcap,
            "final_logit_softcapping": cfg.final_logit_softcap,
            "sliding_window": cfg.sliding_window,
            "layer_types": layer_types,
        })
    return hf


_ST_NAMES = {torch.bfloat16: "BF16", torch.float32: "F32",
             torch.uint8: "U8"}


def write_safetensors(path, tensors):
    """A minimal safetensors writer (bf16, fp32 and uint8): 8-byte header
    length, the JSON header padded to 8 bytes, then each tensor's bytes in
    order. Returns the bytes written."""
    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for t in tensors.values():
            f.write(t.contiguous().reshape(-1).view(torch.uint8).cpu().numpy())
    return 8 + len(head) + offset


def _leaves(tree, prefix=""):
    """{path: tensor} over a param tree, nested stacks (``layers``,
    ``dense_layers``) included."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


# leaves the init draws as zeros (biases, sinks, the affine router's bias,
# Gemma's delta gains): the checkpoint phase draws them at random, so a
# swapped or dropped one shows in the round trip
ZERO_INIT_LEAVES = ("bq", "bk", "bv", "bo", "sinks", "router_bias",
                    "we_gate_b", "we_up_b", "we_down_b")
DELTA_GAINS = ("attn_norm", "mlp_norm", "post_attn_norm", "post_mlp_norm",
               "q_norm", "k_norm")


def phase_checkpoint(kind, smi, preset="llama3-8b", device="cuda",
                     mxfp4=False):
    """``preset`` (llama3-8b, qwen3-30b-a3b in Qwen3-MoE naming,
    deepseek-v2-lite in DeepSeek-V2 naming: one dense layer, one MoE;
    gpt-oss-20b in GPT-OSS naming; gemma2-9b in Gemma2 naming, tied) at
    full width but 2 layers (depth cut for disk and time), random bf16
    weights from a seed (its zero-initialised leaves drawn too), written
    as a safetensors checkpoint and served through ``--model-dir``: the
    loaded tree and a prompt's last-position logits must equal the
    in-memory tree's, bit for bit. With ``mxfp4`` the GPT-OSS expert
    weights go to disk as MXFP4 blocks and scales, and the in-memory tree
    is the one the packing rounds them to."""
    from gpustack_tpu_torch.engine.api_server import (
        OpenAIServer,
        build_engine_from_args,
        build_parser,
    )
    from gpustack_tpu_torch.engine.runner import ModelRunner
    from gpustack_tpu_torch.models.config import get_config
    from gpustack_tpu_torch.models.transformer import init_params

    cfg = dataclasses.replace(get_config(preset), num_layers=2)
    if cfg.layer_sliding:
        cfg = dataclasses.replace(cfg, layer_sliding=cfg.layer_sliding[:2])
    gen = torch.Generator(device=device).manual_seed(7)
    tree = init_params(cfg, gen, dtype=torch.bfloat16, device=device)
    zeros = ZERO_INIT_LEAVES + (DELTA_GAINS if cfg.norm_delta_gain else ())
    for key in zeros:
        if key in tree["layers"]:
            tree["layers"][key].uniform_(-0.2, 0.2, generator=gen)
    if cfg.norm_delta_gain:
        tree["final_norm"].uniform_(-0.2, 0.2, generator=gen)
    packed = _mxfp4_experts(tree) if mxfp4 else None
    with tempfile.TemporaryDirectory(prefix="ckpt-") as model_dir:
        t0 = time.perf_counter()
        nbytes = write_safetensors(
            os.path.join(model_dir, "model.safetensors"),
            _hf_named(tree, cfg, packed),
        )
        with open(os.path.join(model_dir, "config.json"), "w") as f:
            json.dump(_hf_config(cfg), f)
        write_s = time.perf_counter() - t0
        args = build_parser().parse_args([
            "--model-dir", model_dir, "--max-slots", "8",
            "--max-seq-len", "2048", "--device", device,
        ])
        t0 = time.perf_counter()
        engine = build_engine_from_args(args)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    if dataclasses.replace(engine.cfg, name=cfg.name) != cfg:
        raise AssertionError(f"config.json read back as {engine.cfg}")
    loaded = engine.runner.params
    got, want = _leaves(loaded), _leaves(tree)
    mismatched = [
        key for key, b in want.items()
        if key not in got or got[key].dtype != b.dtype
        or not torch.equal(got[key], b)
    ]
    if mismatched or got.keys() != want.keys():
        raise AssertionError(f"loaded checkpoint differs at {mismatched}")
    in_memory = ModelRunner(
        engine.cfg, tree, engine.runner.device, max_slots=8,
        max_seq_len=2048,
    )
    prompt = engine.tokenizer.encode("A checkpoint from disk. " * 30)
    padded = prompt + [0] * (engine.runner.bucket_for(len(prompt))
                             - len(prompt))
    with torch.no_grad():
        got, _, _ = engine.runner.prefill(padded, len(prompt))
        want, _, _ = in_memory.prefill(padded, len(prompt))
    if not torch.isfinite(got).all() or not torch.equal(got, want):
        raise AssertionError(
            "logits of the loaded checkpoint differ from the in-memory "
            f"tree's: max |err| {(got - want).abs().max().item()}"
        )
    del in_memory, tree, loaded, got, want
    engine.start()
    server = OpenAIServer(engine)
    port = server.start("127.0.0.1", 0)
    try:
        _, raw = _post(port, "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "Hello from disk."}],
            "max_tokens": 8, "temperature": 0,
        })
        usage = _check_usage(json.loads(raw))
    finally:
        server.shutdown()
        engine.stop()
    depth = get_config(preset).num_layers
    emit("checkpoint", model=f"{cfg.name} (2 of {depth} layers)",
         experts="MXFP4 blocks and scales" if mxfp4 else None,
         device=kind, nvidia_smi=smi, checkpoint_gb=nbytes / 1e9, write_s=write_s,
         load_s=load_s, load_gb_per_s=nbytes / 1e9 / load_s,
         logits="identical bits", prompt_tokens=len(prompt),
         chat_usage=usage)


def _int8_logit_check(engine):
    """The int8 tree's last-position logits through the kernel against the
    same tree through the W8A16 plain version (outside the counted
    window)."""
    from gpustack_tpu_torch.ops import w8a16

    runner = engine.runner
    cfg = runner.cfg
    prompt = engine.tokenizer.encode("The int8 logit check. " * 40)
    bucket = runner.bucket_for(len(prompt))
    padded = prompt + [0] * (bucket - len(prompt))

    def through(matmul):
        kernel = w8a16.w8a16_matmul
        w8a16.w8a16_matmul = matmul
        try:
            return runner.prefill(padded, len(prompt))[0]
        finally:
            w8a16.w8a16_matmul = kernel

    with torch.no_grad():
        kernel_last, _, _ = runner.prefill(padded, len(prompt))
        plain_last = through(w8a16.w8a16_plain)
    if kernel_last.shape != (cfg.vocab_size,) or not torch.isfinite(
        kernel_last
    ).all():
        raise AssertionError(f"bad logits {tuple(kernel_last.shape)}")
    scale = plain_last.abs().max().item()
    err = (kernel_last - plain_last).abs().max().item()
    cos = torch.nn.functional.cosine_similarity(
        kernel_last, plain_last, dim=0
    ).item()
    emit("int8_logit_check", prompt_tokens=len(prompt), bucket=bucket,
         max_abs_err=err, logit_scale=scale, cosine=cos,
         tolerance={"rel": LOGIT_REL_TOL, "min_cosine": LOGIT_MIN_COSINE})
    if err > LOGIT_REL_TOL * scale or cos < LOGIT_MIN_COSINE:
        raise AssertionError(
            f"int8 kernel logits differ from the plain version: max |err| "
            f"{err} (scale {scale}), cosine {cos}"
        )
    return scale


F_ARGV = MAIN_ARGV + ["--quantization", "int8"]


def phase_int8(kind, smi, bf16):
    """llama3-8b int8 at full width and depth, drawn on the card, through
    the server: the main path's requests with exact W8A16 and flash
    launch counts, beside phase d's bf16 numbers from this run."""
    from gpustack_tpu_torch.engine.api_server import (
        build_engine_from_args,
        build_parser,
    )
    from gpustack_tpu_torch.models.quant import QuantW

    torch.cuda.reset_peak_memory_stats()
    args = build_parser().parse_args(F_ARGV)
    t0 = time.perf_counter()
    engine = build_engine_from_args(args)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    params = engine.runner.params
    weights = [params["lm_head"], params["embed"]] + [
        params["layers"][k] for k in (
            "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"
        )
    ]
    if not all(isinstance(w, QuantW) for w in weights):
        raise AssertionError("the int8 tree holds a weight that is not int8")
    weight_gb = sum(
        t.numel() * t.element_size() for w in weights for t in (w.q, w.s)
    ) / 1e9
    report, windows = _serve_counted(engine, _int8_logit_check, int8=True)
    counts = windows["served"]
    keys = ("ttft_ms_2048_bucket", "decode_tokens_per_s_8_slots",
            "prefill_ms_2048_bucket", "peak_mem_gb")
    emit("int8_path", model=engine.cfg.name, device=kind, nvidia_smi=smi,
         setup_s=setup_s, launches=counts, int8_weight_gb=weight_gb,
         **report, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         bf16_same_run={k: bf16[k] for k in keys})
    return counts


# ---------------------------------------------------------------------------
# g: speculation, embeddings, profile
# ---------------------------------------------------------------------------

G_NGRAM_ARGV = F_ARGV + ["--speculative", "ngram"]
G_DRAFT_ARGV = MAIN_ARGV + ["--speculative", "draft",
                            "--draft-source", "llama3-8b"]
# repetitive greedy chats: material for the n-gram proposer
SPEC_CHATS = [
    f"Repeat after me: {w} {w} {w} {w} {w} {w}."
    for w in ("alpha beta", "one two three", "la la", "tick tock",
              "red green blue", "spec spec", "go go go", "abc abc")
]
SPEC_MAX_TOKENS = 64
# two forwards that each stay within LOGIT_REL_TOL of the logit scale can
# put two logits at most twice that apart: a greedy choice may flip only
# where the top two were closer
IDS_GAP_REL = 2 * LOGIT_REL_TOL
EMBED_MIN_COSINE = 0.999
PROFILE_STEPS = 20
# the embedding batch: 8 inputs, the longest 1900 tokens (the 2048 bucket)
EMBED_TEXTS = ["x" * 1900] + [
    f"Embedding input {i}: " + "the H100 serves " * (4 + 9 * i)
    for i in range(7)
]


def _greedy(engine, port, logprobs):
    """The chats, all at once, through the engine's ``submit`` (the ids
    and, on the plain engine, each position's top-2 logprobs), then one
    through the server with temperature left unset (0 on a speculative
    server). Returns ([(ids, top-2 gaps)], decode tokens/s)."""
    from gpustack_tpu_torch.engine.engine import GenRequest

    tok = engine.tokenizer
    reqs = [
        engine.submit(GenRequest(
            prompt_ids=tok.apply_chat_template(
                [{"role": "user", "content": c}]
            ),
            max_tokens=SPEC_MAX_TOKENS, temperature=0.0, logprobs=logprobs,
            top_logprobs=2 if logprobs else 0,
        ))
        for c in SPEC_CHATS
    ]
    for r in reqs:
        if not r.done.wait(600):
            raise AssertionError("a greedy chat timed out")
        if r.finish_reason not in ("stop", "length"):
            raise AssertionError(f"a greedy chat ended {r.finish_reason}")
    t_first = max(r.first_token_at for r in reqs)
    t_end = max(r.finished_at for r in reqs)
    rate = sum(len(r.output_ids) - 1 for r in reqs) / max(
        t_end - t_first, 1e-9)
    out = [
        (r.output_ids, [t[0][1] - t[1][1] for t in r.output_top_logprobs]
         if logprobs else None)
        for r in reqs
    ]
    _, raw = _post(port, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": SPEC_CHATS[0]}],
        "max_tokens": 8,
    })
    _check_usage(json.loads(raw))
    return out, rate


def _ids_rule(plain, spec, threshold):
    """Speculative ids against plain greedy ones: equal, or parting only
    where the plain run's top two were within ``threshold``."""
    full, partings = 0, []
    for (p_ids, gaps), (s_ids, _) in zip(plain, spec):
        if p_ids == s_ids:
            full += 1
            continue
        i = next((j for j, (a, b) in enumerate(zip(p_ids, s_ids)) if a != b),
                 min(len(p_ids), len(s_ids)))
        gap = gaps[i] if i < len(gaps) else None
        partings.append({"position": i, "top2_gap": gap})
        if gap is None or not gap < threshold:
            raise AssertionError(
                f"speculative ids part from plain greedy at {i} where the "
                f"top-2 gap {gap} is not under {threshold}"
            )
    return {"prompts": len(plain), "identical": full, "partings": partings,
            "gap_threshold": threshold}


def _window(name, calls, body):
    """Run ``body`` with every launch counted; the counts must equal what
    the runners' forwards in it need."""
    reset_launch_counts()
    for c in calls:
        c.reset()
    out = body()
    counts = launch_counts()
    check_launches(name, counts, expected_launches(calls))
    return counts, out


def _embed_checks(engine, port):
    """``/v1/embeddings`` at the 2048 bucket (8 rows), ``dimensions``,
    ``base64`` and ``/v1/rerank``; returns (vectors, report)."""
    tok = engine.tokenizer
    lens = [len(tok.encode(t)) for t in EMBED_TEXTS]
    if engine.runner.bucket_for(max(lens)) != 2048:
        raise AssertionError(f"embedding batch lengths {lens}")
    t0 = time.perf_counter()
    _, raw = _post(port, "/v1/embeddings", {"input": EMBED_TEXTS})
    batch_ms = (time.perf_counter() - t0) * 1e3
    data = json.loads(raw)
    vecs = torch.tensor([d["embedding"] for d in data["data"]])
    if vecs.shape != (8, engine.cfg.hidden_size) or not torch.isfinite(
        vecs
    ).all() or (vecs.norm(dim=-1) - 1).abs().max() > 1e-3:
        raise AssertionError(f"bad embeddings {tuple(vecs.shape)}")
    if data["usage"]["prompt_tokens"] != sum(lens):
        raise AssertionError(f"embedding usage {data['usage']}")
    dims = engine.cfg.hidden_size // 16                 # 256 at llama3-8b
    _, raw = _post(port, "/v1/embeddings",
                   {"input": EMBED_TEXTS[1], "dimensions": dims})
    cut = torch.tensor(json.loads(raw)["data"][0]["embedding"])
    _, raw = _post(port, "/v1/embeddings",
                   {"input": EMBED_TEXTS[1], "encoding_format": "base64"})
    packed = base64.b64decode(json.loads(raw)["data"][0]["embedding"])
    full = torch.tensor(struct.unpack(f"<{len(packed) // 4}f", packed))
    want_cut = full[:dims] / full[:dims].norm()
    if cut.shape != (dims,) or (cut - want_cut).abs().max() > 1e-5:
        raise AssertionError(f"dimensions={dims} is not the renormalised cut")
    query = "Embedding input 2"
    _, raw = _post(port, "/v1/rerank",
                   {"query": query, "documents": EMBED_TEXTS[1:], "top_n": 4})
    results = json.loads(raw)["results"]
    scores = [r["relevance_score"] for r in results]
    if len(results) != 4 or scores != sorted(scores, reverse=True):
        raise AssertionError(f"rerank results out of order: {scores}")
    return vecs, {"batch": 8, "bucket": 2048, "input_tokens": lens,
                  "http_ms_batch": batch_ms, "rerank_scores": scores,
                  f"dimensions_{dims}": "renormalised cut",
                  "base64": "round trip"}


def _embed_reference(engine, vecs, tape=None):
    """Outside the counted window: the served vectors against a reference
    of the same inputs, and one 8 x 2048 embedding forward timed with
    CUDA events. Where the config takes the flash kernel the reference is
    each row through the same forward with the plain attention (one row
    at a time, the batch's bucket); where it does not, the batch through
    the fp32 plain forward (:func:`_fp32_model`) with the served batch's
    expert picks replayed from ``tape`` (an MoE model's; its recording of
    the served window)."""
    from gpustack_tpu_torch.models import transformer as tf

    tape = tape or _RoutingTape()
    runner, tok = engine.runner, engine.tokenizer
    ids = [tok.encode(t) for t in EMBED_TEXTS]
    padded = [r + [0] * (2048 - len(r)) for r in ids]
    flash = tf.flash_eligible(runner.cfg)
    cos = []
    with torch.no_grad():
        if flash:
            runner.attn_impl_for = lambda bucket: "plain"
            try:
                for row, r, v in zip(padded, ids, vecs):
                    plain = runner.embed([row], [len(r)])[0].float().cpu()
                    cos.append(torch.nn.functional.cosine_similarity(
                        plain, v, dim=0).item())
            finally:
                del runner.attn_impl_for
        else:
            params, cfg32 = _fp32_model(runner)
            tokens = torch.tensor(padded, device=runner.device)
            positions = torch.arange(2048, device=runner.device)[None, :]
            tape.mode = "replay"
            with tape:
                hidden, _ = tf.forward(
                    params, cfg32, tokens, positions.expand(len(padded), -1),
                    return_hidden=True, attn_impl="plain",
                )
            lens = torch.tensor([len(r) for r in ids], device=runner.device)
            mask = (positions < lens[:, None])[..., None].float()
            pooled = (hidden * mask).sum(dim=1) / mask.sum(dim=1)
            ref = torch.nn.functional.normalize(pooled, dim=-1).cpu()
            cos = torch.nn.functional.cosine_similarity(
                ref, vecs, dim=-1).tolist()
        times = []
        for _ in range(4):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            runner.embed(padded, [len(r) for r in ids])
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
    if min(cos) < EMBED_MIN_COSINE:
        raise AssertionError(
            f"served embeddings against the reference: cosines {cos}"
        )
    reference = {
        "reference": ("plain attention, bf16" if flash
                      else "fp32 plain forward"),
        "cosine_vs_reference": cos,
        "forward_ms_8x2048": statistics.median(times[1:]),
    }
    if tape.picks:
        reference["routing"] = (
            "the served batch's expert picks replayed" if not flash
            else "free"
        )
        if not flash:
            reference["tokens_with_a_flipped_pick"] = sum(tape.flips)
    return reference


def summarize_trace(path, steps):
    """From a Chrome trace: the union of device intervals over the
    captured window (busy share), the 10 kernels with the most device
    time, and the device's idle time per step (host time between
    kernels)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not any(e["cat"] == "kernel" for e in device):
        raise AssertionError(f"{path}: the trace holds no kernel")
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + e["dur"] for e in events)
    busy, end, gaps = 0.0, None, []
    for e in sorted(device, key=lambda e: e["ts"]):
        s, f = e["ts"], e["ts"] + e["dur"]
        if end is None or s > end:
            if end is not None:
                gaps.append(s - end)
            busy += f - s
            end = f
        elif f > end:
            busy += f - end
            end = f
    by_name = {}
    for e in device:
        row = by_name.setdefault(e["name"], [0.0, 0])
        row[0] += e["dur"]
        row[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    window = t1 - t0
    return {
        "window_ms": window / 1e3, "steps_in_trace": steps,
        "device_busy_share": busy / window,
        "device_ms_per_step": busy / steps / 1e3,
        "idle_ms_per_step": (window - busy) / steps / 1e3,
        "kernels_per_step": sum(e["cat"] == "kernel" for e in device) / steps,
        "gap_us_median": statistics.median(gaps) if gaps else 0.0,
        "gap_us_max": max(gaps, default=0.0),
        "top_device_ops": [
            {"name": _short_kernel_name(n), "ms": us / 1e3, "calls": c,
             "share": us / busy}
            for n, (us, c) in top
        ],
        "trace_mb": os.path.getsize(path) / 1e6,
    }


def _short_kernel_name(name):
    """A kernel's name without its parameter list and namespaces, keeping
    the functor an ATen elementwise kernel was instantiated for."""
    name = re.sub(r"\(anonymous namespace\)::|at::native::|c10::|void ", "",
                  name)
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):       # drop the trailing parameter list
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i:
            cut = i
            break
    return name[:cut][:240]


def _profile(port, label):
    """``/debug/profile?steps=20`` while 8 chats decode; the trace
    summarised."""
    from gpustack_tpu_torch.engine.engine import PROFILE_TRACE_FILE

    started = [threading.Event() for _ in range(8)]
    chats = [
        threading.Thread(target=_stream_chat, args=(
            port, [{"role": "user", "content": f"Profile chat {i} " * 3}],
            256, None, started[i]))
        for i in range(8)
    ]
    for t in chats:
        t.start()
    for e in started:
        if not e.wait(120):
            raise AssertionError("a chat never streamed")
    out_dir = tempfile.mkdtemp(prefix=f"profile-{label}-")
    time.sleep(0.5)             # unprofiled decode steps to compare with
    t_capture = time.time()
    try:
        _, raw = _post(
            port, f"/debug/profile?steps={PROFILE_STEPS}&timeout_s=120"
            f"&out_dir={out_dir}", {},
        )
        result = json.loads(raw)
        if result["profiler"] != "torch" or result["steps_captured"] != (
            PROFILE_STEPS
        ):
            raise AssertionError(f"profile capture: {result['error']} "
                                 f"{result['steps_captured']} steps")
        # the trace opens after the first captured step's record
        summary = summarize_trace(
            os.path.join(out_dir, PROFILE_TRACE_FILE), PROFILE_STEPS - 1
        )
    finally:
        for t in chats:
            t.join(timeout=600)
        for name in os.listdir(out_dir):
            os.remove(os.path.join(out_dir, name))
        os.rmdir(out_dir)
    if any(t.is_alive() for t in chats):
        raise AssertionError("a profiled chat did not finish")
    records = json.loads(_get(port, "/debug/flight?limit=400"))["records"]
    before = [r["dur_ms"] for r in records
              if r["ts"] < t_capture and r["mode"] == "decode"][-20:]
    if not before:
        raise AssertionError("no decode step before the capture")
    unprofiled = statistics.median(before)
    return {**summary, "profiler_start_ms": result["profiler_start_ms"],
            "flight_modes": result["aggregate"]["modes"],
            # the profiler slows the host; kernels keep their time
            "step_ms_unprofiled": unprofiled,
            "device_busy_share_unprofiled": (
                summary["device_ms_per_step"] / unprofiled
            )}


def _spec_pair(argv, int8, label, kind, smi):
    """A speculative server built from ``argv`` and a plain server over
    the same target weights, both through the port's server: greedy chats
    on each (ids held to the rule above), the embedding and profile checks
    on the plain one. Every window's launches are exact. Returns ({window:
    counts}, report)."""
    from gpustack_tpu_torch.engine.api_server import (
        OpenAIServer,
        build_engine_from_args,
        build_parser,
    )
    from gpustack_tpu_torch.engine.engine import LLMEngine

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    spec = build_engine_from_args(build_parser().parse_args(argv))
    plain = LLMEngine(
        spec.cfg, spec.runner.params, tokenizer=spec.tokenizer,
        max_slots=spec.max_slots, max_seq_len=spec.max_seq_len,
        device=spec.device,
    )
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    check = _int8_logit_check if int8 else _logit_check
    scale = check(plain)
    spec_calls = [RunnerCalls(spec.runner, int8)]
    if spec.draft_runner is not None:
        spec_calls.append(RunnerCalls(spec.draft_runner, False))
    plain_calls = [RunnerCalls(plain.runner, int8)]
    servers, ports = [], []
    for engine in (spec, plain):
        engine.start()
        servers.append(OpenAIServer(engine))
        ports.append(servers[-1].start("127.0.0.1", 0))
    windows = {}
    try:
        windows[f"{label}_plain"], (p_out, p_rate) = _window(
            f"{label} plain chats", plain_calls,
            lambda: _greedy(plain, ports[1], logprobs=True),
        )
        windows[f"{label}_spec"], (s_out, s_rate) = _window(
            f"{label} speculative chats", spec_calls,
            lambda: _greedy(spec, ports[0], logprobs=False),
        )
        health = spec.health()
        rule = _ids_rule(p_out, s_out, IDS_GAP_REL * scale)
        windows[f"{label}_embed"], (vecs, embed) = _window(
            f"{label} embeddings", plain_calls,
            lambda: _embed_checks(plain, ports[1]),
        )
        embed.update(_embed_reference(plain, vecs))
        windows[f"{label}_profile"], profile = _window(
            f"{label} profile", plain_calls,
            lambda: _profile(ports[1], label),
        )
        for engine in (spec, plain):
            if engine.health()["status"] != "ok":
                raise AssertionError(f"engine unhealthy: {engine.health()}")
    finally:
        for server in servers:
            server.shutdown()
        spec.stop()
        plain.stop()
    report = {
        "model": spec.cfg.name, "weights": "int8" if int8 else "bf16",
        "speculative": health["speculative"],
        "draft_model": health["draft_model"], "device": kind,
        "nvidia_smi": smi, "setup_s": setup_s,
        "spec_steps": health["spec_steps"],
        "spec_extra_tokens": health["spec_extra_tokens"],
        "spec_acceptance_rate": health["spec_acceptance_rate"],
        "ids_rule": rule, "logit_scale": scale,
        "decode_tokens_per_s_8_chats": {"plain": p_rate,
                                        "speculative": s_rate},
        "embeddings": embed, "profile": profile,
        "runner_calls": {w: c.counts() for w, c in (
            ("spec", spec_calls[0]), ("plain", plain_calls[0]))},
        "launches": windows,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    return windows, report


def phase_speculation(kind, smi):
    """n-gram speculation on llama3-8b int8 and a perfect draft on bf16,
    each beside a plain server over the same weights; embeddings and a
    profile on each plain server."""
    windows, ngram = _spec_pair(G_NGRAM_ARGV, True, "ngram_int8", kind, smi)
    if ngram["spec_steps"] < 1 or ngram["spec_extra_tokens"] < 1:
        raise AssertionError(f"n-gram speculation accepted nothing: {ngram}")
    emit("speculation_ngram_int8", **ngram)
    _free()
    more, draft = _spec_pair(G_DRAFT_ARGV, False, "draft_bf16", kind, smi)
    emit("speculation_draft_bf16", **draft)
    if draft["spec_acceptance_rate"] < 0.9:
        raise AssertionError(
            f"a perfect draft accepted {draft['spec_acceptance_rate']}"
        )
    windows.update(more)
    return windows


# ---------------------------------------------------------------------------
# h: the MoE family
# ---------------------------------------------------------------------------

H_PRESET = "qwen3-30b-a3b"
H_ARGV = ["--preset", H_PRESET] + MAIN_ARGV[2:]
PEAK_FP32_FLOPS = 67e12       # H100 SXM fp32 outside the tensor cores
# one MoE layer in bf16 against an fp32 routed reference (each token
# through its own top-k experts only): bf16 rounding of x, g, u, h·c and
# the output, relative to the output's scale
MOE_REL_TOL = 2e-2
MOE_MIN_COSINE = 0.999


def _moe_routed_reference(x, lp, li, cfg):
    """One MoE layer computed the routed way, in fp32: each expert over
    only the tokens that picked it, then ``routed_scaling_factor`` and the
    ungated shared experts (DeepSeek) where the layer has them; GPT-OSS's
    router bias, expert biases and clamped GLU where it has them. An
    independent formulation of what the dense dispatch computes."""
    from gpustack_tpu_torch.models import transformer as tf

    def mlp(xs, g, u, d, e=None):
        g, u = xs @ g.float(), xs @ u.float()
        if e is None or cfg.moe_act != "gptoss":
            return (torch.nn.functional.silu(g) * u) @ d.float()
        g = (g + lp["we_gate_b"][li, e].float()).clamp(max=7.0)
        u = (u + lp["we_up_b"][li, e].float()).clamp(-7.0, 7.0)
        h = (u + 1.0) * (g * torch.sigmoid(1.702 * g))
        return h @ d.float() + lp["we_down_b"][li, e].float()

    xf = x.reshape(-1, cfg.hidden_size).float()
    top_idx, combine = tf.moe_route(
        xf, lp["router"][li], cfg,
        lp["router_bias"][li] if "router_bias" in lp else None,
    )
    out = torch.zeros_like(xf)
    for e in top_idx.unique().tolist():
        rows = (top_idx == e).any(dim=-1).nonzero().squeeze(1)
        out[rows] += combine[rows, e, None] * mlp(
            xf[rows], lp["we_gate"][li, e], lp["we_up"][li, e],
            lp["we_down"][li, e], e,
        )
    out *= cfg.routed_scaling_factor
    if "ws_gate" in lp:
        out += mlp(xf, lp["ws_gate"][li], lp["ws_up"][li], lp["ws_down"][li])
    return out, top_idx


def _moe_layer_case(params, cfg, tokens, gen, li=0):
    """Layer ``li``'s MoE block over ``tokens`` rows (normalised random
    input): held against the routed fp32 reference, timed with CUDA
    events, beside its dense-dispatch and routed bounds (the experts
    this input's routing reaches), its transient device memory, and a
    ``torch.profiler`` split of its device time by kernel."""
    from gpustack_tpu_torch.models import transformer as tf

    lp = params["layers"]
    D, E, Fm, k = (cfg.hidden_size, cfg.num_experts,
                   cfg.moe_intermediate_size, cfg.num_experts_per_tok)
    Fs = cfg.shared_expert_intermediate_size if "ws_gate" in lp else 0
    x = tf.rms_norm(
        torch.randn(1, tokens, D, generator=gen, device=gen.device).bfloat16(),
        lp["mlp_norm"][li], cfg.rms_norm_eps,
    )

    shared = (lp["ws_gate"][li], lp["ws_up"][li], lp["ws_down"][li],
              None) if Fs else None
    biases = (lp["we_gate_b"][li], lp["we_up_b"][li],
              lp["we_down_b"][li]) if cfg.moe_bias else None
    router_bias = lp["router_bias"][li] if "router_bias" in lp else None

    def layer():
        return tf._moe_mlp(x, lp["router"][li], lp["we_gate"][li],
                           lp["we_up"][li], lp["we_down"][li], cfg,
                           router_bias=router_bias, shared=shared,
                           biases=biases)

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = layer()
    torch.cuda.synchronize()
    transient = torch.cuda.max_memory_allocated() - base
    ref, top_idx = _moe_routed_reference(x, lp, li, cfg)
    got = out.reshape(-1, D).float()
    scale = ref.abs().max().item()
    err = (got - ref).abs().max().item()
    cos = torch.nn.functional.cosine_similarity(
        got.flatten(), ref.flatten(), dim=0
    ).item()
    if not torch.isfinite(got).all() or err > MOE_REL_TOL * scale or (
        cos < MOE_MIN_COSINE
    ):
        raise AssertionError(
            f"MoE layer at {tokens} tokens differs from the routed "
            f"reference: max |err| {err} (scale {scale}), cosine {cos}"
        )
    # g, u and h of one chunk; an [E, tokens, D] copy of x would add its
    # own size on top
    gu_h = 3 * min(tokens, tf.MOE_CHUNK_BYTES // (3 * E * Fm * 2)) * E * Fm * 2
    x_copy = E * tokens * D * 2
    if transient > gu_h + max(x_copy // 2, 64 << 20):
        raise AssertionError(
            f"MoE layer at {tokens} tokens held {transient / 1e9} GB of "
            f"transients; g, u and h are {gu_h / 1e9} GB"
        )
    ms = cuda_time_ms(layer)
    # where a call's device time goes, by kernel (three calls traced)
    with tempfile.TemporaryDirectory(prefix="moe-trace-") as d:
        path = os.path.join(d, "trace.json")
        with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA,
        ]) as prof:
            for _ in range(3):
                layer()
            torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        trace = summarize_trace(path, 3)
    reached = int(top_idx.unique().numel())
    # x in, out, the router, and the shared experts (every token's)
    io = 2 * tokens * D * 2 + D * E * 2 + 3 * D * Fs * 2
    # one expert's weights (and GPT-OSS's biases)
    expert_bytes = (3 * D * Fm + (2 * Fm + D if biases else 0)) * 2
    router_ops = 2 * tokens * D * E / PEAK_FP32_FLOPS * 1e3

    def bound(experts_read, expert_rows):
        flop = 2 * 3 * D * (expert_rows * Fm + tokens * Fs)
        t_ops = flop / PEAK_BF16_FLOPS * 1e3 + router_ops
        t_bytes = (io + experts_read * expert_bytes) / PEAK_BYTES_S * 1e3
        return {"ms": max(t_ops, t_bytes),
                "by": "operations" if t_ops >= t_bytes else "bytes",
                "tflop": flop / 1e12,
                "gbytes": (io + experts_read * expert_bytes) / 1e9}

    return {
        "tokens": tokens, "ms": ms, "ms_per_token": ms / tokens,
        "dense_bound": bound(E, tokens * E),
        "routed_bound": bound(reached, tokens * k),
        "experts_reached": reached,
        "max_abs_err": err, "out_scale": scale, "cosine": cos,
        "transient_gb": transient / 1e9, "g_u_h_gb": gu_h / 1e9,
        "x_copy_gb_avoided": x_copy / 1e9,
        "trace": {
            "device_ms_per_call": trace["device_ms_per_step"],
            "device_busy_share": trace["device_busy_share"],
            "kernels_per_call": trace["kernels_per_step"],
            "top_device_ops": trace["top_device_ops"][:6],
        },
    }


def phase_moe(kind, smi, device="cuda"):
    """qwen3-30b-a3b: its full widths at 2 layers as a Qwen3-MoE
    checkpoint through ``--model-dir``; then bf16 at full width and depth
    through the server (phase d's requests, flash logits against the
    plain attention, exact launches, a 20-step profile while 8 chats
    decode); then one MoE layer timed at the 2048 bucket and at 8
    decoding slots. Returns {window: launch counts}."""
    from gpustack_tpu_torch.engine.api_server import (
        build_engine_from_args,
        build_parser,
    )

    phase_checkpoint(kind, smi, preset=H_PRESET, device=device)
    _free()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = build_engine_from_args(build_parser().parse_args(H_ARGV))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    tree_gb = sum(
        t.numel() * t.element_size() for t in (
            [engine.runner.params[k] for k in ("embed", "final_norm",
                                               "lm_head")]
            + list(engine.runner.params["layers"].values())
        )
    ) / 1e9
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    report, windows = _serve_counted(engine, _logit_check, int8=False,
                                     profile="moe")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    profile = report.pop("profile")
    emit("moe_path", model=engine.cfg.name, device=kind, nvidia_smi=smi,
         setup_s=setup_s, tree_gb=tree_gb, init_peak_gb=init_peak_gb,
         launches=windows, **report, peak_mem_gb=peak_gb)
    emit("moe_profile", model=engine.cfg.name, device=kind, nvidia_smi=smi,
         **profile)
    gen = torch.Generator(device=device).manual_seed(3)
    with torch.no_grad():
        layers = [
            _moe_layer_case(engine.runner.params, engine.cfg, t, gen)
            for t in (2048, engine.max_slots)
        ]
    emit("moe", model=engine.cfg.name, device=kind, nvidia_smi=smi,
         dispatch="dense (every expert over every token)",
         tolerance={"rel": MOE_REL_TOL, "min_cosine": MOE_MIN_COSINE},
         layers=layers)
    del engine
    return {f"moe_{w}": c for w, c in windows.items()}


# ---------------------------------------------------------------------------
# i: the DeepSeek family
# ---------------------------------------------------------------------------

def _tree_gb(params):
    return sum(
        t.numel() * t.element_size() for t in _leaves(params).values()
    ) / 1e9


def _held_gb(phase):
    """The previous phase's tree must be gone before this one's is drawn."""
    held_gb = torch.cuda.memory_allocated() / 1e9
    if held_gb > 4:
        raise AssertionError(f"{held_gb} GB still allocated before {phase}")
    return held_gb


I_PRESET = "deepseek-v2-lite"
I_ARGV = ["--preset", I_PRESET] + MAIN_ARGV[2:]


def phase_deepseek(kind, smi, device="cuda"):
    """deepseek-v2-lite (MLA served decompressed at d 192, one dense layer
    then 26 DeepSeek-MoE layers, YaRN): its full widths at 2 layers as a
    DeepSeek-V2 checkpoint through ``--model-dir``; then bf16 at full
    width and depth through the server (phase d's requests, flash logits
    against the plain attention with the kernel run's expert picks
    replayed, exact launches, embeddings at the 2048 bucket, a 20-step
    profile while 8 chats decode); then one of its MoE layers (64
    experts, top-6, two shared experts) at the 2048 bucket and at 8
    decoding slots. Returns {window: launch counts}."""
    from gpustack_tpu_torch.engine.api_server import (
        build_engine_from_args,
        build_parser,
    )
    from gpustack_tpu_torch.models.transformer import attn_scale

    held_gb = _held_gb("phase i")           # phase h's 61 GB are gone
    phase_checkpoint(kind, smi, preset=I_PRESET, device=device)
    _free()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = build_engine_from_args(build_parser().parse_args(I_ARGV))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    params = engine.runner.params
    tree_gb = _tree_gb(params)
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    report, windows = _serve_counted(engine, _logit_check, int8=False,
                                     profile="deepseek", embed=True)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    profile = report.pop("profile")
    emit("deepseek_path", model=engine.cfg.name, device=kind, nvidia_smi=smi,
         setup_s=setup_s, tree_gb=tree_gb, init_peak_gb=init_peak_gb,
         held_before_gb=held_gb, softmax_scale=attn_scale(engine.cfg),
         launches=windows, **report, peak_mem_gb=peak_gb)
    emit("deepseek_profile", model=engine.cfg.name, device=kind,
         nvidia_smi=smi, **profile)
    gen = torch.Generator(device=device).manual_seed(3)
    with torch.no_grad():
        layers = [
            _moe_layer_case(params, engine.cfg, t, gen)
            for t in (2048, engine.max_slots)
        ]
    emit("moe", model=engine.cfg.name, device=kind, nvidia_smi=smi,
         dispatch="dense (every expert over every token), shared experts "
         "on every token",
         tolerance={"rel": MOE_REL_TOL, "min_cosine": MOE_MIN_COSINE},
         layers=layers)
    del engine, params
    return {f"deepseek_{w}": c for w, c in windows.items()}


# ---------------------------------------------------------------------------
# j: the GPT-OSS family
# ---------------------------------------------------------------------------

J_PRESET = "gpt-oss-20b"
J_ARGV = ["--preset", J_PRESET] + MAIN_ARGV[2:]


def phase_gptoss(kind, smi, device="cuda"):
    """gpt-oss-20b (sinks, sliding layers of 128 on the even layers, q/k/v/o
    biases, YaRN; 32 experts, top-4, the affine router and clamped GLU):
    its full widths at 2 layers as a GPT-OSS checkpoint with MXFP4 expert
    blocks through ``--model-dir``; then bf16 at full width and depth
    through the server (phase d's requests, the served logits against the
    fp32 plain forward with the served run's expert picks replayed, exact
    launches: the flash kernel never, as in JAX; embeddings at the 2048
    bucket, a 20-step profile while 8 chats decode, a 2048-bucket prefill
    split into its attention and MoE time); then one MoE layer at the
    2048 bucket and at 8 decoding slots. Returns {window: launch
    counts}."""
    from gpustack_tpu_torch.engine.api_server import (
        build_engine_from_args,
        build_parser,
    )

    held_gb = _held_gb("phase j")
    phase_checkpoint(kind, smi, preset=J_PRESET, device=device, mxfp4=True)
    _free()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = build_engine_from_args(build_parser().parse_args(J_ARGV))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    params = engine.runner.params
    tree_gb = _tree_gb(params)
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    report, windows = _serve_counted(engine, _logit_check, int8=False,
                                     profile="gptoss", embed=True)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    profile = report.pop("profile")
    emit("gptoss_path", model=engine.cfg.name, device=kind, nvidia_smi=smi,
         setup_s=setup_s, tree_gb=tree_gb, init_peak_gb=init_peak_gb,
         held_before_gb=held_gb, launches=windows, **report,
         prefill_split=_prefill_split(engine), peak_mem_gb=peak_gb)
    emit("gptoss_profile", model=engine.cfg.name, device=kind,
         nvidia_smi=smi, **profile)
    gen = torch.Generator(device=device).manual_seed(3)
    with torch.no_grad():
        layers = [
            _moe_layer_case(params, engine.cfg, t, gen)
            for t in (2048, engine.max_slots)
        ]
    emit("moe", model=engine.cfg.name, device=kind, nvidia_smi=smi,
         dispatch="dense (every expert over every token), expert biases "
         "and the clamped GLU",
         tolerance={"rel": MOE_REL_TOL, "min_cosine": MOE_MIN_COSINE},
         layers=layers)
    del engine, params
    return {f"gptoss_{w}": c for w, c in windows.items()}


# ---------------------------------------------------------------------------
# k: the Gemma family
# ---------------------------------------------------------------------------

K_PRESET = "gemma2-9b"
K_ARGV = ["--preset", K_PRESET] + MAIN_ARGV[2:]


def phase_gemma(kind, smi, device="cuda"):
    """gemma2-9b (delta-gain sandwich norms, the scaled and tied
    embedding, tanh GELU, ``query_pre_attn_scalar``, attention and final
    softcaps, a window of 4096 on the even layers): its full widths at 2
    layers as a tied Gemma2 checkpoint through ``--model-dir``; then bf16
    at full width and depth through the server (phase d's requests, the
    served logits against the fp32 plain forward, exact launches: the
    flash kernel never, as in JAX; embeddings at the 2048 bucket); then
    ``--quantization int8`` (the seven layer weights through the W8A16
    kernel at head_dim 256, d 3584, F 14336; the tied embedding bf16, so
    no W8A16 lm_head) with phase d's requests, its kernel logits against
    the W8A16 plain version; each path's 2048-bucket prefill split into
    its attention time. Returns {window: launch counts}."""
    from gpustack_tpu_torch.engine.api_server import (
        build_engine_from_args,
        build_parser,
    )
    from gpustack_tpu_torch.models.quant import QuantW

    held_gb = _held_gb("phase k")
    phase_checkpoint(kind, smi, preset=K_PRESET, device=device)
    _free()
    paths, bf16 = {}, {}
    for label, argv, int8 in (
        ("gemma", K_ARGV, False),
        ("gemma_int8", K_ARGV + ["--quantization", "int8"], True),
    ):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        engine = build_engine_from_args(build_parser().parse_args(argv))
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        params = engine.runner.params
        layer_weights = [params["layers"][k] for k in (
            "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"
        )]
        if int8 != all(isinstance(w, QuantW) for w in layer_weights) or (
            isinstance(params["embed"], QuantW) or "lm_head" in params
        ):
            raise AssertionError(f"{label}: the tree's weights are not as "
                                 "this path serves them")
        tree_gb = sum(
            t.numel() * t.element_size()
            for w in [params["embed"], params["final_norm"],
                      *params["layers"].values()]
            for t in ((w.q, w.s) if isinstance(w, QuantW) else (w,))
        ) / 1e9
        report, windows = _serve_counted(
            engine, _int8_logit_check if int8 else _logit_check, int8=int8,
            embed=not int8,
        )
        report["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        report["prefill_split"] = _prefill_split(engine)
        if not int8:
            bf16 = report
        keys = ("ttft_ms_2048_bucket", "decode_tokens_per_s_8_slots",
                "prefill_ms_2048_bucket", "peak_mem_gb")
        emit(f"{label}_path", model=engine.cfg.name, device=kind,
             nvidia_smi=smi, setup_s=setup_s, tree_gb=tree_gb,
             held_before_gb=held_gb, launches=windows, **report,
             **({"bf16_same_run": {k: bf16[k] for k in keys}}
                if int8 else {}))
        paths.update({f"{label}_{w}": c for w, c in windows.items()})
        del engine, params, layer_weights
        _free()
    return paths


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "gpustack_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 3
    sys.path.insert(0, root)
    kind, smi = phase_device()
    phase_build()
    rows = phase_kernels()
    paths = {}
    _free()
    torch.cuda.reset_peak_memory_stats()
    paths["main_path"], bf16 = phase_main_path(kind, smi)
    bf16["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    _free()
    paths["prefix_reuse"] = phase_prefix_reuse(kind, smi)
    _free()
    phase_checkpoint(kind, smi)
    _free()
    paths["int8_path"] = phase_int8(kind, smi, bf16)
    _free()
    paths.update(phase_speculation(kind, smi))
    _free()
    paths.update(phase_moe(kind, smi))
    _free()
    paths.update(phase_deepseek(kind, smi))
    _free()
    paths.update(phase_gptoss(kind, smi))
    _free()
    paths.update(phase_gemma(kind, smi))
    kernels = []
    large_m = rows.pop("w8a16_large_m")
    gemma2 = rows.pop("w8a16_gemma2")
    group8 = rows.pop("flash_group8")
    mla = rows.pop("flash_mla")
    for name, row in rows.items():
        launches = sum(counts[name] for counts in paths.values())
        if launches < 1:
            raise AssertionError(f"{name} never launched on a served path")
        kernels.append({
            "name": name, **KERNEL_META[name], "launches": launches,
            **{k: row[k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms",
            )},
            # W8A16: what bf16 serving pays for the same product
            **{k: row[k] for k in ("cublas_bf16_dequantized_ms",) if k in row},
        })
    # W8A16's two paths: the row above is the decode GEMV's (M = 8, w_gate);
    # beside it the wgmma path at 2048 x 4096 x 14336
    w8 = next(k for k in kernels if k["name"] == "w8a16_matmul")
    w8.update({
        "launches_by_path": {
            path: sum(counts[f"w8a16_{path}"] for counts in paths.values())
            for path in ("gemv", "wgmma")
        },
        "large_m_shape": large_m["shape"],
        **{f"large_m_{k}": large_m[k] for k in (
            "max_abs_err", "ms", "bound_ms", "bound_by",
            "cublas_bf16_dequantized_ms", "eager_dequant_ms",
        )},
        # at gemma2-9b's widths (phase k), w_gate at the 2048 bucket
        "gemma2_launches": sum(
            counts["w8a16_matmul"] for path, counts in paths.items()
            if path.startswith("gemma_int8")
        ),
        "gemma2_shape": gemma2["shape"],
        **{f"gemma2_{k}": gemma2[k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "cublas_bf16_dequantized_ms",
        )},
    })
    # the flash kernel at qwen3-30b-a3b's heads (group 8) and at
    # deepseek-v2-lite's (d 192), T = S = 2048
    fl = next(k for k in kernels if k["name"] == "flash_attention_prefill")
    for tag, row in (("group8", group8), ("mla", mla)):
        fl.update({
            f"{tag}_shape": row["shape"],
            **{f"{tag}_{k}": row[k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms",
            )},
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


def _free():
    gc.collect()
    torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
