#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: ``python3 chip_smoke.py``.

Phases (each prints one JSON line; any failure raises and exits non-zero):

a. device: the card's name, count and power limit;
b. build: every CUDA source of the port, one ``nvcc`` each, in parallel,
   with each kernel's ``ptxas`` registers, whether ``setmaxnreg`` took
   effect (no C7508 warning) and any ``wgmma`` serialisation ptxas
   reports;
c. kernels: each hand-written kernel against its plain PyTorch version on
   the card, at the shapes the main path gives it, with times (CUDA
   events; the main shape three times, for a spread) beside the least time
   the card could take (``bound_ms``), one PyTorch library call computing
   the same function (``library_ms``, a yardstick the port never calls),
   and the host's microseconds per call (wall clock around back-to-back
   enqueues), which says whether a row is host- or device-bound;
d. main path: the port's OpenAI server in-process, serving llama3-8b at
   full width (bf16, random weights from a seed) with 8 slots and a
   2048-token context: chat, streaming chat, a completion whose prompt
   fills the 2048 bucket, four concurrent chats, and a repeated greedy
   prompt. Every kernel's launch count is read around this phase alone
   and must equal what the path needs (flash prefill: 32 per prefill).
   A kernel prefill's last-position logits are held against a prefill
   through the plain attention. Reported: TTFT of one 2048-bucket prompt,
   decode tokens/s with 8 slots busy, and (after the counts are read) the
   2048-bucket prefill timed with CUDA events.

The last lines are the ``kernels`` line, the ``nvidia-smi`` name and
power-limit line, and ``{"ok": true, "device": {...}}``. Without CUDA, or
outside a checkout of the repository, it exits non-zero and prints no
result.
"""

import gc
import json
import os
import re
import statistics
import subprocess
import sys
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


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


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
    """``name<N>`` for a kernel template ``name<int N>``: the identifier
    before ``ILi<N>E`` is the one whose length prefix matches it."""
    m = re.search(r"ILi(\d+)E", mangled)
    head = mangled[:m.start()] if m else ""
    n = next((n for n in range(1, len(head)) if head[:-n].endswith(str(n))), 0)
    return f"{head[-n:]}<{m.group(1)}>" if n else mangled


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
    ]
    rows = [
        _flash_case(*c, gen, repeats=3 if i == 0 else 1)
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
    return {"flash_attention_prefill": rows[0]}


KERNEL_META = {
    "flash_attention_prefill": {
        "route": "cuda",
        "source": "gpustack_tpu_torch/ops/csrc/flash_attention.cu",
        "replaces": "gpustack_tpu/ops/flash_attention.py:39",
    },
}


def launch_counts():
    from gpustack_tpu_torch.ops.flash_attention import flash_attention_prefill

    return {"flash_attention_prefill": flash_attention_prefill.launches}


def reset_launch_counts():
    from gpustack_tpu_torch.ops.flash_attention import flash_attention_prefill

    flash_attention_prefill.launches = 0


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


def _logit_check(engine):
    """A kernel prefill's last logits against the plain-attention prefill
    of the same prompt (outside the counted window)."""
    from gpustack_tpu_torch.models import transformer as tf

    runner = engine.runner
    cfg = runner.cfg
    prompt = engine.tokenizer.encode("The port's logit check. " * 40)
    bucket = runner.bucket_for(len(prompt))
    padded = prompt + [0] * (bucket - len(prompt))
    with torch.no_grad():
        kernel_last, _, _ = runner.prefill(padded, len(prompt))
        tokens = torch.tensor([padded], device=runner.device)
        positions = torch.arange(bucket, device=runner.device)[None, :]
        cache = tf.KVCache.create(cfg, 1, bucket, runner.device)
        hidden, _ = tf.forward(
            runner.params, cfg, tokens, positions, cache,
            return_hidden=True, attn_impl="plain",
        )
        plain_last = tf.lm_head(runner.params, cfg, hidden[0, len(prompt) - 1])
    if kernel_last.shape != (cfg.vocab_size,) or not torch.isfinite(
        kernel_last
    ).all():
        raise AssertionError(f"bad logits {tuple(kernel_last.shape)}")
    scale = plain_last.abs().max().item()
    err = (kernel_last - plain_last).abs().max().item()
    cos = torch.nn.functional.cosine_similarity(
        kernel_last, plain_last, dim=0
    ).item()
    emit("logit_check", prompt_tokens=len(prompt), bucket=bucket,
         max_abs_err=err, logit_scale=scale, cosine=cos,
         tolerance={"rel": LOGIT_REL_TOL, "min_cosine": LOGIT_MIN_COSINE})
    if err > LOGIT_REL_TOL * scale or cos < LOGIT_MIN_COSINE:
        raise AssertionError(
            f"kernel prefill logits differ: max |err| {err} (scale "
            f"{scale}), cosine {cos}"
        )


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


MAIN_ARGV = [
    "--preset", "llama3-8b", "--max-slots", "8", "--max-seq-len", "2048",
    "--host", "127.0.0.1", "--port", "0",
]


def phase_main_path(kind, smi):
    from gpustack_tpu_torch.engine.api_server import (
        OpenAIServer,
        build_engine_from_args,
        build_parser,
    )
    from gpustack_tpu_torch.engine.engine import GenRequest

    args = build_parser().parse_args(MAIN_ARGV)
    t0 = time.perf_counter()
    engine = build_engine_from_args(args)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    engine.start()
    server = OpenAIServer(engine)
    port = server.start("127.0.0.1", 0)
    try:
        _logit_check(engine)
        reset_launch_counts()
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
        counts = launch_counts()
        health = engine.health()
        if health["status"] != "ok":
            raise AssertionError(f"engine unhealthy: {health}")
        n_layers = engine.cfg.num_layers
        if counts["flash_attention_prefill"] != n_layers * prefills:
            raise AssertionError(
                f"flash kernel launched {counts['flash_attention_prefill']} "
                f"times for {prefills} prefills (want {n_layers} each)"
            )
        metrics["prefill_ms_2048_bucket"] = _prefill_ms(engine)
        emit("main_path", model=engine.cfg.name, device=kind, nvidia_smi=smi,
             setup_s=setup_s, prefills=prefills, launches=counts,
             usage={"chat": chat_usage, "stream": stream_usage,
                    "long_completion": long_usage},
             greedy_ids=first.output_ids, **metrics,
             peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        return counts
    finally:
        server.shutdown()
        engine.stop()


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
        n_layers = engine.cfg.num_layers
        if counts["flash_attention_prefill"] != n_layers * forwards:
            raise AssertionError(
                f"flash kernel launched {counts['flash_attention_prefill']} "
                f"times for {forwards} forwards (want {n_layers} each)"
            )
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
    counts = phase_main_path(kind, smi)
    gc.collect()
    torch.cuda.empty_cache()
    e_counts = phase_prefix_reuse(kind, smi)
    kernels = []
    for name, row in rows.items():
        if counts.get(name, 0) < 1 or e_counts.get(name, 0) < 1:
            raise AssertionError(f"{name} never launched on a main path")
        kernels.append({
            "name": name, **KERNEL_META[name],
            "launches": counts[name] + e_counts[name],
            **{k: row[k] for k in (
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


if __name__ == "__main__":
    sys.exit(main())
