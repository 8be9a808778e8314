#!/usr/bin/env python3
"""The W8A16 kernel's two paths in several source trees, on one CUDA card.

    python3 hack/torch_w8a16_ab.py ROOT [ROOT ...]

Each ROOT is a checkout of the repository (the parent commit unpacked with
``git archive`` into a gitignored directory, say); each runs in a process of
its own, in the order given, so "parent change change parent" evens out the
card's drift. Per tree, one JSON line: each W8A16 kernel's ptxas registers
and static shared memory (for the 8-warp GEMV also the CTAs per SM those
allow: 64 K registers and 228 KB of shared memory per SM), then at
llama3-8b's decode shapes (the GEMV) and at the 64 and 2048 buckets and
the 512-token chunk (the large-M path) the device time per call (CUDA events,
weights rotated over copies larger than L2), the bound (bytes or
operations, whichever is larger), the rate that time implies, and a
``torch.profiler`` split of the call into its kernels; at the large-M
shapes also cuBLAS on the weight dequantized to bf16 ahead of time. Each
result is first held to the fp32 plain version.
"""

import json
import os
import re
import subprocess
import sys

# M x K x N (weight) at llama3-8b: decode with 8 slots, the prefill's
# lm_head row, and M = 16, the most the GEMV takes; then a 64-token bucket
# (K split over a cluster), a 512-token chunk and the 2048 bucket
SHAPES = [
    (8, 4096, 14336, "w_gate"), (8, 4096, 4096, "wq"), (8, 4096, 1024, "wk"),
    (8, 14336, 4096, "w_down"), (8, 4096, 128256, "lm_head"),
    (1, 4096, 128256, "lm_head_m1"), (16, 4096, 14336, "w_gate_m16"),
    (64, 14336, 4096, "w_down_m64"), (64, 4096, 4096, "wq_m64"),
    (512, 4096, 14336, "w_gate_m512"), (512, 14336, 4096, "w_down_m512"),
    (512, 4096, 4096, "wq_m512"),
    (2048, 4096, 14336, "w_gate_m2048"), (2048, 14336, 4096, "w_down_m2048"),
    (2048, 4096, 4096, "wq_m2048"), (2048, 4096, 1024, "wk_m2048"),
]
L2_FLUSH_BYTES = 128 * 2**20
PEAK_BYTES_S = 3.35e12        # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16


def _ctas_per_sm(regs: int, smem: int, threads: int = 256) -> int:
    warps = threads // 32
    per_warp = -(-regs * 32 // 256) * 256      # allocated per warp, 256 apart
    by_regs = (65536 // per_warp) // warps
    by_smem = (228 * 1024) // (smem + 1024) if smem else 32  # 1 KB reserved
    return min(by_regs, by_smem, 2048 // threads)


def _ptxas(log: str) -> dict:
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(w8a16_[a-z]+)(ILi(\d+)E)?", m.group(1))
            name = m.group(1) if not k else (
                f"{k.group(1)}<{k.group(3)}>" if k.group(3) else k.group(1))
            continue
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
        if m and name:
            regs, smem = int(m.group(1)), int(m.group(2))
            out[name] = {"registers": regs, "smem_bytes": smem}
            if "gemv" in name:
                out[name]["ctas_per_sm"] = _ctas_per_sm(regs, smem)
    return out


def _events_ms(fn, iters: int = 20) -> float:
    import torch

    for i in range(3):
        fn(i)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def one(root: str) -> dict:
    sys.path.insert(0, root)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gpustack_tpu_torch.ops import _build, w8a16

    report = {"root": root, "kernels": _ptxas(
        _build.build_all(["w8a16_gemm"], ptxas=True)["w8a16_gemm"])}
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for M, K, N, weight in SHAPES:
        x = torch.randn(M, K, generator=gen, device="cuda").bfloat16()
        q = torch.randint(-127, 128, (K, N), generator=gen, device="cuda",
                          dtype=torch.int8)
        s = ((0.5 + torch.rand(N, generator=gen, device="cuda"))
             * (3.0 / K ** 0.5 / 127.0)).bfloat16()
        out = w8a16.w8a16_matmul(x, q, s).float()
        ref = w8a16.w8a16_plain(x.float(), q, s)
        err = (out - ref).abs()
        if not (err <= 2e-2 + 2e-2 * ref.abs()).all():
            raise AssertionError(f"{weight}: max |err| {err.max().item()}")
        copies = -(-L2_FLUSH_BYTES // (K * N))
        qs = [q] + [q.clone() for _ in range(copies - 1)]
        state = {"i": 0}

        def call():
            state["i"] += 1
            return w8a16.w8a16_matmul(x, qs[state["i"] % len(qs)], s)

        for _ in range(3):
            call()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        runs = []
        for _ in range(3):
            start.record()
            for _ in range(20):
                call()
            end.record()
            torch.cuda.synchronize()
            runs.append(start.elapsed_time(end) / 20)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                call()
            torch.cuda.synchronize()
        split = {}
        for e in prof.key_averages():
            t = getattr(e, "device_time_total", None)
            if t is None:
                t = getattr(e, "cuda_time_total", 0)
            k = re.search(r"w8a16_\w+(<\d+>)?", e.key)
            if t and k:
                split[k.group(0)] = t / 10 / 1e3
        nbytes = M * K * 2 + K * N + N * 2 + M * N * 2
        flops = 2 * M * K * N
        ms = sorted(runs)[1]
        row = {
            "weight": weight, "M": M, "K": K, "N": N, "ms_runs": runs,
            "bound_ms": max(nbytes / PEAK_BYTES_S, flops / PEAK_BF16_FLOPS)
            * 1e3,
            "dram_gbytes_per_s": nbytes / ms / 1e6,
            "tflops": flops / ms / 1e9,
            "profiler_ms_per_call": split or "no device time in the trace",
            "max_abs_err": err.max().item(),
        }
        if M > 16:
            ws = [(qi.float() * s.float()).bfloat16() for qi in qs]
            row["cublas_bf16_dequantized_ms"] = _events_ms(
                lambda i: torch.matmul(x, ws[i % len(ws)]))
            del ws
        rows.append(row)
        del qs
    report["shapes"] = rows
    return report


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        print(json.dumps(one(os.path.abspath(sys.argv[2]))), flush=True)
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    print(json.dumps({"nvidia_smi": smi}), flush=True)
    rc = 0
    for root in sys.argv[1:]:
        rc |= subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", root]
        ).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
