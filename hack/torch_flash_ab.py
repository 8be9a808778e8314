#!/usr/bin/env python3
"""The flash-prefill kernel of several source trees, on one CUDA card.

    python3 hack/torch_flash_ab.py ROOT [ROOT ...]

Each ROOT is a checkout of the repository (the parent commit unpacked with
``git archive`` into a gitignored directory, say); each runs in a process of
its own, in the order given, so "parent change change parent" evens out the
card's drift. Per tree, one JSON line: the kernel's ptxas registers and
spills per head dim, then at T = S = 2048 for each head dim the tree takes
(llama3-8b's heads at d 128, the same at d 64, deepseek-v2-lite's 16 heads
at d 192) the median of five CUDA-event times over 20 calls each, beside
the bound (operations: 4·d·Hq·pairs at 989 TFLOP/s). Each result is first
held to the fp32 plain version (|err| <= 2e-2 + 2e-2·|ref|).
"""

import json
import os
import subprocess
import sys

SHAPES = [(32, 8, 128), (32, 8, 64), (16, 16, 192)]   # (Hq, Hkv, d)
T = 2048
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16

CHILD = r"""
import json, re, statistics, sys
import torch
sys.path.insert(0, ".")
from gpustack_tpu_torch.ops import _build
from gpustack_tpu_torch.ops import flash_attention as fa

log = _build.build_all(["flash_attention"], ptxas=True)["flash_attention"]
ptxas, name = {}, None
for line in log.splitlines():
    m = re.search(r"flash_prefill_kernelILi(\d+)E", line)
    if m:
        name = m.group(1)
    m = re.search(r"(\d+) bytes spill stores", line)
    if m and name:
        ptxas.setdefault(name, {})["spill_stores"] = int(m.group(1))
    m = re.search(r"Used (\d+) registers", line)
    if m and name:
        ptxas.setdefault(name, {})["registers"] = int(m.group(1))
out = {"root": sys.argv[1], "ptxas": ptxas, "serialized": "serialized" in log,
       "cases": []}
gen = torch.Generator(device="cuda").manual_seed(0)
for hq, hkv, d in json.loads(sys.argv[2]):
    if d not in fa.SUPPORTED_HEAD_DIMS:
        continue
    T = int(sys.argv[3])
    q = torch.randn(1, T, hq, d, generator=gen, device="cuda").bfloat16()
    k = torch.randn(1, T, hkv, d, generator=gen, device="cuda").bfloat16()
    v = torch.randn(1, T, hkv, d, generator=gen, device="cuda").bfloat16()
    scale = d ** -0.5
    got = fa.flash_attention_prefill(q, k, v, scale).float()
    ref = fa.flash_attention_prefill_ref(q.float(), k.float(), v.float(),
                                         scale)
    if not ((got - ref).abs() <= 2e-2 + 2e-2 * ref.abs()).all():
        raise AssertionError(f"d {d}: the kernel disagrees with plain")
    runs = []
    for _ in range(5):
        for _ in range(3):
            fa.flash_attention_prefill(q, k, v, scale)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(20):
            fa.flash_attention_prefill(q, k, v, scale)
        b.record()
        torch.cuda.synchronize()
        runs.append(a.elapsed_time(b) / 20)
    out["cases"].append({"Hq": hq, "Hkv": hkv, "d": d,
                         "ms": statistics.median(runs), "ms_runs": runs})
print(json.dumps(out))
"""


def main() -> int:
    roots = sys.argv[1:]
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(json.dumps({"nvidia_smi": smi}), flush=True)
    for root in roots:
        proc = subprocess.run(
            [sys.executable, "-c", CHILD, root, json.dumps(SHAPES), str(T)],
            cwd=os.path.abspath(root), capture_output=True, text=True,
        )
        if proc.returncode != 0:
            print(proc.stderr[-3000:], file=sys.stderr)
            return proc.returncode
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        for case in row["cases"]:
            pairs = T * (T + 1) // 2
            case["bound_ms"] = (
                4 * case["d"] * case["Hq"] * pairs / PEAK_BF16_FLOPS * 1e3
            )
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
