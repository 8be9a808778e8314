#!/usr/bin/env python3
"""What the W8A16 large-M kernel's parts cost, on one CUDA card.

    python3 hack/torch_w8a16_variants.py

Times the checkout's W8A16 kernel at llama3-8b's prefill shapes beside two
variants built from copies of the package in a temporary directory (never
in the checkout):

- ``nowiden``: the widening warps skip the widening and only arrive on the
  barrier, so the products read whatever the weight slot holds. Its results
  are wrong and not checked; its time is the ring, TMA and ``wgmma``
  without the int8-to-bf16 step, and the difference is what widening
  costs.
- ``bn128``: ``wgmma_plan`` always picks tiles 128 columns wide, for the
  width choice at shapes where it picks 256.

Each tree runs in a process of its own, in turns (checkout, nowiden,
bn128, checkout), and prints one JSON line: CUDA-event ms per call at each
shape, weights rotated over three copies.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile

SHAPES = [(2048, 4096, 14336), (2048, 14336, 4096), (512, 4096, 14336)]
VARIANTS = {
    "nowiden": ("ops/csrc/w8a16_gemm.cu",
                "widen_tile<BN>(st + L::x, threadIdx.x);", ""),
    "bn128": ("ops/w8a16.py", "bn = 256 if grid_m", "bn = 128 if grid_m"),
}


def one(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    from gpustack_tpu_torch.ops import w8a16

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"root": root}
    for M, K, N in SHAPES:
        x = torch.randn(M, K, generator=gen, device="cuda").bfloat16()
        qs = [torch.randint(-127, 128, (K, N), generator=gen, device="cuda",
                            dtype=torch.int8) for _ in range(3)]
        s = torch.rand(N, generator=gen, device="cuda").bfloat16()
        for i in range(3):
            w8a16.w8a16_matmul(x, qs[i % 3], s)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for i in range(30):
            w8a16.w8a16_matmul(x, qs[i % 3], s)
        end.record()
        torch.cuda.synchronize()
        out[f"{M}x{K}x{N}"] = start.elapsed_time(end) / 30
    return out


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        print(json.dumps(one(os.path.abspath(sys.argv[2]))), flush=True)
        return 0
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    print(json.dumps({"nvidia_smi": smi}), flush=True)
    with tempfile.TemporaryDirectory(prefix="w8a16-variants-") as work:
        roots = {}
        for name, (path, old, new) in VARIANTS.items():
            root = os.path.join(work, name)
            shutil.copytree(os.path.join(here, "gpustack_tpu_torch"),
                            os.path.join(root, "gpustack_tpu_torch"),
                            ignore=shutil.ignore_patterns("__pycache__"))
            target = os.path.join(root, "gpustack_tpu_torch", path)
            with open(target) as f:
                text = f.read()
            if text.count(old) != 1:
                raise SystemExit(f"{name}: {old!r} not found once in {path}")
            with open(target, "w") as f:
                f.write(text.replace(old, new))
            roots[name] = root
        rc = 0
        for root in (here, roots["nowiden"], roots["bn128"], here):
            rc |= subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--one", root]
            ).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
