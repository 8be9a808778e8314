#!/usr/bin/env python3
"""One MoE layer and one 2048-bucket prefill of each one-card MoE model, in
several source trees, on one CUDA card.

    python3 hack/torch_moe_e2e_ab.py ROOT [ROOT ...]

Each ROOT is a checkout of the repository (the parent commit unpacked with
``git archive`` into a gitignored directory, say) and runs in a process of
its own, in the order given, so "parent change change parent parent
change" evens out the card's drift. Per tree, one JSON line: for
qwen3-30b-a3b, deepseek-v2-lite and gpt-oss-20b in bf16 and mixtral-8x7b
in int8, each built as the tree's ``chip_smoke.py`` builds it for phases
h, i, j and l (random weights from a seed), the median of 5 prefills of
the 2048 bucket after a warm-up (``chip_smoke._prefill_ms``, CUDA events)
and layer 0's MoE block over 2048 tokens (``chip_smoke._moe_layer_case``:
held to the routed fp32 reference, its CUDA-event ms, its profiled device
ms a call and the device's busy share).
"""

import contextlib
import json
import os
import subprocess
import sys


def one(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from gpustack_tpu_torch.engine.api_server import (
        build_engine_from_args,
        build_parser,
    )
    from gpustack_tpu_torch.ops import _build

    models = [(cs.H_ARGV, False), (cs.I_ARGV, False), (cs.J_ARGV, False),
              (cs.L_ARGV, True)]
    rows = []
    # the smoke's own JSON lines go to stderr: stdout carries one line
    with contextlib.redirect_stdout(sys.stderr):
        kind, smi = cs.phase_device()
        _build.build_all()
        for argv, int8 in models:
            engine = build_engine_from_args(build_parser().parse_args(
                argv + (["--quantization", "int8"] if int8 else [])))
            prefill_ms = cs._prefill_ms(engine)
            gen = torch.Generator(device="cuda").manual_seed(3)
            with torch.no_grad():
                layer = cs._moe_layer_case(engine.runner.params, engine.cfg,
                                           2048, gen)
            rows.append({
                "model": engine.cfg.name, "experts": layer["experts"],
                "prefill_ms_2048_bucket": prefill_ms,
                "moe_layer_ms": layer["ms"],
                "moe_layer_device_ms": layer["trace"]["device_ms_per_call"],
                "moe_layer_busy_share": layer["trace"]["device_busy_share"],
                "moe_layer_cosine": layer["cosine"],
            })
            del engine
            cs._free()
    return {"root": root, "device": kind, "nvidia_smi": smi, "models": rows}


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        print(json.dumps(one(sys.argv[2])), flush=True)
        return 0
    rc = 0
    for root in sys.argv[1:]:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", root],
            capture_output=True, text=True,
        )
        sys.stdout.write(proc.stdout)
        if proc.returncode:
            sys.stdout.write(json.dumps({
                "root": root, "rc": proc.returncode,
                "stderr": proc.stderr[-3000:]}) + "\n")
            rc = 1
        sys.stdout.flush()
    return rc


if __name__ == "__main__":
    sys.exit(main())
