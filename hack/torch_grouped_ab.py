#!/usr/bin/env python3
"""The grouped expert GEMM in several source trees, on one CUDA card.

    python3 hack/torch_grouped_ab.py [--narrow] ROOT[@key=value,...] [...]

Each ROOT is a checkout of the repository (the parent commit unpacked with
``git archive`` into a gitignored directory, say) and runs in a process of
its own, in the order given, so "parent change change parent" evens out
the card's drift. ``@bm=64,bn=256`` forces those fields of the tree's
``ops.w8a16.grouped_plan`` (a tree that has one) for the whole process,
where the weight type takes them: the plan variants of one build, timed
beside each other.

Per tree, one JSON line: ptxas registers and spills of every kernel in
``w8a16_gemm.cu`` (the tree's first process, which builds it); then, each
through the tree's own ``chip_smoke._grouped_case`` (held to the fp32
plain version per segment, timed in 3 runs beside the bound, the plain
version and ``torch._grouped_mm``) at the 2048 bucket: every product of
``chip_smoke.GROUPED_PRODUCTS`` in each weight type, bf16 at
mixtral-8x7b's two shapes (the int8 products' shapes without the
widening), and qwen3-30b-a3b's gate and down with half of every token's
picks among a quarter of the experts (``skewed``; the routing is this
script's, the same in every tree); and the 2-D W8A16 kernel at llama3-8b's
w_gate and w_down (``chip_smoke._w8a16_case``). With ``--narrow``, only
the bf16 gate products at the expert widths a tensor-parallel rank holds
(``NARROW``: the widths where the plan picks 192-column units), and no
2-D kernel.
"""

import json
import os
import re
import subprocess
import sys

EXTRA = [
    # (product of GROUPED_PRODUCTS, weight type, routing)
    ("mixtral-8x7b we_gate/we_up", "bf16", "random"),
    ("mixtral-8x7b we_down", "bf16", "random"),
    ("qwen3-30b-a3b we_gate/we_up", "bf16", "skewed"),
    ("qwen3-30b-a3b we_down", "bf16", "skewed"),
]
# (label, E, top-k, K, N): a rank's gate/up shard under tp2 and tp4
NARROW = [
    ("qwen3-30b-a3b we_gate/we_up tp4", 128, 8, 2048, 192),
    ("qwen3-30b-a3b we_gate/we_up tp2", 128, 8, 2048, 384),
    ("deepseek-v2-lite we_gate/we_up tp4", 64, 6, 2048, 352),
]
DENSE = [(2048, 4096, 14336, "w_gate"), (2048, 14336, 4096, "w_down")]
KEEP = ("weight", "experts", "routing", "shape", "max_abs_err", "ms",
        "ms_runs", "plain_ms", "library_ms", "bound_ms", "bound_by", "bm",
        "bn", "units", "ctas", "waves")


def _ptxas(log: str) -> dict:
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = {"registers": int(m.group(1))}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out.setdefault(name, {})["spill_bytes"] = int(m.group(1)) + int(
                m.group(2))
    return out


def _routing(torch):
    """A seeded top-k pick of n tokens over E experts: uniform scores, or
    half of every token's picks among the first quarter ("skewed")."""

    def pick(n, E, k, routing, gen):
        scores = torch.rand(n, E, generator=gen, device="cuda")
        if routing == "skewed":
            hot = E // 4
            return torch.cat(
                [scores[:, :hot].topk(k // 2, dim=-1).indices,
                 hot + scores[:, hot:].topk(k - k // 2, dim=-1).indices], 1)
        return scores.topk(k, dim=-1).indices

    return pick


def one(spec: str, narrow: bool = False) -> dict:
    root, _, forced = spec.partition("@")
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from gpustack_tpu_torch.ops import _build, w8a16

    built = os.path.exists(_build.library_path("w8a16_gemm"))
    report = {"root": root, "forced": forced, "kernels": {} if built else
              _ptxas(_build.build_all(["w8a16_gemm"], ptxas=True)[
                  "w8a16_gemm"])}
    if forced:
        fields = dict(kv.split("=") for kv in forced.split(","))
        base = w8a16.grouped_plan

        def plan(P, E, N, sms, int8):
            # a field the weight type cannot take (int8: 64-row units, BN
            # 192) keeps the tree's value
            bm, bn, grid = base(P, E, N, sms, int8)
            bm = bm if int8 else int(fields.get("bm", bm))
            want = int(fields.get("bn", bn))
            bn = want if want in w8a16.GROUPED_BN[
                "int8" if int8 else "bf16"] else bn
            worst = (-(-P // bm) + min(E, P)) * -(-N // bn)
            return bm, bn, max(1, min(sms, worst))

        w8a16.grouped_plan = plan
    cs._grouped_routing = _routing(torch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    served = [(weight, wtype, "random")
              for weight, (*_, types) in cs.GROUPED_PRODUCTS.items()
              for wtype in types] + EXTRA
    cases = ([(*shape, "bf16", "random") for shape in NARROW] if narrow
             else [(weight, *cs.GROUPED_PRODUCTS[weight][:4], wtype, routing)
                   for weight, wtype, routing in served])
    rows = []
    for weight, E, k, K, N, wtype, routing in cases:
        row = cs._grouped_case(2048, E, k, K, N, weight, wtype, gen,
                               routing=routing, repeats=3)
        rows.append({key: row[key] for key in KEEP if key in row})
        cs._free()
    report["grouped"] = rows
    report["dense"] = [] if narrow else [
        {key: row[key] for key in ("weight", "shape", "ms", "ms_runs")}
        for row in (cs._w8a16_case(M, K, N, weight, gen, repeats=3)
                    for M, K, N, weight in DENSE)
    ]
    return report


def main() -> int:
    args = sys.argv[1:]
    narrow = args[:1] == ["--narrow"]
    args = args[narrow:]
    if len(args) > 1 and args[0] == "--one":
        print(json.dumps(one(args[1], narrow)), flush=True)
        return 0
    rc = 0
    for spec in args:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__),
             *(["--narrow"] if narrow else []), "--one", spec],
            capture_output=True, text=True,
        )
        sys.stdout.write(proc.stdout)
        if proc.returncode:
            sys.stdout.write(json.dumps({
                "root": spec, "rc": proc.returncode,
                "stderr": proc.stderr[-3000:]}) + "\n")
            rc = 1
        sys.stdout.flush()
    return rc


if __name__ == "__main__":
    sys.exit(main())
