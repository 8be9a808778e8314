#!/usr/bin/env bash
# Mutation check of chip_smoke.py's W8A16 tolerance, on a CUDA card: each
# deliberately broken copy of ops/csrc/w8a16_gemm.cu (in a copy of the
# package under a temporary directory, never in the checkout) must fail
# the check at one or more of the shapes below (a wrong barrier phase by
# failing the launch: the widening warps' bounded wait traps), and the
# unbroken copy must pass it at all of them. Run from the repository root:
#   bash hack/torch_w8a16_mutants.sh
set -euo pipefail
root=$(pwd)
work=$(mktemp -d)
trap 'rm -rf "$work"' EXIT
cp -r "$root/gpustack_tpu_torch" "$root/chip_smoke.py" "$work/"
cd "$work"
cat > check.py <<'PY'
import sys
import torch
import chip_smoke as cs
from gpustack_tpu_torch.ops import w8a16

gen = torch.Generator(device="cuda").manual_seed(0)
caught = []
# decode (GEMV, K split over a cluster), the prefill's lm_head row and a
# GEMV whose K is not split; the wgmma path at the 2048 bucket (tile width
# 256, 16 row tiles), and ragged K and N with K split over a cluster (a
# suffix of 100 tokens, a chunk with ragged N; tile width 128)
for M, K, N in [(8, 4096, 14336), (1, 4096, 128256), (8, 1024, 128256),
                (2048, 4096, 14336), (100, 4104, 4112), (512, 14336, 1040)]:
    x = torch.randn(M, K, generator=gen, device="cuda").bfloat16()
    q = torch.randint(-127, 128, (K, N), generator=gen, device="cuda",
                      dtype=torch.int8)
    s = ((0.5 + torch.rand(N, generator=gen, device="cuda"))
         * (3.0 / K ** 0.5 / 127.0)).bfloat16()
    out = w8a16.w8a16_matmul(x, q, s)
    torch.cuda.synchronize()
    try:
        err, row = cs._check_w8a16(out, x, q, s)
        print(f"  {M}x{K}x{N}: within tolerance (max |err| {err:.4g}, "
              f"row {row:.4g})")
    except AssertionError as e:
        print(f"  {M}x{K}x{N}: caught: {str(e)[-110:]}")
        caught.append((M, K, N))
sys.exit(1 if caught else 0)
PY
src=gpustack_tpu_torch/ops/csrc/w8a16_gemm.cu
cp "$src" orig.cu
python3 - <<'PY'
src = open("orig.cu").read()
mutants = {
    "gemv_drops_scale": ("BF16W ? sum : sum * __bfloat162float(s[col])",
                         "sum"),
    "cluster_drops_last_rank": ("for (int r = 0; r < ksplit; ++r)",
                                "for (int r = 0; r + 1 < ksplit; ++r)"),
    "gemv_skips_last_k_step": ("const bool k_ok = k < k_end;",
                               "const bool k_ok = k + GV_KSTEP < k_end;"),
    "wgmma_drops_scale": (
        "(out + m * ldo + n) =\n"
        "                __floats2bfloat162_rn(acc[4 * nb + 2 * h] * s0,",
        "(out + m * ldo + n) =\n"
        "                __floats2bfloat162_rn(acc[4 * nb + 2 * h],"),
    "wgmma_skips_last_k_tile": (
        "const int ktiles = min((K + MM_BK - 1) / MM_BK - kt0, ktile_chunk);",
        "const int ktiles = min((K + MM_BK - 1) / MM_BK - kt0, ktile_chunk)"
        " - (kt0 + ktile_chunk >= (K + MM_BK - 1) / MM_BK);"),
    "split_drops_last_rank": ("for (int rk = 0; rk < nsplit; ++rk)",
                              "for (int rk = 0; rk + 1 < nsplit; ++rk)"),
    "widen_drops_sign_bias": ("b[e] = v[i][e] ^ 0x80808080u;",
                              "b[e] = v[i][e];"),
    "wgmma_drops_last_m_tile_rows": (
        "if (m < m_end)\n            *reinterpret_cast",
        "if (m < m_end && blockIdx.x + 1 < gridDim.x)\n"
        "            *reinterpret_cast"),
    "loader_waits_wrong_phase": (
        "mbar_wait(bar(empty, t), phase(t) ^ 1);",
        "mbar_wait(bar(empty, t), phase(t));"),
}
for name, (a, b) in mutants.items():
    assert src.count(a) == 1, name
    open(f"{name}.cu", "w").write(src.replace(a, b))
PY
status=0
echo "== unbroken"
python3 check.py || { echo "RESULT unbroken: FAILS the check"; status=1; }
for m in gemv_drops_scale cluster_drops_last_rank gemv_skips_last_k_step \
         wgmma_drops_scale wgmma_skips_last_k_tile widen_drops_sign_bias \
         wgmma_drops_last_m_tile_rows loader_waits_wrong_phase \
         split_drops_last_rank; do
  cp "$m.cu" "$src"
  echo "== $m"
  if python3 check.py; then
    echo "RESULT $m: NOT caught"; status=1
  else
    echo "RESULT $m: caught"
  fi
done
exit $status
