#!/usr/bin/env bash
# Mutation check of chip_smoke.py's W8A16 tolerance, on a CUDA card: each
# deliberately broken copy of ops/csrc/w8a16_gemm.cu (in a copy of the
# package under a temporary directory, never in the checkout) must fail
# the check at one or more of the shapes below, and the unbroken copy must
# pass it at all of them. Run from the repository root:
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
# GEMV whose K is not split, prefill (mma.sync) and ragged K and N
for M, K, N in [(8, 4096, 14336), (1, 4096, 128256), (8, 1024, 128256),
                (2048, 4096, 14336), (100, 4104, 4112)]:
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
    "gemv_drops_scale": ("__float2bfloat16(sum * __bfloat162float(s[col]))",
                         "__float2bfloat16(sum)"),
    "cluster_drops_last_rank": ("for (int r = 0; r < ksplit; ++r)",
                                "for (int r = 0; r + 1 < ksplit; ++r)"),
    "gemv_skips_last_k_step": ("const bool k_ok = k < k_end;",
                               "const bool k_ok = k + GV_KSTEP < k_end;"),
    "mma_skips_last_k_tile": ("for (int kt = 0; kt < ktiles; ++kt) {",
                              "for (int kt = 0; kt < ktiles - 1; ++kt) {"),
    "mma_drops_scale": ("acc[i][j][2 * h] * s0", "acc[i][j][2 * h]"),
}
for name, (a, b) in mutants.items():
    assert src.count(a) == 1, name
    open(f"{name}.cu", "w").write(src.replace(a, b))
PY
status=0
echo "== unbroken"
python3 check.py || { echo "RESULT unbroken: FAILS the check"; status=1; }
for m in gemv_drops_scale cluster_drops_last_rank gemv_skips_last_k_step \
         mma_skips_last_k_tile mma_drops_scale; do
  cp "$m.cu" "$src"
  echo "== $m"
  if python3 check.py; then
    echo "RESULT $m: NOT caught"; status=1
  else
    echo "RESULT $m: caught"
  fi
done
exit $status
