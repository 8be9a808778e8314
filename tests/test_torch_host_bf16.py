"""The port's host-side bfloat16 helpers against ``ml_dtypes``.

The port keeps bf16 K/V on the host as ``uint16`` bit patterns and never
imports ``ml_dtypes``; this test does, as the reference: widening must be
exact and narrowing must round to nearest even bit for bit, NaN, ±inf,
±0 and subnormals included.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from gpustack_tpu_torch.engine import host_bf16  # analysis: ignore[metrics-drift]

SPECIALS = np.array(
    [0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan,
     1e-45, -1e-45, 1.17e-38, -1.17e-38, 9.2e-41,   # float32 subnormals
     3.3895e38, -3.3895e38, 3.4e38, 1.0, -1.0],
    np.float32,
)
# NaNs with payloads, and values exactly halfway between two bf16 values
# (ties: to the even neighbour)
ODD_BITS = np.array(
    [0x7F800001, 0xFF800001, 0x7FBFFFFF, 0x7FFFFFFF, 0xFFC00000,
     0x3F808000, 0x3F818000, 0xBF808000, 0x00008000, 0x00018000,
     0x7F7F8000],
    np.uint32,
).view(np.float32)


def _random_f32(seed):
    rng = np.random.default_rng(seed)
    normal = (
        rng.standard_normal(50_000)
        * np.exp2(rng.uniform(-140, 120, 50_000))
    ).astype(np.float32)
    bits = rng.integers(0, 2**32, 50_000, dtype=np.uint64)
    return np.concatenate([normal, bits.astype(np.uint32).view(np.float32)])


@pytest.mark.parametrize("values", ["random", "specials", "odd_bits"])
def test_f32_to_bf16_bits_matches_ml_dtypes(values):
    x = {
        "random": _random_f32(0), "specials": SPECIALS, "odd_bits": ODD_BITS,
    }[values]
    with np.errstate(over="ignore", invalid="ignore"):
        want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    got = host_bf16.f32_to_bf16_bits(x)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, want)


def test_bf16_bits_to_f32_is_exact():
    bits = np.arange(2**16, dtype=np.uint16)    # every bf16 value
    want = bits.view(ml_dtypes.bfloat16).astype(np.float32)
    got = host_bf16.bf16_bits_to_f32(bits)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_tensor_round_trip_keeps_the_bits():
    t = torch.randn(3, 5, 2, 4).bfloat16()
    arr = host_bf16.to_numpy(t)
    assert arr.dtype == np.uint16 and host_bf16.is_bf16(arr.dtype)
    want = t.float().numpy().astype(ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(arr, want)
    back = host_bf16.from_numpy(arr)
    assert back.dtype == torch.bfloat16
    assert torch.equal(back, t)
    f = torch.randn(4, 3)
    assert torch.equal(host_bf16.from_numpy(host_bf16.to_numpy(f)), f)
