"""The PyTorch port stands alone: no module of the package, and not the
chip smoke script, imports JAX, the JAX package, ``ml_dtypes`` or
``safetensors`` (the card's machine has none of them); the default device is
the card and is never swapped for the CPU silently; the smoke script
fails without a card or outside a checkout."""

import ast
import os
import subprocess
import sys

import pytest
import torch

from gpustack_tpu_torch.device import resolve_device  # analysis: ignore[metrics-drift]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(ROOT, "gpustack_tpu_torch")  # analysis: ignore[metrics-drift]
FORBIDDEN = ("jax", "jaxlib", "gpustack_tpu", "ml_dtypes", "safetensors")
# modules the checkpoint slice added: they must be in the scan
CHECKPOINT_MODULES = (
    "models/quant.py", "ops/w8a16.py", "engine/gguf.py", "engine/weights.py",
)


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _dirs, files in os.walk(PACKAGE):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level == 0:
                yield node.module.split(".")[0]


def test_port_imports_nothing_of_jax():
    files = _port_files()
    assert len(files) > 10
    offenders = [
        (os.path.relpath(p, ROOT), root)
        for p in files for root in _imported_roots(p)
        if root in FORBIDDEN
    ]
    assert not offenders


def test_scan_covers_the_checkpoint_modules():
    files = {os.path.relpath(p, PACKAGE) for p in _port_files()}
    assert set(CHECKPOINT_MODULES) <= files
    assert os.path.exists(os.path.join(PACKAGE, "ops", "csrc", "w8a16_gemm.cu"))
    for rel in CHECKPOINT_MODULES:
        assert not set(_imported_roots(os.path.join(PACKAGE, rel))) & set(
            FORBIDDEN
        ), rel


# modules the speculation, embeddings and profile slice extended
SPECULATION_MODULES = (
    "engine/engine.py", "engine/runner.py", "engine/api_server.py",
    "models/transformer.py", "observability/flight.py",
)


def test_scan_covers_the_speculation_slice():
    files = {os.path.relpath(p, PACKAGE) for p in _port_files()}
    assert set(SPECULATION_MODULES) <= files
    for rel in SPECULATION_MODULES:
        assert not set(_imported_roots(os.path.join(PACKAGE, rel))) & set(
            FORBIDDEN
        ), rel
    # the profiler is torch's, reached without importing JAX's
    with open(os.path.join(PACKAGE, "engine", "engine.py")) as f:
        src = f.read()
    assert "torch.profiler" in src and "jax.profiler" not in src


def test_default_device_is_the_card_or_an_error():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
        with pytest.raises(RuntimeError):
            resolve_device("cuda")


def _run_smoke(cwd):
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd,
        capture_output=True, text=True, timeout=120,
    )


def test_smoke_script_fails_alone(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as src:
        (tmp_path / "chip_smoke.py").write_text(src.read())
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_smoke_script_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the smoke run would use it")
    proc = _run_smoke(ROOT)
    assert proc.returncode != 0
    assert proc.stdout == ""
