"""The run's own guards: JAX and the JAX package are found by whole
top-level names, and a run without the cards it asks for prints no
result."""

import os
import shutil
import subprocess
import sys

import pytest

from benchmark import harness


def test_forbidden_modules_compare_whole_top_level_names():
    mods = ["kasa_tpu", "kasa_tpu.match.fast", "kasa_tpu_torch",
            "kasa_tpu_torch.match.fast", "jax", "jax.numpy", "jaxlib.xla",
            "flax.linen", "numpy", "jaxtyping", "kasa_tpux"]
    assert harness.forbidden_modules(mods) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla", "kasa_tpu",
        "kasa_tpu.match.fast"]


def test_the_benchmark_imports_no_jax():
    code = ("import sys; sys.path.insert(0, %r);"
            "import benchmark.run, benchmark.runner, benchmark.harness, "
            "benchmark.reference, benchmark.compare, benchmark.devtrace, "
            "benchmark.calibrate;"
            "from benchmark import harness;"
            "import kasa_tpu_torch.match.fast, kasa_tpu_torch.match.turbo;"
            "print(harness.forbidden_modules())" % harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]"


@pytest.fixture
def no_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def _run(cwd):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "dense2k.long_e",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True)


def test_no_card_no_result(no_card):
    p = _run(harness.ROOT)
    assert p.returncode != 0 and p.stdout == ""


def test_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    p = _run(str(tmp_path))
    assert p.returncode != 0 and p.stdout == ""
