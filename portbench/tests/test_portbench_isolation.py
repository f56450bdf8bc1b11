"""Nothing the benchmark runs loads JAX or the JAX package."""

from __future__ import annotations

import ast
import subprocess
import sys

from conftest import ROOT
from portbench.harness import isolation

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "bert4clickpath_tpu"}


def test_top_level_names_are_compared_whole():
    assert isolation.forbidden_modules(["bert4clickpath_torch.ops", "jaxtyping", "numpy"]) == []
    assert isolation.forbidden_modules(["jax.numpy", "bert4clickpath_tpu.ops"]) == ["bert4clickpath_tpu", "jax"]


def test_importing_every_file_of_the_harness_loads_no_jax():
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
import runpy
from pathlib import Path
from portbench.harness import manifest, isolation
root = Path({str(ROOT)!r}) / "portbench"
for path in sorted(root.rglob("*.py")):
    if "tests" in path.parts or path.name == "__init__.py":
        continue
    if path.name in ("run.py", "calibrate.py"):
        runpy.run_path(str(path), run_name="not_main")
    else:
        manifest.load_module(path)
print(",".join(isolation.forbidden_modules()) or "clean")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "clean"


def test_no_file_imports_jax_or_reads_the_jax_benchmarks():
    for path in (ROOT / "portbench").rglob("*.py"):
        if "tests" in path.parts:
            continue
        source = path.read_text()
        for node in ast.walk(ast.parse(source)):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                tops = [(node.module or "").split(".")[0]]
            else:
                continue
            assert not set(tops) & FORBIDDEN, (path.name, tops)
        assert "bench.py" not in source and "benchmarks/" not in source, path.name
