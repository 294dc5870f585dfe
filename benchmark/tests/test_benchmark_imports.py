"""Nothing the benchmark runs on the card loads JAX or the JAX package, and
the reference loads nothing of the program. Each check runs in a fresh
interpreter and compares top-level module names whole: quantpy_tpu_torch
is not quantpy_tpu."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from .conftest import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "quantpy_tpu"}


def loaded_after(imports: list) -> set:
    code = "; ".join(f"import {m}" for m in imports) + (
        "; import sys, json; print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def modules(sub: str) -> list:
    return [f"benchmark.{sub}.{p.stem}" for p in sorted((REPO / "benchmark" / sub).glob("*.py"))
            if p.stem != "__init__"]


def test_no_jax_in_what_runs_on_the_card():
    imports = ["quantpy_tpu_torch", "benchmark.run", "benchmark.harness", "benchmark.trace",
               "benchmark.calibrate", *modules("entries"), *modules("metrics"),
               *modules("reference")]
    loaded = loaded_after(imports)
    assert "quantpy_tpu_torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    loaded = loaded_after(modules("reference"))
    assert not loaded & (FORBIDDEN | {"quantpy_tpu_torch"})
    for path in (REPO / "benchmark" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            assert not {n.split(".", 1)[0] for n in names} & (FORBIDDEN | {"quantpy_tpu_torch"}), path
