"""Nothing the benchmark runs imports JAX or the JAX package, and the frozen
reference imports nothing of the program either. Top-level module names are
compared whole: vits_tpu_torch begins with vits_tpu."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

from benchmark.harness.common import BENCH, FORBIDDEN, ROOT


def _modules(path):
    names = set()
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _sources(sub=""):
    base = os.path.join(BENCH, sub)
    for root, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_no_benchmark_module_imports_jax_or_the_jax_package():
    for path in _sources():
        bad = _modules(path) & set(FORBIDDEN)
        assert not bad, f"{path} imports {bad}"


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        bad = _modules(path) & {"vits_tpu_torch", *FORBIDDEN}
        assert not bad, f"{path} imports {bad}"


def test_top_level_names_are_compared_whole():
    from benchmark.harness import common
    saved = dict(sys.modules)
    try:
        sys.modules["vits_tpu_torch_fake"] = sys
        assert "vits_tpu" not in common.forbidden_modules()
        sys.modules["vits_tpu.sub"] = sys
        assert "vits_tpu" in common.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_a_run_imports_no_jax_and_needs_a_card():
    """The whole entry, as the driver starts it, in a fresh process: here,
    without a card, it exits non-zero with no result line, and it has
    imported the program's serving stack without JAX."""
    code = ("import runpy, sys\n"
            "sys.argv = ['run.py', '--workload', 'base-serve-b1', '--seed', '2147483653',"
            " '--seconds', '1', '--trace', '0']\n"
            "try:\n    runpy.run_path('benchmark/run.py', run_name='__main__')\n"
            "except SystemExit as e:\n    print('EXIT', e.code)\n"
            "import vits_tpu_torch.infer, vits_tpu_torch.train.step\n"
            "print('LOADED', sorted({m.split('.')[0] for m in sys.modules} & "
            f"{set(FORBIDDEN)!r}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    lines = out.stdout.strip().splitlines()
    assert "EXIT 2" in lines, out.stdout + out.stderr
    assert "LOADED []" in lines, out.stdout + out.stderr
    assert not any(ln.startswith("{") for ln in lines)
