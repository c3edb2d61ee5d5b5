"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program: a scan of the imports of every
module under benchmark/ (top-level names compared whole: the port's name
begins with the JAX package's), and a whole run in a fresh process whose
sys.modules is read afterwards."""

import ast
import os
import subprocess
import sys

from benchmark import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "gemini_seal_tpu"}


def _imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _sources(folder):
    for dirpath, _, files in os.walk(folder):
        if os.sep + "tests" in dirpath:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_module_of_the_harness_imports_jax():
    for path in _sources(spec.HERE):
        bad = set(_imports(path)) & FORBIDDEN
        assert not bad, (path, bad)


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources(os.path.join(spec.HERE, "reference")):
        names = set(_imports(path))
        assert not names & (FORBIDDEN | {"gemini_seal_tpu_torch"}), (path, names)
        assert names <= {"__future__", "math", "functools", "torch", "numpy"}, (path, names)


def test_a_run_loads_no_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark import harness\n"
        "from benchmark.tests.small import overrides\n"
        "c = 'bfv8k.rotate_many8'\n"
        "r = harness.run(c, 7, 0.1, True, device='cpu', overrides=overrides(c))\n"
        "from benchmark.run import forbidden_modules\n"
        "print(r['correct'], forbidden_modules())\n" % spec.ROOT)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, cwd=spec.ROOT, env=env)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "True []"
