"""Nothing the benchmark runs loads JAX or the JAX package ``repro``
(top-level names compared whole: the port's ``repro_torch`` begins with
``repro``), and the references load nothing of the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not set(_imports(path)) & FORBIDDEN
    if "reference" in path.parts:
        assert not {"repro_torch"} & set(_imports(path))
        assert all(m in ("torch", "math", "typing", "bench", "__future__") for m in _imports(path))


def test_a_dry_pass_loads_no_jax(tmp_path):
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "from bench.tests.tiny import tiny_ctx\n"
        "from bench import run\n"
        "for wl in ('hymba-1.5b.train', 'mixtral-8x22b.decode'):\n"
        "    run.run_cell(tiny_ctx(wl, 7), 0.2, False, device='cpu')\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=240,
                         cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded and not loaded & FORBIDDEN
