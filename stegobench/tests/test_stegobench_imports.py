"""What a run loads: never JAX or the JAX package (top-level names compared
whole: ``stegotpu_torch`` begins with ``stegotpu``), and the reference
nothing of the program. Fresh interpreters, or the JAX package taken out
of sys.modules, so that nothing this test process imported counts."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = ROOT / "stegobench"


def _top_level_after(code: str) -> set[str]:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_the_harness_and_its_drivers_load_no_jax():
    code = ("import sys; sys.path.insert(0, '.')\n"
            "from pathlib import Path\n"
            "from stegobench import manifest, run, reference\n"
            "import json\n"
            "root = Path('.')\n"
            "for w in json.load(open('BENCHMARK.json'))['workloads']:\n"
            "    c = manifest.cell(root, w['name'])\n"
            "    manifest.driver(root, c.traffic['driver'])\n"
            "    [manifest.reader(root, m['name']) for m in c.end_to_end + c.per_layer]\n"
            "import stegotpu_torch.pipeline, stegotpu_torch.ops.stripe_kernel, "
            "stegotpu_torch.ops.qim\n")
    mods = _top_level_after(code)
    assert "stegotpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "stegotpu"}


def test_the_reference_loads_nothing_of_the_program():
    mods = _top_level_after("import sys; sys.path.insert(0, '.')\n"
                            "import stegobench.reference, stegobench.media")
    assert not mods & {"stegotpu_torch", "stegotpu", "jax"}


@pytest.mark.parametrize("path", sorted(p.relative_to(ROOT).as_posix()
                                        for p in BENCH_DIR.rglob("*.py")))
def test_no_source_imports_jax_or_the_jax_package(path):
    tree = ast.parse((ROOT / path).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert not names & {"jax", "jaxlib", "flax", "stegotpu"}
    if path in ("stegobench/reference.py", "stegobench/media.py",
                "stegobench/work.py", "stegobench/timeline.py") or \
            path.startswith("stegobench/steps/"):
        assert "stegotpu_torch" not in names


def test_the_forbidden_check_compares_whole_names(monkeypatch):
    from stegobench import run

    # the JAX package, where an earlier test in this process imported it,
    # is taken out of sys.modules until the test ends
    for name in [m for m in sys.modules if m.split(".")[0] == "stegotpu"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "stegotpu_torch_like", sys)
    assert "stegotpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "stegotpu.fake", sys)
    assert "stegotpu" in run.forbidden_modules()
