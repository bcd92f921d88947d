"""Nothing under ``benchmark/`` loads JAX or the JAX package, and the
reference and the traffic generator load nothing of the port."""

import ast
import json
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "pointnav_vo_tpu"}
# the reference's backbone package and each of its files
BACKBONES = ", ".join(["benchmark.reference.backbones"] + [
    f"benchmark.reference.backbones.{p.stem}"
    for p in sorted((BENCH / "reference" / "backbones").glob("*.py")) if p.stem != "__init__"])


def _loaded_after(code: str) -> set:
    probe = (code + "\nimport sys, json\n"
             "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True,
                         text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_entries_metrics_and_reference_load_no_jax():
    metrics = sorted(p.stem for p in (BENCH / "metrics").glob("*.py"))
    code = "\n".join([
        "import importlib.util",
        "import benchmark.run, benchmark.readings, benchmark.harness, benchmark.flops",
        "import benchmark.entries.eval_step, benchmark.entries.vo_train",
        "import benchmark.reference.nets, benchmark.reference.features",
        "import benchmark.reference.geometry, benchmark.reference.vo_train",
        f"import {BACKBONES}",
        "import benchmark.traffic_gen.generate",
        "import pointnav_vo_tpu_torch.rl.eval, pointnav_vo_tpu_torch.vo.engine",
        f"for name in {metrics!r}:",
        "    spec = importlib.util.spec_from_file_location('m_' + name.replace('.', '_'),",
        "        'benchmark/metrics/' + name + '.py')",
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))",
    ])
    loaded = _loaded_after(code)
    assert not (loaded & FORBIDDEN), loaded & FORBIDDEN
    assert "pointnav_vo_tpu_torch" in loaded  # the measured program is allowed


def test_reference_and_traffic_load_nothing_of_the_port():
    loaded = _loaded_after("import benchmark.reference.nets, benchmark.reference.features, "
                           "benchmark.reference.geometry, benchmark.reference.vo_train, "
                           "benchmark.traffic_gen.generate, benchmark.weights, benchmark.flops, "
                           + BACKBONES)
    assert not (loaded & (FORBIDDEN | {"pointnav_vo_tpu_torch"})), loaded


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


def test_no_source_file_names_jax_and_the_reference_names_no_port():
    for path in BENCH.rglob("*.py"):
        names = _imports(path)
        assert not (names & FORBIDDEN), (path, names & FORBIDDEN)
        if {"reference", "traffic_gen"} & set(path.relative_to(BENCH).parts[:-1]):
            assert "pointnav_vo_tpu_torch" not in names, path
