"""The harness as a later PR meets it: a new traffic file plus a
``BENCHMARK.json`` entry (and the new cell's limits file) is a runnable
cell with no existing file edited; a run with no card, or in a checkout
that holds only the benchmark, exits non-zero with no result; JAX in
``sys.modules`` is caught by whole top-level names."""

import json
import os
import shutil
import subprocess
import sys
import types

from benchmark import harness
from benchmark.tests._tiny import ROOT


def _copy(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")


def test_a_new_traffic_file_and_entry_make_a_runnable_cell(tmp_path):
    _copy(tmp_path)
    traffic = json.loads((ROOT / "benchmark/traffic/eval32.json").read_text())
    traffic.update(envs=8, why="eight envs")
    (tmp_path / "benchmark/traffic/eval8.json").write_text(json.dumps(traffic))
    shutil.copy(ROOT / "benchmark/limits/pnvo-rn18.eval32.json",
                tmp_path / "benchmark/limits/pnvo-rn18.eval8.json")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "pnvo-rn18.eval8", "config": "pnvo-rn18",
                               "traffic": "eval8", "chips": 1, "why": "eight envs"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "pnvo-rn18.eval32" in m.get("workloads", []):
            m["workloads"].append("pnvo-rn18.eval8")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import torch; torch.set_num_threads(2)\n"
            "from benchmark.tests._tiny import tiny_ctx\n"
            "from benchmark.entries import eval_step\n"
            "ctx = tiny_ctx('pnvo-rn18.eval8')\n"
            "ctx.traffic['envs'] = 8\n"
            "res = eval_step.run(ctx)\n"
            "print(ctx.traffic['envs'], all(c['ok'] for c in res['checks'].values()))\n")
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "8 True"


def _run(cwd, env):
    return subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                           "pnvo-rn18.eval32", "--seed", "2147483701", "--seconds", "1",
                           "--trace", "0"], cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_no_card_means_no_result():
    out = _run(ROOT, dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and not out.stdout.strip()


def test_a_checkout_of_only_the_benchmark_gives_no_result(tmp_path):
    _copy(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = _run(tmp_path, env)
    assert out.returncode != 0 and not out.stdout.strip()


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "pointnav_vo_tpu_torch_like", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert harness.forbidden_modules() == ["jax"]
