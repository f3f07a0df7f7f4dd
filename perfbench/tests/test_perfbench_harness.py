"""The harness on the CPU at a tiny size: every cell of BENCHMARK.json end
to end, the result line, BENCHMARK.json against the contract, a cell of a
new kind added from files and entries alone, and the JAX checks."""
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from perfbench import harness
from perfbench.harness import ROOT
from perfbench.tests.tiny import cells, cells_of_kind, set_traffic, tiny_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def runs_and_reports(root, cell):
    """Run ``cell`` of ``<root>/BENCHMARK.json`` traced for 2 s, long
    enough for the vets a check needs, and hold both result lines to the
    contract; returns the run and the traced line."""
    c = harness.load_cell(cell, root)
    run, checks, info, breakdown, drv = harness.run_cell(c, 2 ** 31 + 5, 2.0,
                                                         True, device="cpu")
    assert drv.attempted > 0 and drv.failed == 0
    traced = harness.result_line(run, checks, info, breakdown, drv, True)
    assert list(traced)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(traced)[-1] == "checks"
    # a CPU trace has no device time for a roofline to divide
    assert {m["name"] for m in c.per_layer if "_roofline" not in m["name"]} \
        <= set(traced["metrics"]) <= {m["name"] for m in c.per_layer}
    assert {"busy_s", "window_s"} <= set(traced["device"])
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}
    plain = harness.result_line(run, checks, info, None, drv, False)
    assert set(plain["metrics"]) == {m["name"] for m in c.end_to_end}
    assert "setup_s" in plain["metrics"] and len(plain["metrics"]) >= 2
    assert all(v > 0 for v in (m["value"] for m in plain["metrics"].values()))
    json.dumps(traced)
    return run, traced


@pytest.mark.parametrize("cell", cells())
def test_every_cell_runs_and_reports(tmp_path, cell):
    runs_and_reports(tiny_root(str(tmp_path)), cell)


NEW_KIND = """\
import os

from perfbench.drivers import load_kind

_root = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_sweep = load_kind(_root, "sweep")


class Driver(_sweep.Driver):
    def step(self):
        super().step()
        self.count("new_kind_steps", 1)


control = _sweep.control
"""


def test_a_traffic_kind_is_added_as_a_file(tmp_path):
    """A new kind is a file ``perfbench/kinds/<kind>.py`` under the root:
    its driver runs the cell and its control stands in for the limits;
    a kind with no file raises."""
    from perfbench import limits
    root = tiny_root(str(tmp_path))
    with open(os.path.join(root, "perfbench", "kinds", "counted.py"),
              "w") as f:
        f.write(NEW_KIND)
    name = cells_of_kind("sweep")[0]
    set_traffic(root, name, kind="counted")
    cell = harness.load_cell(name, root)
    run, checks, *_ = harness.run_cell(cell, 5, 0.0, False, device="cpu")
    assert run.counters["new_kind_steps"] >= 1
    assert all(v <= lim for _, v, lim in checks), checks
    control = limits.control_checks(cell, 5, device="cpu")
    assert [n for n, _, _ in control] == [n for n, _, _ in checks]
    set_traffic(root, name, kind="no_such_kind")
    with pytest.raises(ValueError, match="no_such_kind"):
        harness.run_cell(harness.load_cell(name, root), 5, 0.0, False,
                         device="cpu")
    with pytest.raises(ValueError, match="no_such_kind"):
        limits.control_checks(harness.load_cell(name, root), 5,
                              device="cpu")


def check_contract(b, root):
    """Hold the BENCHMARK.json ``b`` to the benchmark's contract, each file
    it names looked up under ``root``.  No cell is known by name: a cell is
    well formed by its entries and its files."""
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["perfbench"] and 1 <= b["run_seconds"] <= 51
    assert len(b["command"]) <= 32
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    configs = [c["name"] for c in b["configs"]]
    names = [w["name"] for w in b["workloads"]]
    metrics = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    for unique in (configs, names, metrics, pairs):
        assert len(set(unique)) == len(unique), unique
    assert 1 <= len(names) <= 24
    cells = set(names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and len(c["source"]) <= 200
        assert any(w["config"] == c["name"] for w in b["workloads"])
        assert c["file"].startswith("perfbench/")
        with open(os.path.join(root, c["file"])) as f:
            cfg = json.load(f)
        assert all(k in cfg for k in c["reduced"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs
        with open(os.path.join(root, "perfbench", "workloads",
                               w["name"] + ".json")) as f:
            kind = json.load(f)["kind"]
        assert os.path.exists(os.path.join(root, "perfbench", "kinds",
                                           kind + ".py"))
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert os.path.exists(os.path.join(root, "perfbench", "metrics",
                                           m["name"] + ".py"))
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", cells)
        if "_roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:
        reports = [n for n, m in e2e.items()
                   if cell in m.get("workloads", cells)]
        assert "setup_s" in reports and len(reports) >= 2
        assert any(cell in m["workloads"] for m in b["per_layer"])


def test_benchmark_json_keeps_the_contract():
    check_contract(_bench(), ROOT)


def _tree_digest(root):
    h = hashlib.sha256()
    for dirpath, dirs, files in sorted(os.walk(root)):
        dirs[:] = sorted(d for d in dirs if d not in ("_data",
                                                      "__pycache__"))
        for f in sorted(files):
            with open(os.path.join(dirpath, f), "rb") as fh:
                h.update(f.encode() + fh.read())
    return h.hexdigest()


def test_a_configuration_cell_and_metric_are_added_as_files(tmp_path):
    """A new configuration, a cell of a new traffic kind with its traffic
    file, and a per-layer metric need new files and BENCHMARK.json entries
    only: the contract and the every-cell run take them with the cells
    already there, and no file of the package changes."""
    before = _tree_digest(os.path.join(ROOT, "perfbench"))
    root = tiny_root(str(tmp_path))
    pb = os.path.join(root, "perfbench")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    first = cells_of_kind("sweep", root)[0]
    base = next(w for w in bench["workloads"] if w["name"] == first)
    conf = next(c for c in bench["configs"] if c["name"] == base["config"])
    with open(os.path.join(root, conf["file"])) as f:
        cfg = json.load(f)
    cfg.update(name="tess_two_grid", curves=6)
    cfg["time"]["segments"] = [[0.0, 800], [3.0, 900]]
    with open(os.path.join(pb, "configs", "tess_two_grid.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(pb, "kinds", "counted.py"), "w") as f:
        f.write(NEW_KIND)
    with open(os.path.join(pb, "workloads", base["name"] + ".json")) as f:
        traffic = json.load(f)
    traffic.update(kind="counted", stacks=2)
    with open(os.path.join(pb, "workloads", "tess_two.counted.json"),
              "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(pb, "metrics", "sweeps_done.py"), "w") as f:
        f.write("def read(run):\n    return len(run.searches) or None\n")
    bench["configs"].append({"name": "tess_two_grid", "source": "a test",
                             "file": "perfbench/configs/tess_two_grid.json",
                             "reduced": ["curves"], "why": "a test"})
    bench["workloads"].append({"name": "tess_two.counted",
                               "config": "tess_two_grid",
                               "traffic": "counted", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "search_evals_per_s":
            m["workloads"].append("tess_two.counted")
    bench["per_layer"].append({"name": "sweeps_done", "unit": "searches",
                               "better": "higher", "source": "program_span",
                               "layer": "a test",
                               "moves": "search_evals_per_s",
                               "workloads": ["tess_two.counted"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    check_contract(bench, root)
    assert cells_of_kind("counted", root) == ["tess_two.counted"]
    assert harness.load_cell("tess_two.counted",
                             root).config["name"] == "tess_two_grid"
    runs = {cell: runs_and_reports(root, cell) for cell in cells(root)}
    run, traced = runs["tess_two.counted"]
    assert run.counters["new_kind_steps"] >= 1
    assert traced["metrics"]["sweeps_done"]["value"] >= 1
    assert _tree_digest(os.path.join(ROOT, "perfbench")) == before


def test_set_up_on_the_cpu_loads_no_jax(tmp_path):
    """A cell's set-up, then the module check, in a fresh process."""
    root = tiny_root(str(tmp_path))
    code = (
        "import sys, tempfile\n"
        "from perfbench import harness, drivers\n"
        f"cell = harness.load_cell({cells()[0]!r}, {root!r})\n"
        "run = harness.Run(cell=cell)\n"
        "with tempfile.TemporaryDirectory() as tmp:\n"
        "    drivers.make(cell, 1, 'cpu', run, tmp).setup()\n"
        "import lightkurve_tpu_torch\n"
        "print(harness.jax_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    for name in ("lightkurve_tpu_torch.batch", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert not {"lightkurve_tpu", "jax", "flax"} & set(harness.jax_modules())
    for name, top in (("lightkurve_tpu.ops", "lightkurve_tpu"),
                      ("jaxlib.xla", "jaxlib"), ("jax", "jax"),
                      ("flax.linen", "flax")):
        monkeypatch.setitem(sys.modules, name, sys)
        assert top in harness.jax_modules()


def test_run_exits_non_zero_without_a_card_or_the_program(tmp_path):
    """Without CUDA the command prints no result; in a directory of only
    BENCHMARK.json and perfbench/ neither."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    cmd = [sys.executable, "-m", "perfbench.run", "--workload",
           cells()[0], "--seed", "1", "--seconds", "1"]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode != 0 and out.stdout == ""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("_data", "__pycache__"))
    env.pop("PYTHONPATH", None)
    out = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.card
def test_a_cell_runs_correct_on_the_card(card):
    cmd = [sys.executable, "-m", "perfbench.run", "--workload", cells()[0],
           "--seed", "2147483999", "--seconds", "3", "--trace", "0"]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
