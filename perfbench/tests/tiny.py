"""A copy of the benchmark's data files under a temporary root, cut to a
size the CPU runs in seconds (a few curves, two short segments, window
101); the code is the package's own.  Also the lookup of the cells the
tests run: every cell of ``BENCHMARK.json``, or those of one traffic kind,
so that a cell added as files and entries is tested with no test edited."""
import json
import os
import shutil

from perfbench.harness import ROOT


def tiny_root(dst, curves=8, seg=1000, window=101):
    pb = os.path.join(dst, "perfbench")
    os.makedirs(os.path.join(pb, "configs"), exist_ok=True)
    for sub in ("metrics", "workloads", "kinds"):
        shutil.copytree(os.path.join(ROOT, "perfbench", sub),
                        os.path.join(pb, sub), dirs_exist_ok=True)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for name in os.listdir(os.path.join(ROOT, "perfbench", "configs")):
        rel = os.path.join("perfbench", "configs", name)
        with open(os.path.join(ROOT, rel)) as f:
            cfg = json.load(f)
        cfg["curves"] = curves
        cad = cfg["time"]["cadence_days"]
        cfg["time"]["segments"] = [[0.0, seg], [seg * cad + 1.0, seg]]
        cfg["flatten"]["window_length"] = window
        if cfg["search"]["periods"]["kind"] == "linspace":
            cfg["search"]["periods"] = {"kind": "linspace", "start": 1.0,
                                        "stop": 5.0, "num": 50}
        with open(os.path.join(dst, rel), "w") as f:
            json.dump(cfg, f)
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    wl = os.path.join(pb, "workloads")
    for name in os.listdir(wl):
        path = os.path.join(wl, name)
        with open(path) as f:
            tr = json.load(f)
        if "chunk_periods" in tr:
            tr["chunk_periods"] = 64
        with open(path, "w") as f:
            json.dump(tr, f)
    return dst


def set_traffic(root, cell, **kw):
    path = os.path.join(root, "perfbench", "workloads", cell + ".json")
    with open(path) as f:
        tr = json.load(f)
    tr.update(kw)
    with open(path, "w") as f:
        json.dump(tr, f)


def cells(root=ROOT):
    """The names of the cells of ``<root>/BENCHMARK.json``, in its order."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


def cells_of_kind(kind, root=ROOT):
    """The cells whose traffic file ``perfbench/workloads/<cell>.json``
    names the traffic kind ``kind``."""
    out = []
    for cell in cells(root):
        path = os.path.join(root, "perfbench", "workloads", cell + ".json")
        with open(path) as f:
            if json.load(f)["kind"] == kind:
                out.append(cell)
    return out
