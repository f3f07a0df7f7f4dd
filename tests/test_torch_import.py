"""lightkurve_tpu_torch imports without jax and without building anything,
and chip_smoke.py refuses to run without a CUDA device."""
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

def port_modules():
    """Every module of the port, found by walking the package, and
    chip_smoke.py."""
    import pkgutil
    names = ["lightkurve_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(
            [os.path.join(ROOT, "lightkurve_tpu_torch")],
            prefix="lightkurve_tpu_torch.")]
    return names + ["chip_smoke"]


PROBE = """
import importlib, subprocess, sys
def refuse(*a, **k):
    raise AssertionError("a subprocess was started at import: %r" % (a,))
subprocess.run = subprocess.Popen = refuse
for name in sys.argv[1:]:
    importlib.import_module(name)
import numpy as np
import lightkurve_tpu_torch as pkg
for name in pkg.__all__:
    getattr(pkg, name)
t = np.tile(np.arange(64) * 0.02, (2, 1))
stack = pkg.LightCurveStack.from_numpy(t, np.ones_like(t), np.ones_like(t),
                                       np.ones(t.shape, bool), device="cpu")
for method in ("shared", "fast", "exact"):
    runner = pkg.SweepRunner(stack, [0.5, 0.6], [0.1], "/nonexistent.npz",
                             method=method)
    assert runner.prewarm(wait=True) == []
assert pkg.prewarm_shared_sweep("cpu", wait=True) == []
stack.flatten(window_length=11).remove_outliers()
from lightkurve_tpu_torch.ops import _build
from lightkurve_tpu_torch.io import native
assert not _build._LOADED and not native._LIB, "a library was loaded"
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "lightkurve_tpu.")))
assert not bad and "lightkurve_tpu" not in sys.modules, bad
print("clean")
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    return env


def test_slice_imports_without_jax_or_builds():
    modules = port_modules()
    for name in ("ops.detrend", "ops.savgol", "ops.masked", "ops.stats",
                 "ops.interp", "ops.bls_staged_fold"):
        assert "lightkurve_tpu_torch." + name in modules
    out = subprocess.run([sys.executable, "-c", PROBE] + modules, cwd=ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_card_or_repo(tmp_path, where):
    """No CUDA device (as here), or no package beside the script: a
    non-zero exit and no result line."""
    script = os.path.join(ROOT, "chip_smoke.py")
    cwd = ROOT
    env = dict(os.environ)
    if where == "alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
        env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
