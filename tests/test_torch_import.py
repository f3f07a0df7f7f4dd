"""lightkurve_tpu_torch imports without jax and without building anything,
and chip_smoke.py refuses to run without a CUDA device."""
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "lightkurve_tpu_torch",
    "lightkurve_tpu_torch.config",
    "lightkurve_tpu_torch.batch",
    "lightkurve_tpu_torch.ops._build",
    "lightkurve_tpu_torch.ops.bls_window",
    "lightkurve_tpu_torch.ops.bls_fused",
    "lightkurve_tpu_torch.ops.bls",
    "lightkurve_tpu_torch.io.native",
    "lightkurve_tpu_torch.io.fits",
    "lightkurve_tpu_torch.io.pipeline",
    "lightkurve_tpu_torch.parallel.checkpoint",
    "chip_smoke",
]

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
    out = subprocess.run([sys.executable, "-c", PROBE] + MODULES, cwd=ROOT,
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
