"""lightkurve_tpu_torch imports without jax and without building anything
(every module, the correctors, the CBV corrector, the seismology package,
the science-product readers, PRF photometry, models, diagnostics and
roofline, the settings, the archive search and the HTML explorers
included; a light curve's SFF corrector, a spectrum's numax and Delta-nu,
a 4-cadence PRF fit and a BLS explorer page on the CPU run without them),
its top-level names are lightkurve_tpu's but the network client and the
plotting helper, and chip_smoke.py refuses to run without a CUDA
device."""
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
import os, tempfile
rng = np.random.default_rng(1)
tt = 1500.0 + np.arange(600) * 0.02
lc = pkg.LightCurve(time=tt, flux=1 - 2e-3 * (np.mod(tt, 1.7) < 0.1)
                    + 2e-4 * rng.standard_normal(600), flux_err=np.full(600, 2e-4))
page = os.path.join(tempfile.mkdtemp(), "bls.html")
from lightkurve_tpu_torch import config
config.default_device = "cpu"
assert pkg.export_interact_bls_html(lc, page, resolution=200, refine_peaks=1,
                                    refine_factor=2) == page
assert "const D = {best:" in open(page).read()
t = np.tile(np.arange(64) * 0.02, (2, 1))
stack = pkg.LightCurveStack.from_numpy(t, np.ones_like(t), np.ones_like(t),
                                       np.ones(t.shape, bool), device="cpu")
for method in ("shared", "fast", "exact"):
    runner = pkg.SweepRunner(stack, [0.5, 0.6], [0.1], "/nonexistent.npz",
                             method=method)
    assert runner.prewarm(wait=True) == []
assert pkg.prewarm_shared_sweep("cpu", wait=True) == []
stack.flatten(window_length=11).remove_outliers()
freqs, power = stack.to_periodogram()
assert power.shape == (2, len(freqs)) and bool(power.isfinite().all())
import torch
from lightkurve_tpu_torch import config
config.default_device, config.default_dtype = "cpu", torch.float64
rng = np.random.default_rng(0)
tt = 2000.0 + np.arange(300) * 0.0204
ph = np.mod(tt, 0.25) / 0.25
lc = pkg.KeplerLightCurve(time=tt, flux=1e4 * (1 - 4e-3 * ph ** 2)
                          + rng.standard_normal(300), flux_err=np.ones(300),
                          centroid_col=300 + 0.6 * ph, centroid_row=500
                          + 0.3 * ph ** 1.3)
sff = lc.to_corrector("sff")
assert type(sff) is pkg.SFFCorrector, type(sff)
assert np.isfinite(sff.correct(windows=5).flux.value).all()
from lightkurve_tpu_torch.periodogram import SNRPeriodogram
from lightkurve_tpu_torch.units import Quantity
freq = np.arange(1.0, 400.0, 0.1)
power = 1 + sum(40 * np.exp(-0.5 * ((freq - 220) / 50) ** 2)
                * np.exp(-0.5 * ((freq - 220 - k * 16.97) / 0.3) ** 2)
                for k in range(-8, 9))
seis = SNRPeriodogram(Quantity(freq, "uHz"), Quantity(power, "")
                      ).to_seismology()
assert abs(float(seis.estimate_numax().value) / 220 - 1) < 0.1
assert abs(float(seis.estimate_deltanu().value) / 16.97 - 1) < 0.05
from lightkurve_tpu_torch.prf import (GaussianPRF, GaussianPrior,
                                      PRFPhotometry, StarPrior, TPFModel,
                                      UniformPrior)
from lightkurve_tpu_torch import models, diagnostics, roofline
assert models.PRFPhotometry is PRFPhotometry
prf = GaussianPRF(shape=(5, 5))
scene = TPFModel([StarPrior(GaussianPrior(2.4, 1.0), GaussianPrior(2.6, 1.0),
                            UniformPrior(0.0, 400.0))], prfmodel=prf)
img = scene.predict([2.5, 2.5, 100.0, 0.0])
fitted = PRFPhotometry(scene).run(np.stack([img] * 4), device="cpu")
assert fitted.shape == (4, 4) and np.allclose(fitted[:, 2], 100.0, rtol=1e-3)
with diagnostics.KernelTimer("probe", device="cpu"):
    pass
assert roofline.device_peaks("cpu")["kind"] == "cpu"
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
                 "ops.interp", "ops.bls_staged_fold", "ops.lombscargle",
                 "ops.solve", "ops.photometry", "ops.peaks", "wcs",
                 "targetpixelfile", "correctors", "correctors.designmatrix",
                 "correctors.corrector", "correctors.regressioncorrector",
                 "correctors.pldcorrector", "correctors.sffcorrector",
                 "correctors.metrics", "correctors.cbvcorrector",
                 "ops.acf", "seismology", "seismology.core",
                 "seismology.utils", "seismology.numax_estimators",
                 "seismology.deltanu_estimators",
                 "seismology.stellar_estimators", "io.readers", "prf",
                 "prf.prfmodel", "prf.tpfmodel", "models", "diagnostics",
                 "roofline", "config", "convenience", "lightcurvefile",
                 "mast", "search", "interact", "interact_html"):
        assert "lightkurve_tpu_torch." + name in modules
    out = subprocess.run([sys.executable, "-c", PROBE] + modules, cwd=ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_top_level_names_are_the_references():
    """Every name of ``lightkurve_tpu.__all__`` but the live MAST client
    (network) and ``plot_image`` (plotting) is exported by the port."""
    import lightkurve_tpu
    import lightkurve_tpu_torch
    assert set(lightkurve_tpu.__all__) - set(lightkurve_tpu_torch.__all__) \
        == {"HTTPMASTTransport", "plot_image"}


@pytest.mark.parametrize("sub", ["io", "ops", "parallel"])
def test_subpackage_names_are_the_references(sub):
    """Each subpackage exports the reference's ``__all__`` (``ops``: but
    the TPU workaround's FFT pairs, listed in ``ops.NOT_PORTED``), each
    name bound in the subpackage."""
    import importlib
    want = set(importlib.import_module(f"lightkurve_tpu.{sub}").__all__)
    got = importlib.import_module(f"lightkurve_tpu_torch.{sub}")
    left_out = set(getattr(got, "NOT_PORTED", ()))
    assert want - set(got.__all__) == left_out
    for name in want - left_out:
        assert getattr(got, name) is not None, name
    if sub == "ops":
        assert left_out == {"fft_pair", "ifft_pair", "rfft_pair"}
    if sub == "parallel":
        from lightkurve_tpu.parallel import grid
        assert set(grid.__all__) <= set(got.__all__)


def test_parallel_imports_without_jax_or_a_process_group():
    """``lightkurve_tpu_torch.parallel`` (its grid, launcher and dry run)
    imports no jax, starts no process and initialises no group."""
    probe = (
        "import subprocess, sys\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError('a process was started at import')\n"
        "subprocess.run = subprocess.Popen = refuse\n"
        "import lightkurve_tpu_torch.parallel as par\n"
        "from lightkurve_tpu_torch.parallel import dryrun, launch, grid\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'lightkurve_tpu.')))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120)
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
