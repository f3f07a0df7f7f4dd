"""lightkurve_tpu's recovery on chip_smoke.py's synthetic oscillators.

    JAX_PLATFORMS=cpu python tools/seismology_reference_rate.py

Writes phase 14 (b)'s stars (``chip_smoke.write_seismic_stars``: 32 red
giants as KEPSEISMIC files, 4 solar-like stars as Kepler short-cadence
files, from the smoke's seeds) to a temporary directory, runs each through
the JAX package on the CPU in float64 (``read``, ``normalize``, the PSD
periodogram to Nyquist, ``flatten``, ``to_seismology``, numax, Delta-nu,
the scaling relations) and prints one JSON line: per star the injected and
estimated numax and Delta-nu, and the share recovered by the smoke's rule
(numax within 5%, Delta-nu within 2%).  That share is the bar of the
port's share on the card (``chip_smoke.SEIS_REFERENCE_SHARE``).  The same
stars are then drawn without their granulation (``seismic_star(...,
granulation=0)``: white noise alone under the modes) and estimated again,
which shows how much of the estimator's numax error the background's
slope makes.
"""
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    import jax
    jax.config.update("jax_enable_x64", True)
    import numpy as np
    import lightkurve_tpu as jlk
    import chip_smoke as cs
    with tempfile.TemporaryDirectory() as tmp:
        paths, truths = cs.write_seismic_stars(tmp)
        outs, stars = [], []
        t0 = time.time()
        for path, truth in zip(paths, truths):
            out = cs.seismology_chain(jlk.read(path), truth["teff"])
            outs.append(out)
            stars.append({k: float(v) for k, v in (
                ("numax_true", truth["numax"]), ("numax", out["numax"]),
                ("deltanu_true", truth["deltanu"]),
                ("deltanu", out["deltanu"]))})
    ok = cs.seismology_recovered(outs, truths)
    giants = cs.SEIS_GIANTS
    white = []
    for i, truth in enumerate(truths[:giants]):
        t, f, fe, _ = cs.seismic_star(cs.SEIS_SEED + i, granulation=0.0)
        out = cs.seismology_chain(jlk.LightCurve(time=t, flux=f,
                                                 flux_err=fe),
                                  truth["teff"])
        white.append(out["numax"] / truth["numax"] - 1)
    print(json.dumps({
        "package": "lightkurve_tpu", "platform": jax.default_backend(),
        "x64": True, "stars": len(ok), "recovered": int(ok.sum()),
        "share": float(ok.mean()),
        "share_giants": float(ok[:giants].mean()),
        "share_dwarfs": float(ok[giants:].mean()),
        "numax_within": float(np.mean([abs(s["numax"] / s["numax_true"] - 1)
                                       < cs.SEIS_NUMAX_RTOL for s in stars])),
        "seconds": time.time() - t0, "per_star": stars,
        "giants_numax_error": [s["numax"] / s["numax_true"] - 1
                               for s in stars[:giants]],
        "giants_numax_error_white_noise_only": white}))


if __name__ == "__main__":
    main()
