"""lightkurve_tpu_torch.parallel on ranks against lightkurve_tpu.parallel on
a device mesh, float64 on the CPU.

The reference shards with ``shard_map`` over 4 of the 8 virtual CPU
devices (``tests/conftest.py``), through ``make_mesh(..., devices=
jax.devices()[:4])``.  The port runs as 4 gloo ranks spawned on the CPU
(``parallel.launch.run_ranks``; a ``file://`` store in a temporary
directory), each calling the sharded function with the whole arrays; one
spawn (``ranks``, module-scoped) runs every call, and each check below
reads its own call's result.  Inputs are made with numpy from a seed and
handed to both packages.

Bars:
- ``sharded_bls``, both shared-grid regimes and the per-curve exact
  branch, ragged B (7) and P (29): rtol 1e-9 (atol 1e-12) on finite
  entries, equal finite patterns, winners that tie to the last bits may
  rank either way where power agrees to 1e-9 (ROADMAP C's tie rule);
- ``sharded_lombscargle``: 1e-9 of each row's largest power;
- ``sharded_flatten``: rtol 1e-10 (atol 1e-13), equal masks;
- ``sharded_pld_photometry``: equal masks, corrected flux within 1e-9 of
  the median flux (``tests/test_torch_tpf.py``'s bar for the port's own
  PCA draw against JAX's), errors rtol 1e-9;
- ``SweepRunner(mesh=...)``: a run killed after 2 chunks and resumed
  equal bit for bit to the uninterrupted one; winners as the reference's
  mesh runner gives them (the tie rule), on a 2x2 and a 4x1 mesh;
- every rank's whole result equal, bit for bit, to every other's.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightkurve_tpu.batch import LightCurveStack as JStack
from lightkurve_tpu.batch import TPFStack as JTPFStack
from lightkurve_tpu.parallel import grid as jgrid
from lightkurve_tpu.parallel.checkpoint import SweepRunner as JSweepRunner
from lightkurve_tpu_torch import config
from lightkurve_tpu_torch.batch import LightCurveStack, TPFStack
from lightkurve_tpu_torch.ops.bls import bls_power_shared_batch
from lightkurve_tpu_torch.parallel import dryrun, grid, launch

FIELDS = ("power", "depth", "depth_err", "depth_snr", "log_likelihood",
          "duration", "transit_time", "period")
N_RANKS = 4
B, N, P = 7, 300, 29
PERIODS = np.linspace(1.2, 4.0, P)
DURATIONS = np.array([0.1, 0.2, 0.25])
NF, F0, DF = 200, 0.05, 0.01
SWEEP_PERIODS = np.linspace(1.2, 4.0, 64)
SWEEP_DURATIONS = np.array([0.1, 0.2])
LAYOUTS = [(None, None), (2, None), (None, 4), (4, 1), (1, 4), (3, None),
           (2, 3)]


def jmesh(nt, ng):
    return jgrid.make_mesh(nt, ng, devices=jax.devices()[:N_RANKS])


def bls_inputs(kind, seed=3):
    """(time, flux, dy) of B curves with a transit at 2.77 d: one shared
    grid and one dy per curve ("uniform"), per-cadence dy with ~3%
    masked ("weighted"), or each curve on its own jittered grid
    ("percurve", jittered so no sample sits on a window edge)."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 15, N))
    time = np.tile(t, (B, 1))
    if kind == "percurve":
        time = np.sort(rng.uniform(0, 15, (B, N)), axis=1)
    flux = 1.0 + 5e-4 * rng.normal(size=(B, N))
    ph = np.mod(time - 2.0 + 2.77 / 2, 2.77) - 2.77 / 2
    flux[np.abs(ph) < 0.08] -= 4e-3
    if kind == "uniform":
        dy = np.tile(rng.uniform(4e-4, 9e-4, (B, 1)), (1, N))
    else:
        dy = rng.uniform(4e-4, 9e-4, (B, N))
        dy[rng.random((B, N)) < 0.03] = np.inf
    return time, flux, dy


def flatten_inputs(seed=5):
    """A trend, a gap and masked samples over 400 cadences."""
    rng = np.random.default_rng(seed)
    t = np.arange(400) * 0.02
    t[200:] += 1.0
    time = np.tile(t, (B, 1))
    flux = (1.0 + 0.01 * np.sin(2 * np.pi * time / rng.uniform(3, 6, (B, 1)))
            + 1e-3 * rng.normal(size=(B, 400)))
    mask = rng.random((B, 400)) > 0.05
    return time, flux, mask


def pixel_inputs(Bp=5, T=150, shape=(7, 7), seed=9):
    """Pixel cubes: a star moving on a background, photon-like noise, NaN
    pixels; a 3-px aperture round the star."""
    rng = np.random.default_rng(seed)
    h, w = shape
    t = 1500.0 + np.arange(T) * 0.02
    yy, xx = np.mgrid[:h, :w]
    cx = 3.0 + 0.3 * np.sin(2 * np.pi * t / 0.7)
    cy = 3.0 + 0.15 * np.cos(2 * np.pi * t / 0.9)
    star = rng.uniform(2e3, 2e4, Bp)[:, None, None, None]
    psf = np.exp(-((xx - cx[:, None, None]) ** 2
                   + (yy - cy[:, None, None]) ** 2) / 2.0)
    flux = star * psf[None] + 30.0
    err = np.sqrt(flux)
    flux = flux + err * rng.normal(size=flux.shape)
    flux[rng.random(flux.shape) < 0.002] = np.nan
    ap = np.broadcast_to(np.hypot(xx - 3, yy - 3) <= 1.5, (Bp, h, w)).copy()
    return flux, err, np.tile(t, (Bp, 1)), ap


def sweep_stack(seed=11, Bs=6, n=256):
    rng = np.random.default_rng(seed)
    t = np.arange(n) * 0.05
    flux = 1.0 + 2e-4 * rng.normal(size=(Bs, n))
    p_true = rng.uniform(1.5, 3.5, Bs)
    for i in range(Bs):
        ph = np.mod(t - 0.3 + p_true[i] / 2, p_true[i]) - p_true[i] / 2
        flux[i, np.abs(ph) < 0.06] -= 3e-3
    return (np.tile(t, (Bs, 1)), flux, np.full((Bs, n), 2e-4),
            np.ones((Bs, n), bool))


def port_stack(arrays):
    return LightCurveStack.from_numpy(*arrays, device="cpu",
                                      dtype=torch.float64)


def jax_stack(arrays):
    t, f, e, m = arrays
    return JStack(time=jnp.asarray(t), flux=jnp.asarray(f),
                  flux_err=jnp.asarray(e), mask=jnp.asarray(m))


def calls(sweep_dir):
    """Every call the ranks make, by name: (fn, args, kwargs, mesh)."""
    out = {"layouts": (dryrun._describe_meshes, (LAYOUTS,), {}, None)}
    for kind, mesh in (("uniform", (2, 2)), ("weighted", (4, 1)),
                       ("percurve", (1, 4))):
        t, f, dy = bls_inputs(kind)
        out[f"bls_{kind}"] = (grid.sharded_bls, (t, f, dy, PERIODS,
                                                 DURATIONS), {}, mesh)
    t, f, dy = bls_inputs("weighted")
    for mesh in ((4, 1), (2, 2)):
        out[f"ls_{mesh}"] = (grid.sharded_lombscargle,
                             (t[0], f, dy, F0, DF, NF), {}, mesh)
        out[f"flatten_{mesh}"] = (grid.sharded_flatten, flatten_inputs(),
                                  dict(window_length=31), mesh)
    flux, err, tt, ap = pixel_inputs()
    tpf = TPFStack(flux=torch.from_numpy(flux), flux_err=torch.from_numpy(err),
                   time=torch.from_numpy(tt), aperture=torch.from_numpy(ap))
    out["pld"] = (grid.sharded_pld_photometry, (tpf,), {}, (4, 1))
    stack = port_stack(sweep_stack())
    for mesh in ((2, 2), (4, 1)):
        out[f"sweep_{mesh}"] = (dryrun.mesh_sweep, (
            stack, SWEEP_PERIODS, SWEEP_DURATIONS, sweep_dir),
            dict(tag=f"m{mesh[0]}x{mesh[1]}", chunk_periods=16,
                 method="shared"), mesh)
    ls_stack = port_stack((t, f, np.where(np.isfinite(dy), dy, 1.0),
                           np.isfinite(dy)))
    out["to_periodogram"] = (LightCurveStack.to_periodogram, (ls_stack,),
                             dict(sharded=True), (2, 2))
    tp, fp, dyp = bls_inputs("percurve")
    exact = port_stack((tp, fp, np.where(np.isfinite(dyp), dyp, 1.0),
                        np.isfinite(dyp)))
    out["bls_search_exact"] = (LightCurveStack.bls_search, (
        exact, PERIODS, DURATIONS), dict(sharded=True, method="exact"),
        (2, 2))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every call of :func:`calls` on 4 gloo ranks on the CPU, one spawn:
    (each rank's results by call name, the rank reports, the directory of
    the mesh sweeps' checkpoints)."""
    sweep_dir = str(tmp_path_factory.mktemp("mesh_sweeps"))
    named = calls(sweep_dir)
    reports = launch.run_ranks(N_RANKS, launch._call_all,
                               list(named.values()), device="cpu",
                               timeout=300)
    by_rank = [dict(zip(named, r["result"])) for r in reports]
    return by_rank, reports, sweep_dir


def assert_same(want, got, tag):
    """The reference's dict ``want`` against the port's ``got``: equal
    finite patterns, rtol 1e-9 on every field where the winner is the
    same, power within 1e-9 where tied windows rank either way."""
    w = {k: np.asarray(want[k]) for k in FIELDS}
    g = {k: np.asarray(got[k]) for k in FIELDS}
    for k in FIELDS:
        assert w[k].shape == g[k].shape, (tag, k)
        np.testing.assert_array_equal(np.isfinite(w[k]), np.isfinite(g[k]),
                                      err_msg=f"{tag} {k}")
    same = np.isclose(w["transit_time"], g["transit_time"], rtol=1e-9,
                      atol=1e-12) & np.isclose(w["duration"], g["duration"],
                                               rtol=1e-9)
    assert (~same).mean() < 0.01, f"{tag}: {(~same).sum()} winner flips"
    for k in FIELDS:
        m = np.isfinite(w[k]) & (same | (k == "power"))
        np.testing.assert_allclose(g[k][m], w[k][m], rtol=1e-9, atol=1e-12,
                                   err_msg=f"{tag} {k}")


def same(a, b):
    """``a`` and ``b`` hold the same values (arrays bit for bit)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(same, a, b))
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b, equal_nan=a.dtype.kind == "f")
    return a == b


def every_rank_equal(ranks, name, key=None):
    """Call ``name``'s result (its ``key``), the same on every rank."""
    by_rank = ranks[0]
    vals = [r[name] if key is None else r[name][key] for r in by_rank]
    assert all(same(vals[0], v) for v in vals[1:]), f"{name} differs by rank"
    return by_rank[0][name]


def test_make_mesh_layouts_match_reference(ranks):
    by_rank = ranks[0]
    got = by_rank[0]["layouts"]
    for r in by_rank:                # one shape on every rank
        assert [x.get("shape", x.get("error")) for x in r["layouts"]] == [
            x.get("shape", x.get("error")) for x in got]
    for layout, g in zip(LAYOUTS, got):
        try:
            want = jmesh(*layout)
        except ValueError as e:
            assert g == {"error": str(e)}
            continue
        assert g["shape"] == dict(want.shape), layout
    coords = sorted(r["layouts"][1]["coordinate"] for r in by_rank)
    assert coords == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert {r["layouts"][0]["device"] for r in by_rank} == {"cpu"}


def test_mesh_without_a_group_is_one_by_one(monkeypatch):
    monkeypatch.setattr(config, "default_device", "cpu")
    mesh = grid.make_mesh()
    assert mesh.shape == {"targets": 1, "grid": 1}
    assert mesh.coordinate == (0, 0) and mesh.device_mesh is None
    assert mesh.device == torch.device("cpu")
    with pytest.raises(ValueError, match="mesh 2x2 != 1 devices"):
        grid.make_mesh(2, 2)
    # the default device is the card, which this machine lacks
    monkeypatch.setattr(config, "default_device", "cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            grid.make_mesh()
    t, f, dy = bls_inputs("weighted")
    got = grid.sharded_bls(t, f, dy, PERIODS, DURATIONS, mesh=mesh)
    want = bls_power_shared_batch(t[0], f, dy, PERIODS, DURATIONS,
                                  device="cpu")
    for k in FIELDS:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("kind,mesh", [("uniform", (2, 2)),
                                       ("weighted", (4, 1)),
                                       ("percurve", (1, 4))])
def test_sharded_bls_matches_reference(ranks, kind, mesh):
    got = every_rank_equal(ranks, f"bls_{kind}")
    t, f, dy = bls_inputs(kind)
    want = jgrid.sharded_bls(t, f, dy, PERIODS, DURATIONS, mesh=jmesh(*mesh))
    assert_same(want, got, kind)


@pytest.mark.parametrize("mesh", [(4, 1), (2, 2)])
def test_sharded_lombscargle_matches_reference(ranks, mesh):
    got = every_rank_equal(ranks, f"ls_{mesh}")
    t, f, dy = bls_inputs("weighted")
    want = np.asarray(jgrid.sharded_lombscargle(t[0], f, dy, F0, DF, NF,
                                                mesh=jmesh(*mesh)))
    assert got.shape == (B, NF)
    err = np.max(np.abs(got - want), axis=1) / np.max(np.abs(want), axis=1)
    assert err.max() <= 1e-9, err


def test_sharded_flatten_matches_reference(ranks):
    trend, valid = every_rank_equal(ranks, "flatten_(4, 1)")
    t, f, m = flatten_inputs()
    jt, jv = jgrid.sharded_flatten(t, f, m, window_length=31,
                                   mesh=jmesh(4, 1))
    np.testing.assert_array_equal(valid, np.asarray(jv))
    np.testing.assert_allclose(trend, np.asarray(jt), rtol=1e-10,
                               atol=1e-13)
    # a 2-D mesh: the targets axis shards, the grid axis holds copies
    trend2, valid2 = every_rank_equal(ranks, "flatten_(2, 2)")
    np.testing.assert_array_equal(trend2, trend)
    np.testing.assert_array_equal(valid2, valid)


def test_sharded_pld_photometry_matches_reference(ranks):
    f, e, m = every_rank_equal(ranks, "pld")
    flux, err, tt, ap = pixel_inputs()
    want = jgrid.sharded_pld_photometry(
        JTPFStack(flux=jnp.asarray(flux), flux_err=jnp.asarray(err),
                  time=jnp.asarray(tt), aperture=jnp.asarray(ap)),
        mesh=jmesh(4, 1))
    wf, we, wm = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(m, wm)
    scale = np.median(np.abs(wf))
    assert np.max(np.abs(f - wf)) / scale < 1e-9
    np.testing.assert_allclose(e, we, rtol=1e-9)
    # and the unsharded port on the same cube
    whole = TPFStack(flux=torch.from_numpy(flux), flux_err=torch.from_numpy(
        err), time=torch.from_numpy(tt), aperture=torch.from_numpy(
            ap)).pld_correct()
    assert np.max(np.abs(f - whole.flux.numpy())) / scale < 1e-12


def test_best_candidates_matches_reference():
    rng = np.random.default_rng(2)
    power = rng.normal(size=(9, 40))
    periods = np.linspace(1, 5, 40)
    for k in (1, 3):
        jp, jv = jgrid.best_candidates(power, periods, k=k)
        tp, tv = grid.best_candidates(torch.from_numpy(power), periods, k=k)
        np.testing.assert_array_equal(tp, np.asarray(jp))
        np.testing.assert_array_equal(tv, np.asarray(jv))


@pytest.mark.parametrize("mesh", [(2, 2), (4, 1)])
def test_mesh_sweep_kill_resume_matches_reference(ranks, tmp_path, mesh):
    for key in ("uninterrupted", "resumed"):
        every_rank_equal(ranks, f"sweep_{mesh}", key)
    out = ranks[0][0][f"sweep_{mesh}"]
    for f in FIELDS:
        np.testing.assert_array_equal(out["resumed"][f],
                                      out["uninterrupted"][f], err_msg=f)
    want = JSweepRunner(jax_stack(sweep_stack()), SWEEP_PERIODS,
                        SWEEP_DURATIONS, str(tmp_path / "ref.npz"),
                        chunk_periods=16, mesh=jmesh(*mesh)).run()
    got = out["uninterrupted"]
    np.testing.assert_allclose(got["power"], want["power"], rtol=1e-9)
    np.testing.assert_array_equal(got["period"], want["period"])
    np.testing.assert_array_equal(got["duration"], want["duration"])
    assert len(out["chunk_seconds"]) == len(SWEEP_PERIODS) // 16


def test_mesh_sweep_checkpoints_hold_the_whole_state(ranks):
    """One npz per sweep (the mesh's first rank writes it, no temporary
    file is left), holding the state every rank ended with."""
    by_rank, _, sweep_dir = ranks
    assert sorted(os.listdir(sweep_dir)) == sorted(
        f"m{a}x{b}_{kind}.npz" for a, b in ((2, 2), (4, 1))
        for kind in ("ref", "kill"))
    for mesh in ((2, 2), (4, 1)):
        data = np.load(os.path.join(sweep_dir,
                                    f"m{mesh[0]}x{mesh[1]}_kill.npz"))
        assert int(data["next_chunk"]) == len(SWEEP_PERIODS) // 16
        for r in by_rank:
            for f in FIELDS:
                np.testing.assert_array_equal(
                    r[f"sweep_{mesh}"]["resumed"][f], data[f])


def test_to_periodogram_sharded_matches_reference(ranks):
    freqs, power = every_rank_equal(ranks, "to_periodogram")
    t, f, dy = bls_inputs("weighted")
    arrays = (t, f, np.where(np.isfinite(dy), dy, 1.0), np.isfinite(dy))
    jf, jp = jax_stack(arrays).to_periodogram(sharded=True, mesh=jmesh(2, 2))
    np.testing.assert_array_equal(freqs, jf)
    err = np.max(np.abs(power - jp), axis=1) / np.max(np.abs(jp), axis=1)
    assert err.max() <= 1e-9, err


def test_to_periodogram_sharded_refuses_mixed_grids():
    t, f, dy = bls_inputs("percurve")
    arrays = (t, f, np.where(np.isfinite(dy), dy, 1.0), np.isfinite(dy))
    with pytest.raises(ValueError, match="share one time grid"):
        port_stack(arrays).to_periodogram(sharded=True)
    with pytest.raises(ValueError, match="share one time grid"):
        jax_stack(arrays).to_periodogram(sharded=True, mesh=jmesh(2, 2))


def test_bls_search_sharded_exact_matches_reference(ranks):
    got = every_rank_equal(ranks, "bls_search_exact")
    tp, fp, dyp = bls_inputs("percurve")
    arrays = (tp, fp, np.where(np.isfinite(dyp), dyp, 1.0),
              np.isfinite(dyp))
    want = jax_stack(arrays).bls_search(PERIODS, DURATIONS, sharded=True,
                                        mesh=jmesh(2, 2), method="exact")
    assert_same(want, got, "bls_search exact")


def test_ranks_ran_the_plain_versions(ranks):
    reports = ranks[1]
    for r in reports:
        assert not any(r["launches"].values()), r["launches"]
        assert r["calls"]["K-F"] and r["calls"]["K-WF"], r["calls"]


def test_a_failing_rank_fails_the_run():
    with pytest.raises(RuntimeError, match=r"mesh 3x1 != 2 devices"):
        launch.run_ranks(2, launch._call_all,
                         [(grid.make_mesh, (3, 1), {}, None)], device="cpu",
                         timeout=120)


def test_dryrun_multichip_on_cpu_ranks(capsys):
    reports = dryrun.dryrun_multichip(
        N_RANKS, device="cpu", sweep_curves=16, sweep_cadences=1024,
        sweep_periods=1024, sweep_chunk=32)
    printed = capsys.readouterr().out
    for phase in ("phase1 OK", "phase2 OK", "phase3a OK", "phase3b OK",
                  "phase3c OK"):
        assert phase in printed
    assert len(reports) == N_RANKS
    ok = [[x for x in r["result"] if " OK" in x] for r in reports]
    assert len(ok[0]) == 5 and all(x == ok[0] for x in ok[1:])
