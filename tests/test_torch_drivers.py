"""The port's drivers against the repository's JAX ones on the CPU.

``lightkurve_tpu_torch.tools.make_sector`` against ``tools/make_sector.py``
(the arrays bit for bit, the files column for column);
``lightkurve_tpu_torch.bench`` against ``bench.py`` (its detail's keys,
read from bench.py's source, and the primary's powers against
``lightkurve_tpu``'s on the same numpy inputs); the north-star search
against ``lightkurve_tpu``'s SweepRunner batch by batch, paused and
resumed; the two examples against the JAX examples' computation.  Every
size is cut with monkeypatch; float64 where the packages are compared.
"""
import ast
import json
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from lightkurve_tpu_torch import bench
from lightkurve_tpu_torch.examples import multi_sector_sweep as tmulti
from lightkurve_tpu_torch.examples import sector_search as tsector
from lightkurve_tpu_torch.io.fits import open_fits
from lightkurve_tpu_torch.tools import make_sector as tms
from lightkurve_tpu_torch.tools import northstar_run as tns
from tools import make_sector as jms

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("power", "depth", "depth_err", "depth_snr", "log_likelihood",
          "duration", "transit_time", "period")


# ---------------------------------------------------------------------------
# make_sector
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ib", [0, 3])
def test_sector_arrays_are_the_references_bit_for_bit(ib):
    for name in ("N", "BATCH", "SECTOR", "NOISE", "DEPTH", "T_OFFSET"):
        assert getattr(tms, name) == getattr(jms, name), name
    t = tms.time_grid()
    assert np.array_equal(t, jms.time_grid())
    for a, b in zip(tms.batch_truth(ib), jms.batch_truth(ib)):
        assert np.array_equal(a, b)
    for a, b in zip(tms.batch_flux(ib, t), jms.batch_flux(ib, t)):
        assert np.array_equal(a, b)
    assert tms.file_path("d", ib) == jms.file_path("d", ib)


def test_sector_files_equal_the_references(tmp_path, monkeypatch):
    for mod in (tms, jms):
        monkeypatch.setattr(mod, "N", 300)
        monkeypatch.setattr(mod, "BATCH", 3)
    ours = tms.ensure_sector(str(tmp_path / "port"), 2, verbose=False)
    theirs = jms.ensure_sector(str(tmp_path / "jax"), 2, verbose=False)
    assert [os.path.basename(p) for p in ours] == \
        [os.path.basename(p) for p in theirs]
    for a, b in zip(ours, theirs):
        ha, hb = open_fits(a), open_fits(b)
        assert len(ha) == len(hb) == 2
        for x, y in zip(ha, hb):
            assert list(x.header.keys()) == list(y.header.keys())
            for key in x.header.keys():
                assert x.header[key] == y.header[key], key
        assert ha[1].data.names == hb[1].data.names
        for col in ha[1].data.names:
            assert np.array_equal(ha[1].data[col], hb[1].data[col]), col
    # present files are not written again
    stamp = os.path.getmtime(ours[0])
    assert tms.ensure_sector(str(tmp_path / "port"), 2,
                             verbose=False) == ours
    assert os.path.getmtime(ours[0]) == stamp


# ---------------------------------------------------------------------------
# bench
# ---------------------------------------------------------------------------
#: bench.py's keys that only served the TPU: the companions' time budget
#: against its watchdog
TPU_ONLY_KEYS = {"companions_skipped"}


def jax_bench_keys():
    """The keys bench.py's ``detail`` gets in a run without errors, read
    from its source: the ``detail`` dict's literal keys, its string
    subscripts, and its f-string subscripts expanded over the names
    ``_roof`` and ``run_case`` are called with."""
    tree = ast.parse(open(os.path.join(ROOT, "bench.py")).read())
    keys, templates = set(), set()
    called = {"_roof": set(), "run_case": set()}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Subscript)
                and isinstance(node.value, ast.Name)
                and node.value.id == "detail"):
            if isinstance(node.slice, ast.Constant):
                keys.add(node.slice.value)
            else:
                templates.add(ast.unparse(node.slice))
        elif (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
              and any(isinstance(t, ast.Name) and t.id == "detail"
                      for t in node.targets)):
            keys |= {k.value for k in node.value.keys}
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id in called):
            called[node.func.id].add(node.args[0].value)
    for tpl in templates:
        if tpl.endswith("_error'"):
            continue
        names = called["run_case" if tpl.startswith("f'bls_") else "_roof"]
        keys |= {eval(tpl, {"name": n}) for n in names}
    return {k for k in keys if not k.endswith("_error")}


def small_bench(monkeypatch, B=16, N=4096, P=64):
    monkeypatch.setenv("LK_BENCH_B", str(B))
    monkeypatch.setenv("LK_BENCH_N", str(N))
    monkeypatch.setenv("LK_BENCH_P", str(P))
    for name, value in (("PLD_SHAPE", (6, 80, 6, 6)), ("PRF_CADENCES", 12),
                        ("LS_NF", 256), ("ACF_SHAPE", (3, 4000, 8, 256)),
                        ("CLIFF_MIN_P", 16), ("CLIFF_RAGGED", 12),
                        ("FASTCHI2_NF", (1000, 32)), ("PRIMARY_REPS", 2)):
        monkeypatch.setattr(bench, name, value)


def test_bench_detail_has_the_references_keys(monkeypatch):
    small_bench(monkeypatch)
    line = bench.run(device="cpu", dtype=torch.float64)
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "detail"}
    assert line["metric"] == "bls_curve_period_evals_per_sec_per_chip"
    assert line["vs_baseline"] == line["value"] / bench.NORTH_STAR_RATE
    detail = line["detail"]
    want = {k.replace("ragged_b500", f"ragged_b{bench.CLIFF_RAGGED}")
            for k in jax_bench_keys() - TPU_ONLY_KEYS}
    want |= {"card"} | {f"{c}_seconds_all_reps" for c in bench.COMPANIONS}
    assert set(detail) == want
    assert detail["card"] is None and detail["device"] == "cpu"
    assert detail["recovered_period_ok"] and detail["prf_two_star_flux_ok"]
    assert len(detail["step_times_all_reps"]) == bench.PRIMARY_REPS
    assert detail["seconds_per_step"] == min(detail["step_times_all_reps"])
    assert line["value"] == 16 * 64 / detail["seconds_per_step"]
    json.dumps(line)


def test_bench_primary_equals_lightkurve_tpu(monkeypatch):
    from lightkurve_tpu.ops import bls as jbls
    small_bench(monkeypatch, P=256)
    ctx = bench.make_context("cpu", torch.float64)
    ours = bench.bls_call(ctx, ctx.flux, ctx.dy, ctx.periods, True)
    x = bench.primary_inputs(ctx.B, ctx.N, ctx.P)
    theirs = jbls.bls_power_shared_batch(
        jnp.asarray(x["t"]), jnp.asarray(x["flux"]), jnp.asarray(x["dy"]),
        jnp.asarray(x["periods"]), jnp.asarray(bench.DURATIONS),
        oversample=10, chunk=8, uniform_weights=True, bucket=True)
    for f in FIELDS:
        np.testing.assert_allclose(ours[f].numpy(), np.asarray(theirs[f]),
                                   rtol=1e-9, atol=1e-12, err_msg=f)
    assert np.array_equal(ours["power"].argmax(1).numpy(),
                          np.asarray(theirs["power"]).argmax(1))


def test_bench_counts_the_fused_kernels_work(monkeypatch):
    """bls_flops are the operations of one K-F launch per tile group,
    those roofline.bound_fused counts."""
    from lightkurve_tpu_torch import roofline
    from lightkurve_tpu_torch.ops.bls import _bucket_periods
    from lightkurve_tpu_torch.ops.bls_fused import nbins_per_period
    periods = np.linspace(1.0, 3.79, 700)
    cost = roofline.shared_uniform_cost(8192, 2048, periods, bench.DURATIONS)
    d_phase = 0.005
    k_durs = tuple(int(max(int(d / d_phase + 0.5), 1))
                   for d in bench.DURATIONS)
    groups, _ = _bucket_periods(periods.astype(np.float32), d_phase,
                                max(k_durs))
    assert cost["detail"]["launches"] == len(groups) > 1
    ops = nbytes = 0
    for idx, _ in groups:
        pc = torch.as_tensor(periods[idx], dtype=torch.float32)
        nbp = nbins_per_period(pc, d_phase).numpy()
        b, o = roofline._fused_counts(8192, 2048, 4, nbp, k_durs, True)
        ms, _ = roofline.bound_fused(torch.zeros(8192),
                                     torch.zeros((8192, 2048)), pc, k_durs,
                                     None, d_phase, 0, 0)
        assert ms == pytest.approx(max(b / roofline.PEAK_BYTES_S,
                                       o / roofline.PEAK_F32_S) * 1e3)
        ops, nbytes = ops + o, nbytes + b
    assert cost["flops"] == ops and cost["hbm_bytes"] == nbytes


def test_bench_main_fails_when_a_companion_raises(monkeypatch, capsys):
    small_bench(monkeypatch)

    def broken(ctx, detail):
        raise ValueError("broken companion")

    monkeypatch.setattr(bench, "_c_ls", broken)
    assert bench.main(["--device", "cpu"]) == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["detail"]["ls_error"] == "ValueError: broken companion"
    assert "fastchi2_freq_evals_per_sec" in line["detail"]
    with pytest.raises(RuntimeError, match="ls_error") as err:
        bench.run(device="cpu")
    assert isinstance(err.value.__cause__, ValueError)


# ---------------------------------------------------------------------------
# the north-star search
# ---------------------------------------------------------------------------
@pytest.fixture
def small_northstar(monkeypatch):
    """4 runner batches of 8 curves x 2048 cadences, 48 periods in 4 chunks
    of 12, one chunk between clock checks, float64."""
    monkeypatch.setattr(tms, "N", 2048)
    monkeypatch.setattr(tms, "BATCH", 4)
    for name, value in (("RUN_BATCH", 8), ("P_GRID", 48),
                        ("CHUNK_PERIODS", 12), ("N_CURVES_TOTAL", 32),
                        ("CHUNKS_PER_CHECK", 1), ("DTYPE", torch.float64)):
        monkeypatch.setattr(tns, name, value)


def northstar(state, *extra):
    return tns.run(tns.parse_args(["--mode", "synthetic", "--device", "cpu",
                                   "--state-dir", str(state), *extra]))


def test_northstar_batches_equal_lightkurve_tpu(tmp_path, small_northstar):
    from lightkurve_tpu.batch import LightCurveStack as JStack
    from lightkurve_tpu.parallel.checkpoint import SweepRunner as JRunner
    record = northstar(tmp_path / "state")
    assert record["curves"] == 32 and record["data_source"] == \
        "synthetic_memory"
    assert not os.path.exists(tmp_path / "state" / "manifest.json")
    t = tms.time_grid()
    periods = np.linspace(1.0, (t[-1] - t[0]) / 3, tns.P_GRID)
    recovered = 0
    for ib in range(4):
        flux = np.concatenate([tms.batch_flux(g, t)[0]
                               for g in (2 * ib, 2 * ib + 1)])
        stack = JStack(time=jnp.asarray(np.broadcast_to(t, flux.shape)),
                       flux=jnp.asarray(flux),
                       flux_err=jnp.full(flux.shape, tms.NOISE),
                       mask=jnp.ones(flux.shape, bool))
        want = JRunner(stack, periods, tns.DURATIONS,
                       str(tmp_path / f"jax{ib}.npz"), chunk_periods=12,
                       method="shared").run()
        got = np.load(tmp_path / "state" / "done" / f"batch{ib:03d}.npz")
        assert int(got["next_chunk"]) == 4
        for f in FIELDS:
            np.testing.assert_allclose(got[f], want[f], rtol=1e-9,
                                       atol=1e-12, err_msg=f)
        p_inj = np.concatenate([tms.batch_truth(g)[0]
                                for g in (2 * ib, 2 * ib + 1)])
        recovered += int((np.abs(want["period"] - p_inj) / p_inj
                          < 0.01).sum())
    assert record["recovery_rate"] == recovered / 32


def test_northstar_paused_and_resumed_equals_one_run(tmp_path, monkeypatch,
                                                     small_northstar):
    """A run stopped by --max-seconds in the middle of batch 1 and started
    again ends with the record fields and the batch winners of a run that
    never stopped.  The clock is patched: 10 s a chunk."""
    from lightkurve_tpu_torch.parallel import checkpoint
    chunks = [0]
    real_run = checkpoint.SweepRunner.run

    def counted(self, max_chunks=None):
        chunks[0] += max_chunks
        return real_run(self, max_chunks)

    monkeypatch.setattr(checkpoint.SweepRunner, "run", counted)
    monkeypatch.setattr(tns, "_now", lambda: 10.0 * chunks[0])
    whole = northstar(tmp_path / "whole", "--max-seconds", "1e6")
    chunks[0] = 0
    state = tmp_path / "paused"
    assert northstar(state, "--max-seconds", "55") is None
    manifest = json.load(open(state / "manifest.json"))
    assert manifest["batches_done"] == 1
    assert int(np.load(state / "batch001.npz")["next_chunk"]) == 2
    resumed = northstar(state, "--max-seconds", "1e6")
    assert set(resumed) == set(whole)
    for key in ("curves", "period_grid", "cadences", "run_batch",
                "chunk_periods", "data_source", "recovery_rate", "n_runs"):
        assert resumed[key] == whole[key], key
    assert len(resumed["batch_seconds"]) == 3     # batch 1 was resumed
    for ib in range(4):
        a = np.load(tmp_path / "whole" / "done" / f"batch{ib:03d}.npz")
        b = np.load(state / "done" / f"batch{ib:03d}.npz")
        for f in FIELDS:
            assert np.array_equal(a[f], b[f]), (ib, f)
    # a second complete run joins the record's history
    again = northstar(state, "--max-seconds", "1e6")
    assert again["n_runs"] == 2 and len(again["runs"]) == 2


@pytest.mark.parametrize("missing", ["run_batch", "mode"])
def test_northstar_refuses_a_manifest_without(tmp_path, small_northstar,
                                              missing):
    state = tmp_path / "state"
    state.mkdir()
    manifest = {"batches_done": 1, "wall_s": 1.0, "recovered": 8,
                "curves": 8, "batch_seconds": [1.0], "mode": "synthetic",
                "run_batch": 8}
    del manifest[missing]
    (state / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(SystemExit, match=missing):
        northstar(state)


def test_northstar_fits_mode_reads_the_sector(tmp_path, small_northstar):
    """Fits mode writes the sector first and streams it through the
    loader: each batch's winners are a SweepRunner's on the files' values
    (the flux and its error in float32)."""
    from lightkurve_tpu_torch.batch import LightCurveStack
    from lightkurve_tpu_torch.parallel.checkpoint import SweepRunner
    fits = tns.run(tns.parse_args(
        ["--device", "cpu", "--state-dir", str(tmp_path / "fits"),
         "--sector-dir", str(tmp_path / "sector"), "--batches", "2"]))
    assert len(os.listdir(tmp_path / "sector")) == 16
    assert fits["data_source"] == "fits_files" and fits["curves"] == 16
    t = tms.time_grid()
    periods = np.linspace(1.0, (t[-1] - t[0]) / 3, tns.P_GRID)
    for ib in range(2):
        flux = np.concatenate([tms.batch_flux(g, t)[0]
                               for g in (2 * ib, 2 * ib + 1)])
        stack = LightCurveStack.from_numpy(
            np.broadcast_to(t, flux.shape), flux.astype(np.float32),
            np.full(flux.shape, tms.NOISE, np.float32),
            np.ones(flux.shape, bool), device="cpu", dtype=torch.float64)
        want = SweepRunner(stack, periods, tns.DURATIONS,
                           str(tmp_path / f"want{ib}.npz"),
                           chunk_periods=12, method="shared").run()
        got = np.load(tmp_path / "fits" / "done" / f"batch{ib:03d}.npz")
        for f in FIELDS:
            np.testing.assert_allclose(got[f], want[f], rtol=1e-12,
                                       err_msg=f)


# ---------------------------------------------------------------------------
# the examples
# ---------------------------------------------------------------------------
def test_sector_search_equals_the_jax_examples_computation(tmp_path,
                                                           monkeypatch):
    from lightkurve_tpu.io.pipeline import StreamingStackLoader as JLoader
    from lightkurve_tpu.parallel.grid import best_candidates as jbest
    monkeypatch.setattr(tsector, "N_TARGETS", 6)
    monkeypatch.setattr(tsector, "N_CADENCES", 1024)
    monkeypatch.setattr(tsector, "N_PLANETS", 2)
    monkeypatch.setattr(tsector, "BATCH", 4)
    monkeypatch.setattr(tsector, "PERIODS", (1.0, 3.0, 96))
    paths, injected = tsector.make_demo_sector(str(tmp_path))
    ours = tsector.search(paths, device="cpu", dtype=torch.float64)
    periods = np.linspace(*tsector.PERIODS)
    theirs = []
    for stack in JLoader(paths, batch_size=4, prefetch=2,
                         dtype=jnp.float64):
        out = stack.flatten().bls_search(periods, tsector.DURATIONS,
                                         objective="snr")
        per, pw = jbest(out["power"], periods, k=1)
        theirs += [(m["FILENAME"], float(per[j, 0]), float(pw[j, 0]))
                   for j, m in enumerate(stack.meta) if not m.get("PADDING")]
    assert [r[0] for r in ours] == [r[0] for r in theirs] == paths
    assert [r[1] for r in ours] == [r[1] for r in theirs]
    np.testing.assert_allclose([r[2] for r in ours], [r[2] for r in theirs],
                               rtol=1e-9)
    assert tsector.report(ours, 1.0, injected) == \
        tsector.report(theirs, 1.0, injected)


def test_multi_sector_sweep_equals_the_jax_examples_computation(monkeypatch,
                                                                tmp_path):
    from lightkurve_tpu.batch import LightCurveStack as JStack
    from lightkurve_tpu.parallel.checkpoint import SweepRunner as JRunner
    for name, value in (("B", 12), ("N", 768), ("P", 96)):
        monkeypatch.setattr(tmulti, name, value)
    times, flux = tmulti.demo_arrays()
    ours = tmulti.sweep(times, flux, device="cpu", dtype=torch.float64)
    stack = JStack(time=jnp.asarray(times), flux=jnp.asarray(flux),
                   flux_err=jnp.full(flux.shape, 2e-4),
                   mask=jnp.ones(flux.shape, bool))
    theirs = JRunner(stack, np.linspace(*tmulti.GRID, tmulti.P),
                     tmulti.DURATIONS, str(tmp_path / "j.npz"),
                     chunk_periods=tmulti.P, method="shared").run()
    for f in FIELDS:
        np.testing.assert_allclose(ours[f], theirs[f], rtol=1e-9,
                                   atol=1e-12, err_msg=f)
    assert np.all(np.abs(ours["period"] - tmulti.P_TRUE) / tmulti.P_TRUE
                  < 0.01)


# ---------------------------------------------------------------------------
# the card by default
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("call", ["bench", "northstar", "sector_search",
                                  "multi_sector_sweep"])
def test_entry_points_refuse_to_run_without_the_card(tmp_path, call):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    run = {"bench": lambda: bench.run(),
           "northstar": lambda: tns.main(
               ["--mode", "synthetic", "--state-dir", str(tmp_path)]),
           "sector_search": lambda: tsector.search([str(tmp_path / "x")]),
           "multi_sector_sweep": lambda: tmulti.main([])}[call]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run()
