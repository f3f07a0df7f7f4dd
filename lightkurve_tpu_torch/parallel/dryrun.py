"""The multi-rank dry run: the reference's three phases on N ranks.

Counterpart of ``__graft_entry__.dryrun_multichip`` (which drives
``lightkurve_tpu`` on a mesh of devices).  :func:`dryrun_multichip` spawns
``n_ranks`` gloo ranks (:func:`.launch.run_ranks`; on one card every rank
shares it) and runs, at the reference's sizes and bars:

1. the batched flatten, then :func:`.grid.sharded_bls` on a 2-D mesh,
   the injected period recovered;
2. ``SweepRunner(mesh=...)`` over 256 curves x 4,096 cadences x an
   8,192-period grid, four chunks, and a run killed after two chunks and
   resumed by a fresh runner, equal bit for bit;
3. a targets-only mesh on a batch whose size the ranks do not divide,
   ``sharded_bls`` against the unsharded search (rtol = atol = 1e-6) and
   ``sharded_lombscargle`` against the unsharded one (rtol 1e-5, atol
   1e-8); then the two-slice layout (2 x N/2) against the unsharded search.

It raises if any rank fails.  :func:`mesh_sweep` (phase 2's kill and
resume) serves callers that run their own ranks.
"""
from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import torch

__all__ = ["dryrun_multichip", "dryrun_rank", "mesh_sweep", "SIZES"]

#: the reference's sizes: phase 2's sweep (curves, cadences, grid
#: periods, periods per chunk, chunks run) and phase 3's frequencies
SIZES = dict(sweep_curves=256, sweep_cadences=4096, sweep_periods=8192,
             sweep_chunk=128, sweep_chunks=4, ls_frequencies=1024)


def _example_batch(B, N, device, dtype=torch.float32):
    """``__graft_entry__._example_batch``: B curves on one 0.02-d grid,
    2e-3 noise, a 0.01-deep 0.12-d transit at 2.3456 d in every curve,
    64 periods of 1.5-4 d, durations 0.1 and 0.2 d."""
    rng = np.random.default_rng(0)
    t = np.arange(N) * 0.02
    time_ = np.broadcast_to(t, (B, N)).copy()
    flux = 1.0 + 2e-3 * rng.standard_normal((B, N))
    P_true, dur, depth = 2.3456, 0.12, 0.01
    ph = np.mod(t - 0.7 + P_true / 2, P_true) - P_true / 2
    flux[:, np.abs(ph) < dur / 2] -= depth
    dy = np.full((B, N), 2e-3)
    put = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa
    return (put(time_), put(flux), put(dy), put(np.linspace(1.5, 4.0, 64)),
            put(np.array([0.1, 0.2])))


# a rank function for the multi-rank tests: it lives here, not in a test
# module, because a spawned rank re-imports its target's module
def _describe_meshes(layouts):
    """``make_mesh(*layout)`` for each layout on this rank: its shape,
    coordinate and device, or the ``ValueError`` it raises."""
    from .grid import make_mesh
    out = []
    for layout in layouts:
        try:
            m = make_mesh(*layout)
        except ValueError as e:
            out.append(dict(error=str(e)))
            continue
        out.append(dict(shape=dict(m.shape), coordinate=m.coordinate,
                        device=str(m.device)))
    return out


def mesh_sweep(stack, periods, durations, directory, mesh, n_chunks=None,
               kill_after=2, tag="sweep", **kw):
    """``SweepRunner(mesh=...)`` over ``stack`` on every rank of ``mesh``:
    ``n_chunks`` chunks (default all) one ``run(max_chunks=1)`` at a time,
    then a run killed after ``kill_after`` chunks and resumed for the rest
    by a fresh runner, each from its own checkpoint in ``directory`` (one
    directory for every rank).  Returns the uninterrupted and the resumed
    states, each chunk's seconds on this rank and the gathers' seconds per
    chunk (the mesh's, over the uninterrupted run)."""
    from .checkpoint import SweepRunner
    first = os.path.join(directory, f"{tag}_ref.npz")
    runner = SweepRunner(stack, periods, durations, first, mesh=mesh, **kw)
    n_chunks = runner.n_chunks if n_chunks is None else n_chunks
    chunk_s, gather_s = [], []
    for _ in range(n_chunks):
        before = len(mesh.gather_seconds)
        if stack.device.type == "cuda":
            torch.cuda.synchronize(stack.device)
        t0 = time.perf_counter()
        ref = runner.run(max_chunks=1)
        chunk_s.append(time.perf_counter() - t0)
        gather_s.append(float(sum(mesh.gather_seconds[before:])))
    killed = os.path.join(directory, f"{tag}_kill.npz")
    r1 = SweepRunner(stack, periods, durations, killed, mesh=mesh, **kw)
    r1.run(max_chunks=kill_after)
    if r1.done:
        raise AssertionError("the killed run finished its sweep")
    del r1                                             # "crash"
    r2 = SweepRunner(stack, periods, durations, killed, mesh=mesh, **kw)
    if r2.next_chunk != kill_after:
        raise AssertionError(f"resume lost the checkpoint position: chunk "
                             f"{r2.next_chunk}, not {kill_after}")
    resumed = r2.run(max_chunks=n_chunks - kill_after)
    return dict(uninterrupted=ref, resumed=resumed, chunk_seconds=chunk_s,
                gather_seconds=gather_s)


def dryrun_rank(n_ranks, directory, sizes):
    """One rank of :func:`dryrun_multichip` (``directory`` is shared by
    every rank).  Returns its log lines."""
    from ..batch import LightCurveStack
    from ..ops.bls import bls_power_shared_batch
    from ..ops.detrend import flatten_batch
    from ..ops.lombscargle import lombscargle_fast
    from ..ops.savgol import savgol_design_matrix
    from .grid import make_mesh, sharded_bls, sharded_lombscargle
    lines = []
    s = dict(SIZES, **sizes)
    # 2-D mesh whenever possible: targets and grid both sharded
    n_t = 2 if n_ranks % 2 == 0 and n_ranks > 1 else 1
    mesh = make_mesh(n_targets_axis=n_t, n_grid_axis=n_ranks // n_t)
    dev = mesh.device

    # ---- phase 1: flatten, then sharded BLS; the period recovered -----
    time_, flux, dy, periods, durations = _example_batch(4, 256, dev)
    mask = torch.ones(flux.shape, dtype=torch.bool, device=dev)
    trend, _ = flatten_batch(time_, flux, mask, savgol_design_matrix(31, 2),
                             5.0, 3.0, niters=2)
    out = sharded_bls(time_, flux / trend, dy, periods, durations,
                      oversample=5, mesh=mesh, chunk=8)
    power = out["power"].cpu().numpy()
    if power.shape != (flux.shape[0], periods.shape[0]):
        raise AssertionError(f"phase 1 power shape {power.shape}")
    if not np.isfinite(power).all():
        raise AssertionError("phase 1 power not finite")
    best = float(out["period"][0, int(np.argmax(power[0]))])
    if abs(best - 2.3456) >= 0.2:
        raise AssertionError(f"dry-run recovered period {best}")
    lines.append(f"dryrun_multichip phase1 OK on mesh {mesh.shape}: power "
                 f"{power.shape}, best period {best:.4f}")

    # ---- phase 2: SweepRunner on the mesh, killed and resumed ---------
    B, Nn, P = s["sweep_curves"], s["sweep_cadences"], s["sweep_periods"]
    rng = np.random.default_rng(42)
    t2 = np.arange(Nn) * 0.003
    Y = 1.0 + 2e-4 * rng.standard_normal((B, Nn))
    p_true = 0.81
    ph = np.mod(t2 - 0.2 + p_true / 2, p_true) - p_true / 2
    Y[:, np.abs(ph) < 0.02] -= 3e-3
    stack = LightCurveStack.from_numpy(
        np.broadcast_to(t2, (B, Nn)), Y, np.full((B, Nn), 2e-4),
        np.ones((B, Nn), bool), device=dev, dtype=torch.float32)
    chunk = s["sweep_chunk"]
    sweep = mesh_sweep(stack, np.linspace(0.8, 1.1, P), np.array([0.2]),
                       directory, mesh, n_chunks=s["sweep_chunks"],
                       chunk_periods=chunk, oversample=2, method="shared")
    lines.append(
        f"dryrun_multichip phase2: mesh {mesh.shape}, B={B} N={Nn} P={P} "
        f"chunk={chunk} ({chunk // mesh.shape['grid']} periods/shard, "
        f"{-(-B // mesh.shape['targets'])} targets/shard); per-chunk "
        f"seconds: {[round(x, 2) for x in sweep['chunk_seconds']]}")
    ref, res = sweep["uninterrupted"], sweep["resumed"]
    for f in ("power", "period", "depth", "transit_time"):
        if not np.array_equal(res[f], ref[f]):
            raise AssertionError(f"kill/resume mismatch in {f}")
    bp = float(ref["period"][np.argmax(ref["power"])])
    if abs(bp - p_true) >= 0.02:
        raise AssertionError(f"phase2 winner period {bp}")
    lines.append(f"dryrun_multichip phase2 OK: kill/resume state equal; "
                 f"winner period {bp:.4f} (injected {p_true})")

    # ---- phase 3: targets-only mesh, ragged batch, sharded LS ---------
    mesh_t = make_mesh(n_targets_axis=n_ranks, n_grid_axis=1)
    B3, N3, P3 = 3 * n_ranks + 1, 512, 256
    rng3 = np.random.default_rng(7)
    t3 = np.arange(N3) * 0.02
    Y3 = 1.0 + 1e-3 * rng3.standard_normal((B3, N3))
    p3 = 1.7
    ph3 = np.mod(t3 - 0.5 + p3 / 2, p3) - p3 / 2
    Y3[:, np.abs(ph3) < 0.05] -= 5e-3
    put = lambda a: torch.as_tensor(  # noqa: E731
        np.ascontiguousarray(a), dtype=torch.float32, device=dev)
    time3, flux3 = put(np.broadcast_to(t3, (B3, N3))), put(Y3)
    dy3 = put(np.full((B3, N3), 1e-3))
    grid3, durs3 = put(np.linspace(1.2, 2.4, P3)), put(np.array([0.1, 0.2]))
    out_sharded = sharded_bls(time3, flux3, dy3, grid3, durs3, oversample=5,
                              mesh=mesh_t, uniform_weights=True)
    out_ref = bls_power_shared_batch(time3[0], flux3, dy3, grid3, durs3,
                                     oversample=5, uniform_weights=True)
    np.testing.assert_allclose(out_sharded["power"].cpu().numpy(),
                               out_ref["power"].cpu().numpy(), rtol=1e-6,
                               atol=1e-6,
                               err_msg="ragged sharded BLS != unsharded")
    lines.append(f"dryrun_multichip phase3a OK: targets-only mesh "
                 f"{mesh_t.shape}, ragged B={B3} over {n_ranks} shards "
                 "matches the unsharded search")
    Nf, f0, df = s["ls_frequencies"], 0.05, 0.002
    ls_sharded = sharded_lombscargle(t3, flux3, dy3, f0, df, Nf, mesh=mesh_t)
    ls_ref = lombscargle_fast(t3, flux3, f0, df, Nf, dy=dy3,
                              normalization="psd")
    np.testing.assert_allclose(ls_sharded.cpu().numpy(),
                               ls_ref.cpu().numpy(), rtol=1e-5, atol=1e-8,
                               err_msg="sharded LS != unsharded LS")
    lines.append(f"dryrun_multichip phase3b OK: sharded Lomb-Scargle equals "
                 f"unsharded on ragged B={B3} (Nf={Nf})")
    # the two-slice layout: targets over the outer axis (across hosts, only
    # the winners' gather crosses it), the period grid over the inner one
    if n_ranks % 2 == 0 and n_ranks >= 4:
        mesh_2 = make_mesh(n_targets_axis=2, n_grid_axis=n_ranks // 2)
        out_2 = sharded_bls(time3, flux3, dy3, grid3, durs3, oversample=5,
                            mesh=mesh_2, uniform_weights=True)
        np.testing.assert_allclose(out_2["power"].cpu().numpy(),
                                   out_ref["power"].cpu().numpy(),
                                   rtol=1e-6, atol=1e-6,
                                   err_msg="two-slice mesh BLS mismatch")
        lines.append(f"dryrun_multichip phase3c OK: two-slice mesh (2 "
                     f"slices x {n_ranks // 2} ranks, targets over the "
                     "outer axis, grid over the inner) matches the "
                     "unsharded search")
    return lines


def dryrun_multichip(n_ranks, device=None, **sizes):
    """Run the dry run on ``n_ranks`` spawned gloo ranks on ``device``
    (default :data:`config.default_device`: the card; ranks share the
    host's cards round robin).  ``sizes`` override :data:`SIZES` (smaller
    runs on the CPU).  Prints rank 0's lines; returns every rank's report
    (:func:`.launch.run_ranks`: its lines, kernel launches and plain
    calls).  Raises if any rank fails."""
    from .launch import run_ranks
    with tempfile.TemporaryDirectory(prefix="lk-dryrun-") as tmp:
        reports = run_ranks(n_ranks, dryrun_rank, n_ranks, tmp, sizes,
                            device=device)
    for line in reports[0]["result"]:
        print(line, flush=True)
    return reports
