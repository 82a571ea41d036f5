"""The port's command-line layer against gcge_tpu's on the CPU: the driver
``gcge_tpu_torch.utils.cli.main`` against ``examples/gcge_solve.py`` on the
same files (MatrixMarket, gzipped MatrixMarket, PETSc binary), and the nev
sweep ``gcge_tpu_torch.utils.sweep`` against ``gcge_tpu.gcg_solve`` with
``examples/nev_sweep.py``'s settings.

The two packages draw their random starting blocks from different
generators, so every comparison of iterations hands both the same seeded
block: the drivers through ``-resume`` (one ``.npz`` layout for both), the
sweep through ``x0``."""

import dataclasses
import gzip
import importlib.util
import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import scipy.io
import scipy.sparse as sps
import torch

from gcge_tpu.ops.operators import make_operator as j_make_operator
from gcge_tpu.solvers.gcg import GCGParams as JParams
from gcge_tpu.solvers.gcg import gcg_solve as j_gcg_solve
from gcge_tpu_torch.io.fem import cube_fem_laplacian
from gcge_tpu_torch.io.loaders import save_petsc_binary
from gcge_tpu_torch.io.stencil import build_3d27
from gcge_tpu_torch.ops.operators import make_operator
from gcge_tpu_torch.solvers.gcg import gcg_solve
from gcge_tpu_torch.utils import cli, sweep
from gcge_tpu_torch.utils.checkpoint import save_checkpoint

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEV, BS = 10, 4


def _jax_driver():
    """``examples/gcge_solve.py``, loaded by path as ``gcge_tpu``'s
    ``gcge-solve`` loads it."""
    spec = importlib.util.spec_from_file_location(
        "gcge_solve_example", os.path.join(REPO, "examples", "gcge_solve.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def _write_mtx(path, rows, cols, vals, n):
    scipy.io.mmwrite(path, sps.coo_matrix((vals, (rows, cols)), shape=(n, n)),
                     symmetry="symmetric")


def _start(path, n, k, seed):
    """A seeded ``(n, k)`` starting block as a checkpoint file."""
    x0 = np.random.default_rng(seed).standard_normal((n, k))
    save_checkpoint(path, SimpleNamespace(eval=np.zeros(k), evec=x0,
                                          nev_conv=0, num_iter=0))
    return path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The inputs: the 27-point stencil at nx=8 (n=512) as ``.mtx`` and
    ``.mtx.gz``, the same stencil under a seeded random ordering (which RCM
    improves), the cube FEM pair at nx=6 (n=125) as PETSc binary, and a
    starting block for each size."""
    d = tmp_path_factory.mktemp("cli")
    rows, cols, vals, n = build_3d27(8)
    _write_mtx(d / "stencil.mtx", rows, cols, vals, n)
    with open(d / "stencil.mtx", "rb") as src, \
            gzip.open(d / "stencil.mtx.gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    perm = np.random.default_rng(11).permutation(n)
    _write_mtx(d / "shuffled.mtx", perm[rows], perm[cols], vals, n)
    fr, fc, fa, fb, fn = cube_fem_laplacian(6)
    save_petsc_binary(str(d / "fem_a.petsc"), fr, fc, fa, (fn, fn))
    save_petsc_binary(str(d / "fem_b.petsc"), fr, fc, fb, (fn, fn))
    return {
        "stencil": str(d / "stencil.mtx"), "gz": str(d / "stencil.mtx.gz"),
        "shuffled": str(d / "shuffled.mtx"),
        "fem_a": str(d / "fem_a.petsc"), "fem_b": str(d / "fem_b.petsc"),
        "x0_512": _start(str(d / "x0_512.npz"), n, 2 * NEV, 3),
        "x0_125": _start(str(d / "x0_125.npz"), fn, 2 * NEV, 4),
    }


def _run(main, argv, capsys):
    """The driver's result and its printed lines."""
    res = main(argv)
    return res, capsys.readouterr().out.splitlines()


def _both(files, argv, capsys):
    """Both drivers on ``argv`` (the port's on the CPU); their results and
    printed lines."""
    jres, jout = _run(_jax_driver(), argv, capsys)
    tres, tout = _run(cli.main, argv + ["-device", "cpu"], capsys)
    return jres, jout, tres, tout


def _lines(out, *starts):
    return [line for line in out if line.startswith(starts)]


def _evals(res, nev=NEV):
    return np.asarray(res.eval)[:nev]


def _close(a, b, tol):
    return np.max(np.abs(a - b) / np.abs(b)) <= tol


# (matrix flags, extra flags, phased): phased cases are held to the same
# iterations and count, the fused one (gcge_tpu's fused loop takes one
# iteration more, ROADMAP Queue 3) to the eigenvalues only
CASES = {
    "rcm0-mtx": (["stencil"], ["-rcm", "0", "-fuse", "0"], True),
    "rcm1-mtx.gz": (["gz"], ["-rcm", "1", "-fuse", "0"], True),
    "rcm1-shuffled": (["shuffled"], ["-rcm", "1", "-fuse", "0"], True),
    "shift-petsc": (["fem_a", "fem_b"], ["-shift", "2.5", "-fuse", "0"],
                    True),
    "fuse5": (["stencil"], ["-fuse", "5"], False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_driver_matches_jax(files, capsys, case):
    """The same RCM decision, structure and shift lines; phased: the same
    iterations and count, eigenvalues within 1e-10 relative."""
    mats, extra, phased = CASES[case]
    argv = ["-filename_matA", files[mats[0]]]
    if len(mats) > 1:
        argv += ["-filename_matB", files[mats[1]]]
    x0 = files["x0_125"] if mats[0].startswith("fem") else files["x0_512"]
    argv += ["-nevConv", str(NEV), "-blockSize", str(BS), "-resume", x0,
             "-gcge_print_conv", "0"] + extra
    jres, jout, tres, tout = _both(files, argv, capsys)
    same = ("structure:", "after RCM:", "RCM skipped", "operator shifted")
    assert _lines(tout, *same) == _lines(jout, *same)
    decided = _lines(tout, "after RCM:", "RCM skipped")
    assert len(decided) == (case != "rcm0-mtx")
    if case == "rcm1-shuffled":
        assert _lines(tout, "after RCM:")
    assert tres.nev_conv >= NEV
    assert _close(_evals(tres), _evals(jres), 1e-10)
    if phased:
        assert (tres.num_iter, tres.nev_conv) == \
            (jres.num_iter, jres.nev_conv)
        assert _lines(tout, "converged") == _lines(jout, "converged")


def test_driver_shift_solves_the_shifted_pencil(files, capsys):
    """``-shift sigma`` on the FEM pair: the eigenvalues of ``A + sigma B``
    against ``B`` are the unshifted ones plus sigma."""
    argv = ["-filename_matA", files["fem_a"], "-filename_matB",
            files["fem_b"], "-nevConv", str(NEV), "-blockSize", str(BS),
            "-resume", files["x0_125"], "-gcge_print_conv", "0",
            "-device", "cpu"]
    plain, _ = _run(cli.main, argv, capsys)
    shifted, out = _run(cli.main, argv + ["-shift", "2.5"], capsys)
    assert "operator shifted: A + 2.5*B" in out
    assert _close(_evals(shifted) - 2.5, _evals(plain), 1e-10)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_resume_across_packages(files, capsys, writer, tmp_path):
    """A checkpoint that one driver writes (``-checkpoint``,
    ``-checkpoint_every``) resumes in the other (``-resume``): both
    resumed solves take the same iterations, fewer than the solve that
    wrote it, and find the same eigenvalues."""
    ck = str(tmp_path / "ck.npz")
    base = ["-filename_matA", files["stencil"], "-nevConv", str(NEV),
            "-blockSize", str(BS), "-gcge_print_conv", "0", "-fuse", "0"]
    write = _jax_driver() if writer == "jax" else \
        (lambda argv: cli.main(argv + ["-device", "cpu"]))
    first, _ = _run(write, base + ["-resume", files["x0_512"],
                                   "-checkpoint", ck, "-checkpoint_every",
                                   "5"], capsys)
    assert os.path.exists(ck)
    jres, jout, tres, tout = _both(files, base + ["-resume", ck], capsys)
    assert _lines(tout, "resuming") == _lines(jout, "resuming")
    assert tres.num_iter == jres.num_iter < first.num_iter
    assert tres.nev_conv == jres.nev_conv >= NEV
    assert _close(_evals(tres), _evals(jres), 1e-10)


def test_driver_prints_eval_and_evec(files, capsys):
    """``-gcge_print_eval 3 -gcge_print_evec 1``: three eigenvalue lines and
    three ``evec[i][:6]`` lines in both drivers, the simple smallest pair's
    entries the same up to sign."""
    argv = ["-filename_matA", files["stencil"], "-nevConv", str(NEV),
            "-blockSize", str(BS), "-resume", files["x0_512"],
            "-gcge_print_conv", "0", "-fuse", "0", "-gcge_print_eval", "3",
            "-gcge_print_evec", "1"]
    _, jout, tres, tout = _both(files, argv, capsys)
    for out in (jout, tout):
        assert len(_lines(out, "  [")) == 3
        assert len(_lines(out, "  evec[")) == 3
    t0 = np.array(_lines(tout, "  evec[0]")[0].split("=")[1].split(), float)
    j0 = np.array(_lines(jout, "  evec[0]")[0].split("=")[1].split(), float)
    np.testing.assert_allclose(np.abs(t0), np.abs(j0), rtol=1e-5)
    assert np.all(np.sign(t0) == np.sign(t0[0]) * np.sign(j0[0])
                  * np.sign(j0))
    lam = [float(line.split()[1]) for line in _lines(tout, "  [")]
    assert _close(np.array(lam), _evals(tres, 3), 1e-13)


def test_driver_cube_fem_pair_without_a_file(capsys):
    """Without ``-filename_matA`` the driver assembles the cube FEM pair of
    ``-fem_nx`` (as ``examples/gcge_solve.py`` does) and solves it with
    B."""
    res, out = _run(cli.main, ["-fem_nx", "6", "-nevConv", "4",
                               "-blockSize", "2", "-gcge_print_conv", "0",
                               "-device", "cpu"], capsys)
    assert out[0].startswith("loaded n=125 ")
    assert _lines(out, "A layout:")[0].endswith("B layout: DiaOperator")
    assert res.nev_conv >= 4 and 3 * np.pi ** 2 < res.eval[0] < 4 * np.pi ** 2


def test_driver_refuses_a_missing_card_and_group(files, monkeypatch):
    """``-device cuda`` without a card raises (no silent CPU run); so does
    ``-mesh 1`` without a process group or ``torchrun``'s environment; the
    sweep refuses a missing card too."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    argv = ["-filename_matA", files["stencil"], "-nevConv", "4"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sweep.main(["-nx", "4", "-nevs", "2"])
    with pytest.raises(RuntimeError, match="process group"):
        cli.main(argv + ["-device", "cpu", "-mesh", "1"])


def test_driver_tunes_like_solve_unless_a_flag_is_given(files, monkeypatch):
    """The settings ``cli.main`` hands ``gcg_solve``: unless a flag sets
    them, fuse 5 on every device and, on a card (faked here: the operators
    stay on the CPU and the solve is captured, not run), ``solve``'s tuning
    of the inner CG, the mixed stages included; a flag given wins over
    both."""
    import gcge_tpu_torch.ops.operators as operators
    import gcge_tpu_torch.solvers.gcg as gcg

    seen = []

    def captured(a, b, params, **kwargs):
        seen.append(params)
        return SimpleNamespace(nev_conv=0, num_iter=0, eval=np.zeros(0),
                               evec=torch.zeros((a.shape[0], 0)))

    real_make = operators.make_operator
    monkeypatch.setattr(gcg, "gcg_solve", captured)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(operators, "make_operator",
                        lambda *args, device=None: real_make(*args,
                                                             device="cpu"))
    argv = ["-filename_matA", files["stencil"], "-nevConv", "4"]
    flags = ["-fuse", "0", "-gcge_compW_cg_auto_shift", "0"]
    for device, extra in (("cpu", []), ("cuda", []), ("cuda", flags)):
        cli.main(argv + extra + ["-device", device])
    cpu, card, flagged = seen
    assert (cpu.fuse, cpu.cg_auto_shift, cpu.cg_mixed) == (5, False, False)
    assert (card.fuse, card.cg_auto_shift, card.cg_mixed, card.cg_refine) \
        == (5, True, True, 2)
    assert (flagged.fuse, flagged.cg_auto_shift, flagged.cg_mixed) == \
        (0, False, True)
    assert cpu.nev == card.nev == flagged.nev == 4


# ---------------------------------------------------------------------------
# the nev sweep
# ---------------------------------------------------------------------------


def _jax_production(nev):
    """``examples/nev_sweep.py``'s settings, phased and without the TPU's
    mixed CG (as on the CPU)."""
    return JParams(nev=nev, block_size=max(nev // 5, 1), verbose=0,
                   tol_abs=1.0, tol_rel=1e-8, cg_max_iter=30, fuse=0,
                   cg_auto_shift=True, cg_mixed=False)


# block sizes 3 and 6 hold the stencil's eigenvalue clusters (up to 6
# wide); nev 5 and 10 (blocks 1 and 2) meet ROADMAP Queue 3's fault, which
# test_sweep_counts_unconverged_pairs_at_blocks_narrower_than_a_cluster pins
@pytest.mark.parametrize("nx, nev", [(8, 15), (8, 30), (12, 100)])
def test_sweep_row_matches_jax(nx, nev):
    """A sweep row (warm-up, then the timed solve, phased) against
    ``gcge_tpu.gcg_solve`` with the sweep's settings and the same starting
    block: the same iterations and count, eigenvalues within 1e-10.  nx=12,
    nev=100 is the production shape at CPU scale: block 20, nevMax 200,
    m=240."""
    rows, cols, vals, n = build_3d27(nx)
    x0 = np.random.default_rng(nev).standard_normal((n, 2 * nev))
    op = make_operator(rows, cols, vals, (n, n), device="cpu")
    params = dataclasses.replace(sweep.production_params(nev, op), fuse=0)
    assert params.resolved(n).block_size == nev // 5
    assert params.resolved(n).nev_max == 2 * nev
    row = sweep.run_row(op, params, x0=x0)
    jres = j_gcg_solve(j_make_operator(rows, cols, vals, (n, n)), None,
                       _jax_production(nev), x0=x0)
    assert row.block_size == nev // 5 and row.wall_s > 0
    assert (row.result.num_iter, row.result.nev_conv) == \
        (jres.num_iter, jres.nev_conv)
    assert row.result.nev_conv >= nev
    assert _close(_evals(row.result, nev), _evals(jres, nev), 1e-10)


# the fault of ROADMAP Queue 3 ("pairs counted as converged at blocks
# narrower than a cluster"): (package, nev) -> counted pairs whose final
# residual misses the tolerance.  gcge_tpu's entries stand as it counts;
# the port counts again where it would stop and goes on while a counted
# pair fails (gcg._recount), so its entries are 0.
OVERCOUNT = {("torch", 5): 0, ("jax", 5): 2, ("torch", 10): 0,
             ("jax", 10): 0}


@pytest.mark.parametrize("package, nev", list(OVERCOUNT))
def test_sweep_counts_unconverged_pairs_at_blocks_narrower_than_a_cluster(
        package, nev):
    """At nx=8 the stencil's eigenvalue clusters are 3 wide; the sweep's
    settings at nev 5 and 10 take blocks of 1 and 2 (phased, one seeded
    starting block).  Both packages report at least nev converged;
    gcge_tpu counts pairs whose residual ``|A x - lambda x|`` (x of unit
    norm) exceeds ``tol_rel |lambda|``, the port none: the number recorded
    in ``OVERCOUNT``."""
    rows, cols, vals, n = build_3d27(8)
    x0 = np.random.default_rng(nev).standard_normal((n, 2 * nev))
    if package == "torch":
        op = make_operator(rows, cols, vals, (n, n), device="cpu")
        params = dataclasses.replace(sweep.production_params(nev, op),
                                     fuse=0)
        res = gcg_solve(op, None, params, x0=x0)
    else:
        res = j_gcg_solve(j_make_operator(rows, cols, vals, (n, n)), None,
                          _jax_production(nev), x0=x0)
    k = res.nev_conv
    lam = np.asarray(res.eval)[:k]
    x = np.asarray(res.evec)[:, :k]
    x = x / np.linalg.norm(x, axis=0)
    a = sps.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    resid = np.linalg.norm(a @ x - x * lam, axis=0)
    assert k >= nev
    assert int(np.sum(resid > 1e-8 * np.abs(lam))) == \
        OVERCOUNT[(package, nev)]


def test_sweep_main_prints_nev_sweep_rows(capsys):
    """``sweep.main``: ``examples/nev_sweep.py``'s header and one
    ``nev bs wall_s iters conv`` row a configuration, each the count and
    iterations of the port's solve with the sweep's settings."""
    assert sweep.main(["-nx", "6", "-nevs", "15", "-device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("n=216 nnz=") and "submit.sh:34-44" in out[0]
    assert out[1].split() == ["nev", "bs", "wall_s", "iters", "conv"]
    nev, bs, _, iters, conv = out[2].split()
    rows, cols, vals, n = build_3d27(6)
    op = make_operator(rows, cols, vals, (n, n), device="cpu")
    params = sweep.production_params(15, op)
    assert (params.fuse, params.cg_auto_shift, params.cg_mixed) == \
        (5, True, False)
    res = gcg_solve(op, None, params)
    assert (int(nev), int(bs), int(iters), int(conv)) == \
        (15, 3, res.num_iter, res.nev_conv)


def test_wide_kernel_rows_time_the_classes_a_wide_solve_calls():
    """``chip_smoke.wide_classes`` (the kernel 3/4 shapes the card run
    times for a wide solve) holds every class a solve with the sweep's
    settings calls, at CPU scale (nev=30, block 6, m=72), the expand
    (size_x x size_x) of its restarts among them."""
    import sys

    sys.path.insert(0, REPO)
    import chip_smoke

    m, bs, grams, expands = chip_smoke.wide_classes(30)
    assert (m, bs) == (72, 6)
    rows, cols, vals, n = build_3d27(8)
    op = make_operator(rows, cols, vals, (n, n), device="cpu")
    with chip_smoke.TallCalls() as tall:
        row = sweep.run_row(op, sweep.production_params(30, op))
    timed = {("gram",) + c for c in grams} | {("expand",) + c
                                               for c in expands}
    untimed = {k: v for k, v in tall.calls.items() if k not in timed}
    assert tall.iterations == 2 * row.result.num_iter
    assert not untimed
    assert tall.calls["expand", 60, 60] > 0
