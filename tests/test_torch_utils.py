"""The port's utils against gcge_tpu's on the CPU: the ``-gcge_*`` flags,
checkpoints (one ``.npz`` layout for both packages), the mid-solve
checkpoint and resume on both loops (``tests/test_utils.py``'s cases),
``profile_dir``, and the memory and leak tracking."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

from gcge_tpu.ops.operators import DenseOperator as JDense
from gcge_tpu.solvers.gcg import GCGParams as JParams
from gcge_tpu.solvers.gcg import gcg_solve as j_gcg_solve
from gcge_tpu.utils import checkpoint as j_checkpoint
from gcge_tpu.utils import cli as j_cli
from gcge_tpu.utils.meminfo import workspace_bytes as j_workspace_bytes
from gcge_tpu_torch import DenseOperator, GCGParams, gcg_solve, make_operator
from gcge_tpu_torch.utils import checkpoint, cli, meminfo

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _laplacian_1d(n):
    a = sps.diags([-np.ones(n - 1), 2.0 * np.ones(n), -np.ones(n - 1)],
                  [-1, 0, 1], format="csr") * (n + 1)
    exact = (n + 1) * (2 - 2 * np.cos(np.arange(1, n + 1) * np.pi / (n + 1)))
    return a, exact


# ---------------------------------------------------------------------------
# the -gcge_* flags
# ---------------------------------------------------------------------------

_VALUES = {int: "7", float: "0.25", str: "rel"}
_STRINGS = {"-profile_dir": "traces", "-fuse_hotswap": "on",
            "-gcge_compW_cg_auto_shift": "1"}


def _flag_value(flag):
    if flag in _STRINGS:
        return _STRINGS[flag]
    if flag.endswith("_orth_method"):
        return "mgs"
    kind = cli._FLAG_MAP[flag][1] if flag in cli._FLAG_MAP \
        else cli._COMPAT_FLAGS[flag]
    return _VALUES[kind]


def _fields(params):
    return {k: v for k, v in params.__dict__.items() if k != "dtype"}


@pytest.mark.parametrize("flag", list(cli._FLAG_MAP) + list(cli._COMPAT_FLAGS))
def test_params_from_args_matches_jax(flag):
    """Each flag of the table sets the fields gcge_tpu's sets, to the same
    values, and the same extras."""
    assert set(cli._FLAG_MAP) == set(j_cli._FLAG_MAP)
    assert set(cli._COMPAT_FLAGS) == set(j_cli._COMPAT_FLAGS)
    argv = ["-nevConv", "12", flag, _flag_value(flag), "-unknown", "3"]
    ours, extras = cli.params_from_args(argv)
    theirs, j_extras = j_cli.params_from_args(argv)
    assert _fields(ours) == _fields(theirs)
    assert extras == j_extras


def test_params_from_args_reference_command_line():
    """``tests/test_utils.py``'s reference command line, and the usage
    block."""
    argv = (
        "-nevConv 40 -nevMax 90 -blockSize 8 -gcge_max_niter 123 "
        "-gcge_abs_tol 1e-2 -gcge_rel_tol 1e-9 -gcge_min_gap 0.05 "
        "-gcge_compW_cg_max_iter 55 -gcge_compW_cg_rate 1e-3 "
        "-gcge_compW_cg_tol 1e-10 -gcge_compW_cg_tol_type rel "
        "-gcge_compW_cg_auto_shift 1 -gcge_compW_cg_shift -0.5 "
        "-gcge_initX_orth_method bgs -gcge_compW_orth_zero_tol 1e-11"
    ).split()
    p, extras = cli.params_from_args(argv)
    assert _fields(p) == _fields(j_cli.params_from_args(argv)[0])
    assert (p.nev, p.nev_max, p.block_size, p.orth_method) == \
        (40, 90, 8, "bgs")
    assert extras["-gcge_initX_orth_method"] == "bgs"
    lines = []
    cli.print_usage(lambda s="": lines.append(s))
    assert any("-gcge_rel_tol" in line for line in lines)


def test_cli_module_runs_without_jax():
    """``python -m gcge_tpu_torch.utils.cli`` on the cube FEM pair: prints
    the eigenvalues; loads nothing of jax or gcge_tpu."""
    code = "\n".join([
        "import sys, runpy",
        "sys.modules['jax'] = None",
        "sys.argv = ['cli', '-fem_nx', '6', '-device', 'cpu', '-nevConv',"
        " '4', '-blockSize', '2', '-gcge_print_conv', '0']",
        "runpy.run_module('gcge_tpu_torch.utils.cli', run_name='__main__')",
        "bad = [m for m, mod in sys.modules.items() if mod is not None"
        " and m.split('.')[0] in ('jax', 'jaxlib', 'gcge_tpu')]",
        "assert not bad, bad",
    ])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lams = [float(line.split()[1]) for line in out.stdout.splitlines()
            if line.strip().startswith("[")]
    # the discrete pencil's smallest eigenvalue lies above the continuous
    # problem's 3 pi^2, close to it
    assert len(lams) >= 4 and 3 * np.pi ** 2 < lams[0] < 1.2 * 3 * np.pi ** 2
    assert lams == sorted(lams)


def test_utils_exports_match_jax():
    """``gcge_tpu_torch.utils`` exports gcge_tpu's four names
    (``gcge_tpu/utils/__init__.py``), the port's own functions."""
    import gcge_tpu.utils as j_utils
    import gcge_tpu_torch.utils as t_utils

    assert sorted(t_utils.__all__) == sorted(j_utils.__all__)
    assert t_utils.params_from_args is cli.params_from_args
    assert t_utils.print_usage is cli.print_usage
    assert t_utils.save_checkpoint is checkpoint.save_checkpoint
    assert t_utils.load_checkpoint is checkpoint.load_checkpoint


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_checkpoints_load_across_packages(tmp_path):
    """A checkpoint written by gcge_tpu loads in the port and one written by
    the port loads in gcge_tpu: the same arrays and params."""
    n, nev = 120, 4
    a, _ = _laplacian_1d(n)
    dense = a.toarray()
    kw = dict(nev=nev, block_size=2, max_iter=60, verbose=0)
    jr = j_gcg_solve(JDense(jnp.asarray(dense)), None, JParams(**kw))
    tr = gcg_solve(DenseOperator(torch.as_tensor(dense)), None,
                   GCGParams(**kw))
    j_path, t_path = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    j_checkpoint.save_checkpoint(j_path, jr, JParams(**kw))
    checkpoint.save_checkpoint(t_path, tr, GCGParams(**kw))
    ev, evec, conv, meta = checkpoint.load_checkpoint(j_path, device="cpu")
    assert isinstance(evec, torch.Tensor) and evec.device.type == "cpu"
    np.testing.assert_array_equal(ev, np.asarray(jr.eval))
    np.testing.assert_array_equal(evec.numpy(), np.asarray(jr.evec))
    assert conv == jr.nev_conv and meta["nev"] == nev
    ev, evec, conv, meta = j_checkpoint.load_checkpoint(t_path)
    np.testing.assert_array_equal(ev, tr.eval)
    np.testing.assert_array_equal(np.asarray(evec), tr.evec.numpy())
    assert conv == tr.nev_conv
    # the same plain params, but for dtype, which neither writes
    j_meta = checkpoint.load_checkpoint(j_path, device="cpu")[3]
    assert meta == j_meta


def test_checkpoint_resume(tmp_path):
    """A finished solve, saved and reloaded, resumes at once to the
    closed-form eigenvalues (``tests/test_utils.py::test_checkpoint_resume``)."""
    n, nev = 200, 6
    a, exact = _laplacian_1d(n)
    op = DenseOperator(torch.as_tensor(a.toarray()))
    params = GCGParams(nev=nev, block_size=3, max_iter=60, verbose=0)
    res = gcg_solve(op, None, params)
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save_checkpoint(path, res, params)
    _, evec, nev_conv, meta = checkpoint.load_checkpoint(path, device="cpu")
    assert nev_conv >= nev and meta["nev"] == nev
    res2 = gcg_solve(op, None, params, x0=evec[:, :nev])
    assert res2.nev_conv >= nev
    np.testing.assert_allclose(res2.eval[:nev], exact[:nev], rtol=1e-7)
    assert res2.num_iter <= res.num_iter


@pytest.mark.parametrize("fuse", [0, 3])
def test_mid_solve_checkpoint_and_resume(tmp_path, fuse):
    """``checkpoint_every`` during the solve, on the phased loop (every 2
    iterations) and the fused loop (after chunks of 3), then a resume from
    the saved Ritz vectors that converges to the closed-form eigenvalues
    in fewer iterations than a cold solve
    (``tests/test_utils.py::test_mid_solve_checkpoint_and_resume``)."""
    n = 400
    a, exact = _laplacian_1d(n)
    c = a.tocoo()
    op = make_operator(c.row, c.col, c.data, (n, n), device="cpu")
    ck = str(tmp_path / "gcg_ck.npz")
    gcg_solve(op, None, GCGParams(nev=5, block_size=3, max_iter=6, verbose=0,
                                  fuse=fuse, checkpoint_path=ck,
                                  checkpoint_every=2 if fuse == 0 else 1))
    ev, evec, _, meta = checkpoint.load_checkpoint(ck, device="cpu")
    assert evec.shape[0] == n and meta["nev"] == 5 and meta["fuse"] == fuse
    assert np.isfinite(ev).all() and len(ev) == evec.shape[1]
    p2 = GCGParams(nev=5, block_size=3, max_iter=60, verbose=0, fuse=fuse)
    res = gcg_solve(op, None, p2, x0=evec[:, :5])
    cold = gcg_solve(op, None, p2)
    assert res.nev_conv >= 5
    np.testing.assert_allclose(res.eval[:5], exact[:5], rtol=1e-7)
    assert res.num_iter < cold.num_iter


def test_profile_dir_writes_a_trace(tmp_path):
    """``profile_dir``: a Chrome trace of the solve, with its events."""
    import json

    n = 60
    a, _ = _laplacian_1d(n)
    c = a.tocoo()
    op = make_operator(c.row, c.col, c.data, (n, n), device="cpu")
    trace_dir = tmp_path / "trace"
    res = gcg_solve(op, None, GCGParams(nev=3, block_size=3, max_iter=40,
                                        verbose=0,
                                        profile_dir=str(trace_dir)))
    assert res.nev_conv >= 3
    path = trace_dir / "gcg_trace.json"
    assert path.exists()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)


# ---------------------------------------------------------------------------
# memory and leaks
# ---------------------------------------------------------------------------


def test_meminfo_snapshot_and_memwatch(capsys):
    s0 = meminfo.snapshot("cpu")
    assert s0.live_array_bytes >= 0 and "live_arrays" in str(s0)
    # the allocator's counters exist on a card only
    assert s0.bytes_in_use is None and s0.bytes_limit is None
    for args in ((10000, 50), (157464, 50, 10, 100), (500, 7, 3, 0, 4)):
        assert meminfo.workspace_bytes(*args) == j_workspace_bytes(*args)
    with meminfo.MemWatch("test-region", device="cpu"):
        x = torch.ones((1000, 8))
    out = capsys.readouterr().out
    assert "test-region" in out and "+1 arrays" in out
    del x


def test_leaktracker_catches_a_leak_and_leak_check_passes_clean():
    holder = []
    lt = meminfo.LeakTracker("cpu").start()
    holder.append(torch.ones((257, 3), dtype=torch.float32) * 2.0)
    rep = lt.stop()
    assert rep.new_arrays >= 1
    assert ((257, 3), "torch.float32") in rep.groups
    assert "float32" in str(rep)

    def clean(x):
        return x * 2.0 + 1.0

    assert meminfo.leak_check(clean, torch.ones((64, 4)),
                              device="cpu").new_bytes == 0

    def leaky(x):
        holder.append(torch.zeros((129, 5)) + x[0, 0])
        return x

    with pytest.raises(AssertionError, match="129"):
        meminfo.leak_check(leaky, torch.ones((8, 8)), device="cpu")


def test_gcg_solve_steady_state_does_not_leak():
    """A steady-state ``gcg_solve`` leaves no new tensors behind, on both
    loops."""
    n = 400
    a, _ = _laplacian_1d(n)
    c = a.tocoo()
    op = make_operator(c.row, c.col, c.data, (n, n), device="cpu")
    for fuse in (0, 3):
        params = GCGParams(nev=4, block_size=2, max_iter=8, verbose=0,
                           fuse=fuse, cg_mixed=True)

        def run():
            gcg_solve(op, None, params)

        assert meminfo.leak_check(run, device="cpu").new_bytes == 0
