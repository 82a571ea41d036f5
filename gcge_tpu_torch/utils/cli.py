"""The command-line flags of the reference's ``-gcge_*`` namespace — the
counterpart of ``gcge_tpu/utils/cli.py``.

The reference scans argv for its flags (``DefaultGetOptionFromCommandLine``,
``ops_multi_vec.c:58-95``) into the ``GCGSolver`` struct
(``EigenSolverSetParametersFromCommandLine_GCG``,
``ops_eig_sol_gcg.c:1737-1807``), plus its test program's ``-nevConv -nevMax
-blockSize -nevInit``.  :func:`params_from_args` maps the same names onto
:class:`~gcge_tpu_torch.solvers.gcg.GCGParams` with ``gcge_tpu``'s table;
the flags that configure reference internals without a counterpart here are
accepted and recorded, so that existing scripts keep running.

:func:`main` is the command-line eigensolver, the counterpart of
``examples/gcge_solve.py``::

    python -m gcge_tpu_torch.utils.cli -filename_matA A.mtx [-filename_matB B]
        [-nevConv 50] [-blockSize 10] [-rcm 1] [-shift 0] [-fuse 5]
        [-mesh 0] [-device cuda] [-gcge_* flags]

(``gcge-solve-torch`` once installed; ``torchrun --nproc-per-node N -m
gcge_tpu_torch.utils.cli ... -mesh 1`` row-shards it over N ranks).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from gcge_tpu_torch.solvers.gcg import GCGParams

# -flag -> (GCGParams field, type)
_FLAG_MAP = {
    "-nevConv": ("nev", int),
    "-nevMax": ("nev_max", int),
    "-blockSize": ("block_size", int),
    "-nevInit": ("nev_init", int),
    "-gcge_min_gap": ("gap_min", float),
    "-gcge_max_multi": ("multi_max", int),
    "-gcge_max_niter": ("max_iter", int),
    "-gcge_abs_tol": ("tol_abs", float),
    "-gcge_rel_tol": ("tol_rel", float),
    "-gcge_compW_cg_max_iter": ("cg_max_iter", int),
    "-gcge_compW_cg_rate": ("cg_rate", float),
    "-gcge_compW_cg_tol": ("cg_tol", float),
    "-gcge_compW_cg_tol_type": ("cg_tol_type", str),
    "-gcge_compW_cg_auto_shift": ("cg_auto_shift", lambda v: bool(int(v))),
    "-gcge_compW_cg_shift": ("cg_shift", float),
    "-gcge_print_conv": ("verbose", int),
    "-gcge_compW_cg_order": ("cg_order", int),
    "-gcge_check_conv_max_num": ("check_max", int),
    "-profile_dir": ("profile_dir", str),
    "-fuse": ("fuse", int),
    "-fuse_hotswap": ("fuse_hotswap", str),
}

# accepted for compatibility; recorded in `extras`, no effect of their own
_COMPAT_FLAGS = {
    "-gcge_given_nevec": int,
    "-gcge_user_defined_multi_lin_sol": int,
    "-gcge_initX_orth_method": str,
    "-gcge_initX_orth_block_size": int,
    "-gcge_initX_orth_max_reorth": int,
    "-gcge_initX_orth_zero_tol": float,
    "-gcge_compP_orth_method": str,
    "-gcge_compP_orth_block_size": int,
    "-gcge_compP_orth_max_reorth": int,
    "-gcge_compP_orth_zero_tol": float,
    "-gcge_compW_orth_method": str,
    "-gcge_compW_orth_block_size": int,
    "-gcge_compW_orth_max_reorth": int,
    "-gcge_compW_orth_zero_tol": float,
    "-gcge_compRR_min_num": int,
    "-gcge_compRR_min_gap": float,
    "-gcge_compRR_tol": float,
    "-gcge_print_usage": int,
    "-gcge_print_orth_zero": int,
    "-gcge_print_split": int,
    "-gcge_print_eval": int,
    "-gcge_print_evec": int,
    "-gcge_print_time": int,
}

_ORTH_TOL_FLAGS = {
    "-gcge_initX_orth_zero_tol",
    "-gcge_compP_orth_zero_tol",
    "-gcge_compW_orth_zero_tol",
}


def params_from_args(argv: Sequence[str], base: GCGParams | None = None
                     ) -> tuple[GCGParams, dict]:
    """``GCGParams`` from argv, and ``extras``: the compatibility flags that
    were recognized but set no field of their own (an orth method string or
    zero tolerance also sets ``orth_method`` / ``orth_zero_tol``, as in
    ``gcge_tpu``)."""
    base = base or GCGParams()
    fields = {f.name: getattr(base, f.name)
              for f in dataclasses.fields(base)}
    extras: dict = {}
    i = 0
    argv = list(argv)
    while i < len(argv):
        tok = argv[i]
        if tok in _FLAG_MAP and i + 1 < len(argv):
            name, conv = _FLAG_MAP[tok]
            fields[name] = conv(argv[i + 1])
            i += 2
        elif tok in _COMPAT_FLAGS and i + 1 < len(argv):
            extras[tok] = _COMPAT_FLAGS[tok](argv[i + 1])
            if tok in _ORTH_TOL_FLAGS:
                fields["orth_zero_tol"] = float(argv[i + 1])
            if tok.endswith("_orth_method"):
                meth = str(argv[i + 1]).lower()
                if "bgs" in meth or meth == "b":
                    fields["orth_method"] = "bgs"
                elif "mgs" in meth or meth == "m":
                    fields["orth_method"] = "mgs"
                # 'evp' or anything else: the default EVP orthonormalizer
            i += 2
        else:
            i += 1
    return GCGParams(**fields), extras


def print_usage(printer=print):
    """The usage block of the supported flags (the counterpart of
    ``ops_eig_sol_gcg.c:1811-1860``)."""
    d = GCGParams()
    printer("Usage: <program> [<options>]")
    printer("-" * 78)
    printer(f" -nevConv   <i>: number of wanted eigenpairs      (default {d.nev})")
    printer(" -nevMax    <i>: working eigenspace size          (default 2*nevConv)")
    printer(" -blockSize <i>: block size                       (default nevConv/5)")
    printer(" -nevInit   <i>: initial X width                  (default nevMax)")
    printer(f" -gcge_max_niter <i>: max GCG iterations          (default {d.max_iter})")
    printer(f" -gcge_abs_tol   <f>: absolute residual tolerance (default {d.tol_abs})")
    printer(f" -gcge_rel_tol   <f>: relative residual tolerance (default {d.tol_rel})")
    printer(f" -gcge_min_gap   <f>: multiplicity cluster gap    (default {d.gap_min})")
    printer(" -gcge_max_multi <i>: max multiplicity (backoff cap, default blockSize)")
    printer(f" -gcge_compW_cg_max_iter <i>: inner CG iterations (default {d.cg_max_iter})")
    printer(f" -gcge_compW_cg_rate <f>: inner CG reduction rate (default {d.cg_rate})")
    printer(f" -gcge_compW_cg_tol  <f>: inner CG tolerance      (default {d.cg_tol})")
    printer(f" -gcge_compW_cg_tol_type <s>: abs|rel|user        (default {d.cg_tol_type})")
    printer(f" -gcge_compW_cg_auto_shift <i>: auto sigma        (default {int(d.cg_auto_shift)})")
    printer(f" -gcge_compW_cg_shift <f>: manual sigma           (default {d.cg_shift})")
    printer(" (reference -gcge_*_orth_* and -gcge_compRR_* flags are accepted")
    printer("  for compatibility; the port has the EVP, BGS and MGS")
    printer("  orthonormalizers and one replicated eigh, so the other orth and")
    printer("  RR settings have no effect)")


def get_flag(argv: Sequence[str], name: str, default=None, conv=str):
    """The value after ``name`` in argv, converted; ``default`` without it."""
    if name in argv:
        return conv(argv[list(argv).index(name) + 1])
    return default


def driver_params(params: GCGParams, device, a, b=None, given=()
                  ) -> GCGParams:
    """``params`` with the command-line drivers' defaults for the fields
    not named in ``given``: the fused loop in chunks of ``api.CUDA_FUSE`` on
    every device and, on a card, ``solve``'s tuning of the inner CG
    (``api._tuned_defaults``: auto shift, and the mixed f32 stages where
    ``a`` has an f32 form and ``b`` is None or diagonal)."""
    import torch

    from gcge_tpu_torch.api import CUDA_FUSE, _tuned_defaults

    tuned = {"fuse": CUDA_FUSE,
             **_tuned_defaults(torch.device(device), "gcg", a, b)}
    return dataclasses.replace(params, **{
        k: v for k, v in tuned.items() if k not in given})


def _load(path: str):
    """``(rows, cols, vals, shape)`` of a MatrixMarket (``.mtx``,
    ``.mtx.gz``) or PETSc binary file."""
    from gcge_tpu_torch.io.loaders import load_petsc_binary
    from gcge_tpu_torch.io.native import load_matrix_market_native

    if path.endswith((".mtx", ".mtx.gz")):
        return load_matrix_market_native(path)
    return load_petsc_binary(path)


def _mesh(device):
    """The row mesh of ``-mesh 1`` over the default process group, set up
    here from ``torchrun``'s environment where no group is initialized yet
    (a rank's card: ``LOCAL_RANK``); None where the group has one rank.
    Without a group and without that environment it raises, as
    ``solve(distribute=True)`` does."""
    import os

    import torch
    import torch.distributed as dist

    from gcge_tpu_torch.api import _distribution
    from gcge_tpu_torch.parallel import bootstrap

    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
            device = torch.device("cuda", torch.cuda.current_device())
        bootstrap(device=device)
    return _distribution(True, device), dist.get_world_size()


def main(argv=None):
    """The command-line eigensolver (``gcge-solve-torch``), the counterpart
    of ``examples/gcge_solve.py``: loads ``-filename_matA`` (and
    ``-filename_matB``; MatrixMarket or PETSc binary) or assembles the cube
    FEM pair of ``-fem_nx`` (default 12), keeps the RCM ordering where it
    has fewer diagonals, then a smaller bandwidth (``-rcm``, default 1),
    solves ``A + sigma B`` with ``-shift sigma``, row-sharded over the
    default process group with ``-mesh 1`` (``torchrun``), on ``-device``
    (default ``cuda``; no card raises), and prints the converged
    eigenvalues (``-gcge_print_eval``, default 50) and with
    ``-gcge_print_evec 1`` the leading entries of each Ritz vector, in the
    order the solve used.  ``-resume ckpt.npz`` warm-starts from a
    checkpoint, ``-checkpoint path`` and ``-checkpoint_every k`` (default
    10) write one, ``-profile_dir`` writes a trace.  Solver settings come
    from the ``-gcge_*`` flags and ``-fuse``; the fields no flag sets take
    :func:`driver_params`' defaults (the mixed inner CG and ``cg_refine``
    have no flag: they follow the card's tuning).  Returns the
    :class:`~gcge_tpu_torch.solvers.gcg.GCGResult`, ``evec`` on all rows."""
    import sys
    import time

    import torch

    from gcge_tpu_torch.io.fem import cube_fem_laplacian
    from gcge_tpu_torch.io.native import (apply_permutation,
                                          rcm_permutation, structure_stats)
    from gcge_tpu_torch.ops.operators import ShiftedOperator, make_operator
    from gcge_tpu_torch.parallel import gather_rows, pad_problem, \
        shard_operator
    from gcge_tpu_torch.solvers.gcg import gcg_solve

    argv = list(sys.argv[1:] if argv is None else argv)
    device = torch.device(get_flag(argv, "-device", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("-device cuda: no CUDA device here (pass "
                           "-device cpu to solve on the CPU)")
    mesh = world = None
    if get_flag(argv, "-mesh", 0, int):
        mesh, world = _mesh(device)
        device = mesh.device if mesh is not None else device
    say = print if mesh is None or mesh.lead else (lambda *args: None)

    if get_flag(argv, "-gcge_print_usage", 0, int):
        print_usage(say)
    path_a = get_flag(argv, "-filename_matA")
    path_b = get_flag(argv, "-filename_matB")
    t0 = time.time()
    b_trip = None
    if path_a:
        rows, cols, vals, shape = _load(path_a)
        n = shape[0]
        if path_b:
            b_trip = _load(path_b)[:3]
    else:
        rows, cols, vals, b_vals, n = cube_fem_laplacian(
            get_flag(argv, "-fem_nx", 12, int))
        b_trip = (rows, cols, b_vals)
    say(f"loaded n={n} nnz={len(vals)} in {time.time() - t0:.2f}s")
    say("structure:", structure_stats(rows, cols, n))

    if get_flag(argv, "-rcm", 1, int):
        before = structure_stats(rows, cols, n)
        perm = rcm_permutation(rows, cols, n)
        r2, c2, v2 = apply_permutation(rows, cols, vals, perm)
        after = structure_stats(r2, c2, n)
        # keep whichever ordering suits the DIA layout better: fewer
        # diagonals first (natural stencil orderings win), bandwidth second
        if (min(after["n_diagonals"], 65), after["bandwidth"]) < \
                (min(before["n_diagonals"], 65), before["bandwidth"]):
            rows, cols, vals = r2, c2, v2
            if b_trip is not None:
                b_trip = apply_permutation(*b_trip, perm)
            say("after RCM:", after)
        else:
            say("RCM skipped (natural ordering already better):", after)

    a_op = make_operator(rows, cols, vals, (n, n), device=device)
    b_op = None if b_trip is None else \
        make_operator(*b_trip, (n, n), device=device)
    shift = get_flag(argv, "-shift", 0.0, float)
    # the layouts as packed, before any sharding
    layout = "A layout: " + ("ShiftedOperator" if shift
                             else type(a_op).__name__) \
        + (f", B layout: {type(b_op).__name__}" if b_op else ", B = I")
    params, extras = params_from_args(argv)
    params = driver_params(
        params, device, ShiftedOperator(a_op, b_op, shift) if shift else a_op,
        b_op, {_FLAG_MAP[tok][0] for tok in argv if tok in _FLAG_MAP})
    if mesh is not None:
        a_op, b_op, _ = pad_problem(a_op, b_op, mesh.world)
        a_op, b_op = shard_operator(a_op, mesh), shard_operator(b_op, mesh)
    if shift:
        # (A + sigma B) x = mu x instead (the reference driver's pre-shift);
        # A itself is never changed
        a_op = ShiftedOperator(a_op, b_op, shift)
        say(f"operator shifted: A + {shift}*B")
    say(layout)
    if world is not None:
        say(f"distributed over {world} ranks")

    x0 = None
    resume = get_flag(argv, "-resume")
    if resume:
        from gcge_tpu_torch.utils.checkpoint import load_checkpoint

        _, x0, nev_prev, _ = load_checkpoint(resume, device=device)
        say(f"resuming from {resume} ({nev_prev} converged, "
            f"{x0.shape[1]} vectors)")
        if mesh is not None:            # zero rows for the padding
            x0 = torch.nn.functional.pad(
                x0, (0, 0, 0, a_op.shape[0] - x0.shape[0]))
    ckpt = get_flag(argv, "-checkpoint")
    if ckpt:
        params = dataclasses.replace(
            params, checkpoint_path=ckpt,
            checkpoint_every=get_flag(argv, "-checkpoint_every", 10, int))
    result = gcg_solve(a_op, b_op, params, x0=x0, mesh=mesh)
    if mesh is not None:
        result = dataclasses.replace(result,
                                     evec=gather_rows(mesh, result.evec, n))
    if params.profile_dir:
        say(f"profiler trace written to {params.profile_dir}")
    say(f"\nconverged {result.nev_conv} eigenpairs in {result.num_iter} "
        f"iterations")
    shown = min(result.nev_conv or params.nev,
                extras.get("-gcge_print_eval", 50))
    for i, lam in enumerate(result.eval[:shown]):
        say(f"  [{i}] {lam:.14e}")
    if extras.get("-gcge_print_evec", 0):
        ev = result.evec.cpu().numpy()
        for i in range(shown):
            head = " ".join(f"{v:+.6e}" for v in ev[:6, i])
            say(f"  evec[{i}][:6] = {head}")
    return result


if __name__ == "__main__":
    main()
