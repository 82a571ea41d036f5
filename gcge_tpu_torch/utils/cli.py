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

Run the in-package solve of the cube FEM pair with
``python -m gcge_tpu_torch.utils.cli [-fem_nx 12] [-device cpu] [flags]``.
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


def main(argv=None):
    """The in-package program: the cube FEM pair of the port's own
    :mod:`gcge_tpu_torch.io.fem` (``-fem_nx``, default 12), solved on
    ``-device`` (default ``cuda``) with the parameters of the ``-gcge_*``
    flags; prints the eigenvalues.  ``-gcge_print_usage 1`` prints the flag
    table."""
    import sys

    import torch

    from gcge_tpu_torch.io.fem import cube_fem_laplacian
    from gcge_tpu_torch.ops.operators import make_operator
    from gcge_tpu_torch.solvers.gcg import gcg_solve

    argv = list(sys.argv[1:] if argv is None else argv)
    params, extras = params_from_args(argv)
    if extras.get("-gcge_print_usage"):
        print_usage()
    nx = int(argv[argv.index("-fem_nx") + 1]) if "-fem_nx" in argv else 12
    device = torch.device(argv[argv.index("-device") + 1]
                          if "-device" in argv else "cuda")
    rows, cols, a_vals, b_vals, n = cube_fem_laplacian(nx)
    res = gcg_solve(
        make_operator(rows, cols, a_vals, (n, n), device=device),
        make_operator(rows, cols, b_vals, (n, n), device=device), params)
    for i, lam in enumerate(res.eval[: res.nev_conv or params.nev]):
        print(f"  [{i}] {lam:.14e}")
    return res


if __name__ == "__main__":
    main()
