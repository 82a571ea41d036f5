"""GCG — block damping inverse-power eigensolver, phased path — the
counterpart of ``gcge_tpu/solvers/gcg.py``.

Computes the ``nev`` smallest eigenpairs of ``A x = lambda B x`` (A, B
symmetric, B SPD or None) on the subspace ``V = [X | P | W]``: X the current
Ritz vectors, P the previous search directions, W inexact inverse-power
corrections from a block-CG solve of ``(A + sigma B) W = (lambda + sigma) B X``.

The layout of state is ``gcge_tpu``'s: a fixed-width basis
``V : (n, size_x + 2*bs)`` whose P/W occupancy is tracked by counts (invalid
columns are exact zeros), the full ``m x m`` projected matrix with invalid
slots padded by a Gershgorin-large diagonal, the ``cP^T H cP`` recurrence for
the P block, and the host-side convergence and window logic.  Each phase is a
plain function of tensors that runs eagerly; the loop reads a few scalars
back to the host each iteration.  Where ``gcge_tpu`` donates ``v`` to a
jitted phase, the port updates ``v`` in place.

The tall products of the phases run through the CUDA kernels on the card:
every f64 application of a DIA operator (kernel 1), the f32 inner CG of the
mixed branch (kernel 2), the tall Grams (kernel 3) and the tall
recombinations (kernel 4).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from gcge_tpu_torch.ops.eighs import eigh
from gcge_tpu_torch.ops.multivec import col_dots, set_random
from gcge_tpu_torch.ops.operators import (DiagOperator, DiaOperator,
                                          SparseOperator)
from gcge_tpu_torch.ops.osgemm import tall_expand, tall_gram
from gcge_tpu_torch.solvers.bpcg import (BlockPCGParams, block_pcg,
                                         block_pcg_t)
from gcge_tpu_torch.solvers.orth import orth_block_against, orth_within


# --------------------------------------------------------------------------
# parameters / results
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class GCGParams:
    """GCG knobs; names and defaults follow ``gcge_tpu.GCGParams``."""

    nev: int = 30                     # wanted eigenpairs (nevConv)
    block_size: int = 0               # 0 -> auto (nev//5, at least 1)
    nev_max: int = 0                  # 0 -> auto (2*nev)
    nev_init: int = 0                 # 0 -> nev_max
    max_iter: int = 500               # numIterMax
    gap_min: float = 0.01             # multiplicity-cluster backoff
    multi_max: int = 0                # backoff cap; 0 -> block_size
    tol_abs: float = 1e-1
    tol_rel: float = 1e-8
    # W inner solve
    cg_max_iter: int = 30
    cg_rate: float = 1e-2
    cg_tol: float = 1e-14
    cg_tol_type: str = "abs"
    cg_auto_shift: bool = False
    cg_shift: float = 0.0
    cg_order: int = 1          # 2 -> two Krylov stages per solved column
    # mixed-precision inner solve: f32 transposed CG stages (the f32 DIA
    # kernel on the card) with f64 residual refreshes between them; needs
    # B = None or diagonal.  cg_max_iter stays the TOTAL matvec budget and is
    # split evenly over the cg_refine stages.
    cg_mixed: bool = False
    cg_refine: int = 2
    check_max: int = 0                # residual window; 0 -> 2*block_size
    orth_zero_tol: float = 1e-13
    orth_passes: int = 2
    orth_method: str = "evp"
    verbose: int = 1
    dtype: Any = torch.float64
    # fused iterations are not ported yet; 0 is the phased path
    fuse: int = 0
    # not ported yet; setting them raises
    checkpoint_path: Any = None
    profile_dir: Any = None

    def resolved(self, n: int) -> "GCGParams":
        """Fill auto defaults as the reference test program does: bs = nev/5,
        nevMax = 2*nev, nevInit = nevMax."""
        nev = self.nev
        bs = self.block_size or max(nev // 5, 1)
        nev_max = max(self.nev_max or 2 * nev, nev + bs)
        nev_init = self.nev_init or nev_max
        nev_init = max(min(nev_init, nev_max), min(3 * bs, nev_max))
        if nev_max + 2 * bs > n:
            raise ValueError(f"subspace {nev_max}+2*{bs} exceeds problem "
                             f"size {n}")
        multi_max = self.multi_max or bs
        if multi_max > bs:
            raise ValueError(f"multi_max {multi_max} > block_size {bs}")
        return GCGParams(**{**self.__dict__, "nev": nev, "block_size": bs,
                            "nev_max": nev_max, "nev_init": nev_init,
                            "multi_max": multi_max})


@dataclass
class GCGResult:
    eval: np.ndarray            # (size_x,) Ritz values, ascending
    evec: torch.Tensor          # (n, size_x) Ritz vectors
    nev_conv: int
    num_iter: int
    res_norms: np.ndarray       # last residual window (diagnostic)
    timers: dict
    history: list = field(default_factory=list)


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def _matvec(op, x):
    return x if op is None else op.matvec(x)


def _initial_rr(a_op, v, size_x: int, bs: int):
    """First Rayleigh-Ritz on V = [X]: H = X^T A X, eigh, Ritz vectors
    written into the X slots of ``v``."""
    m = size_x + 2 * bs
    x = v[:, :size_x]
    h_xx = tall_gram(x, a_op.matvec(x))
    h_xx = 0.5 * (h_xx + h_xx.T)
    w, c = eigh(h_xx)
    ss_eval = torch.cat([w, w[-1:].expand(m - size_x)])
    ss_evec = torch.eye(m, dtype=v.dtype, device=v.device)
    ss_evec[:size_x, :size_x] = c
    h = torch.zeros((m, m), dtype=v.dtype, device=v.device)
    h[:size_x, :size_x] = h_xx
    ritz = tall_expand(x, c)
    v[:, :size_x] = ritz
    return ss_eval, ss_evec, h, ritz, v


def _residual_norms(a_op, b_op, ritz, ss_eval, c0: int, cw: int):
    """Residual 2-norms of the Ritz window ``[c0, c0+cw)``."""
    cols = ritz[:, c0:c0 + cw]
    lam = ss_eval[c0:c0 + cw]
    r = a_op.matvec(cols) - lam[None, :] * _matvec(b_op, cols)
    return torch.sqrt(col_dots(r, r))


def _compute_p(v, ss_evec, h, act_idx, act_cnt: int, size_x: int, bs: int,
               zero_tol: float, passes: int, orth_method: str = "evp"):
    """The P block: the active window's subspace eigenvectors with their
    X components zeroed, orthonormalized against the X coefficients and
    within (ref scale 1: converged columns' leftovers must deflate), then
    ``P = V cP``.  Also returns ``P^T A P = cP^T H cP``."""
    colmask = (torch.arange(bs, device=v.device) < act_cnt).to(v.dtype)
    c_p = ss_evec[:, act_idx] * colmask[None, :]
    c_p[act_idx, :] = 0.0
    c_x = ss_evec[:, :size_x]
    c_p, p_cnt = orth_block_against(c_p, c_x, None, zero_tol=zero_tol,
                                    passes=passes, ref_scale2=1.0,
                                    method=orth_method, precision="f64")
    v[:, size_x:size_x + bs] = tall_expand(v, c_p)
    h_pp = c_p.T @ (h @ c_p)
    return v, p_cnt, h_pp


def _mixed_inner_solve(a_op, b_op, rhs, xact, fmask, colmask, sigma: float,
                       stage_cg, refine: int, shifted):
    """Mixed-precision refinement: f32 CG stages on the correction, f64
    residual recomputed between stages.  DIA runs the transposed layout
    (kernel 2 on the card); ELL runs the (n, m) layout.  Returns
    ``(None, 0)`` for an operator without an f32 form."""
    dtype = rhs.dtype
    b32 = None if b_op is None else b_op.d.float()
    w = xact
    niters = 0
    if isinstance(a_op, DiaOperator):
        a32 = DiaOperator(a_op.values.float(), a_op.offsets, a_op.n_cols)

        def mv32_t(yt):
            byt = yt if b32 is None else b32[None, :] * yt
            return a32.matvec_t(yt) + sigma * byt

        for _ in range(refine):
            r = (rhs - shifted(w)) * fmask[None, :]
            rt = r.T.float()
            d, info = block_pcg_t(mv32_t, rt, torch.zeros_like(rt), stage_cg,
                                  active0=colmask)
            w = w + d.T.to(dtype)
            niters += info.niters
        return w, niters
    if isinstance(a_op, SparseOperator):
        a32 = SparseOperator(a_op.values.float(), a_op.indices, a_op.n_cols)

        def mv32(y):
            by = y if b32 is None else b32[:, None] * y
            return a32.matvec(y) + sigma * by

        for _ in range(refine):
            r = (rhs - shifted(w)) * fmask[None, :]
            r32 = r.float()
            d, info = block_pcg(mv32, r32, torch.zeros_like(r32), stage_cg,
                                active0=colmask)
            w = w + d.to(dtype)
            niters += info.niters
        return w, niters
    return None, 0


def _compute_w(a_op, b_op, v, ritz, ss_eval, act_idx, act_cnt: int,
               sigma: float, size_x: int, bs: int, cg: BlockPCGParams,
               zero_tol: float, passes: int, cg_order: int = 1,
               mixed: bool = False, refine: int = 2,
               orth_method: str = "evp"):
    """Inverse-power correction block W: for the active window solve
    ``(A + sigma B) w = (lambda + sigma) B x`` from ``x``, then
    B-orthonormalize W against [X | P] and within (rank-revealing) into the
    W slots of ``v``."""
    colmask = torch.arange(bs, device=v.device) < act_cnt
    fmask = colmask.to(v.dtype)
    xact = ritz[:, act_idx] * fmask[None, :]
    lam = ss_eval[act_idx] + sigma
    rhs = lam[None, :] * _matvec(b_op, xact)

    def shifted(y):
        return a_op.matvec(y) + sigma * _matvec(b_op, y)

    if mixed:
        if b_op is not None and not isinstance(b_op, DiagOperator):
            raise ValueError("cg_mixed requires B = None or diagonal")
        stage_cg = cg if refine <= 1 else BlockPCGParams(
            **{**cg.__dict__, "max_iter": -(-cg.max_iter // refine)})
        w, niters = _mixed_inner_solve(a_op, b_op, rhs, xact, fmask, colmask,
                                       sigma, stage_cg, refine, shifted)
        if w is None:
            # no f32 operator for this A (dense, diagonal, user): plain f64
            w, info = block_pcg(shifted, rhs, xact, cg, active0=colmask)
            w = w * fmask[None, :]
            niters = info.niters
        rfin = (rhs - shifted(w)) * fmask[None, :]
        final_res = torch.sqrt(col_dots(rfin, rfin))
    elif cg_order == 2:
        half = max(bs // 2, 1)
        hmask = colmask & (torch.arange(bs, device=v.device) < half)
        w1, info1 = block_pcg(shifted, rhs, xact, cg, active0=hmask)
        w2, info2 = block_pcg(shifted, rhs, w1, cg, active0=hmask)
        hf = hmask.to(v.dtype)[None, :]
        w = torch.cat([(w1 * hf)[:, :half], (w2 * hf)[:, :half]], dim=1)
        w = torch.nn.functional.pad(w, (0, bs - w.shape[1]))[:, :bs]
        niters = info1.niters + info2.niters
        final_res = info2.final_res
    else:
        w, info = block_pcg(shifted, rhs, xact, cg, active0=colmask)
        w = w * fmask[None, :]
        niters, final_res = info.niters, info.final_res
    q = v[:, :size_x + bs]
    bmv = None if b_op is None else b_op.matvec
    w, w_cnt = orth_block_against(w, q, bmv, zero_tol=zero_tol, passes=passes,
                                  method=orth_method, precision="auto")
    v[:, size_x + bs:] = w
    return v, w_cnt, niters, final_res


def _rayleigh_ritz(a_op, v, h_pp, ss_eval, p_cnt, w_cnt, size_x: int,
                   bs: int):
    """Assemble the projected matrix and solve the small eigenproblem:
    X block diag(lambda), X-P block 0, P block from the recurrence, the W
    coupling ``V^T A W`` the only large A-application; invalid slots padded
    with a Gershgorin-large diagonal.  Returns the new Ritz values, subspace
    eigenvectors, projected matrix and Ritz vectors."""
    m = size_x + 2 * bs
    dev, dt = v.device, v.dtype
    ar = torch.arange(bs, device=dev)
    h_vw = tall_gram(v, a_op.matvec(v[:, size_x + bs:]))        # (m, bs)
    h_vw = h_vw * (ar < w_cnt).to(dt)[None, :]

    h = torch.zeros((m, m), dtype=dt, device=dev)
    ix = torch.arange(size_x, device=dev)
    h[ix, ix] = ss_eval[:size_x]
    h[size_x:size_x + bs, size_x:size_x + bs] = h_pp
    h[:, size_x + bs:] = h_vw
    h[size_x + bs:, :size_x + bs] = h_vw[:size_x + bs].T
    h_ww = h_vw[size_x + bs:]
    h[size_x + bs:, size_x + bs:] = 0.5 * (h_ww + h_ww.T)

    valid = torch.cat([torch.ones(size_x, dtype=torch.bool, device=dev),
                       ar < p_cnt, ar < w_cnt])
    fvalid = valid.to(dt)
    h = h * fvalid[None, :] * fvalid[:, None]
    gersh = h.abs().sum(dim=1).max() + 1.0
    w, c = eigh(h + torch.diag((1.0 - fvalid) * gersh))
    act_tot = size_x + p_cnt + w_cnt
    ss_eval_new = torch.where(torch.arange(m, device=dev) < act_tot, w,
                              w[act_tot - 1])
    ritz = tall_expand(v, c[:, :size_x])
    return ss_eval_new, c, h, ritz


def _set_x(v, ritz, size_x: int):
    """ComputeX: copy the Ritz vectors into the X slots of ``v``."""
    v[:, :size_x] = ritz
    return v


def _expand_ritz(v, ss_evec, ritz, size_x_old: int, extra: int):
    """Restart growth: append P/W Ritz combinations as new X columns."""
    new_cols = tall_expand(v, ss_evec[:, size_x_old:size_x_old + extra])
    return torch.cat([ritz, new_cols], dim=1)


# --------------------------------------------------------------------------
# host-side convergence / window logic (numpy, as in gcge_tpu)
# --------------------------------------------------------------------------


def _classify(res, lam, tol_abs, tol_rel):
    """Per-column unconverged flags (the reference criterion)."""
    big = np.abs(lam) > tol_rel
    return np.where(big, (res > tol_abs) | (res > np.abs(lam) * tol_rel),
                    res > tol_abs)


def _check_convergence_host(res, ss_eval_h, c0_eff, scan_from, nev_conv_prev,
                            size_x, bs, tol_abs, tol_rel, gap_min,
                            multi_max=None):
    """nevConv and the active window on host scalars: first unconverged
    index, gapMin multiplicity backoff capped at ``multi_max``, then up to
    ``bs`` unconverged indices, extended past the window if fewer."""
    cw = len(res)
    lam_win = ss_eval_h[c0_eff:c0_eff + cw]
    unconv = _classify(res, lam_win, tol_abs, tol_rel)

    idx = cw
    for i in range(scan_from, cw):
        if unconv[i]:
            idx = i
            break
    idx_floor = 0 if multi_max is None else max(idx - multi_max, 0)
    while idx > idx_floor:
        lam_prev = ss_eval_h[c0_eff + idx - 1]
        lam_cur = ss_eval_h[c0_eff + idx]
        denom = abs(lam_prev) if lam_prev != 0 else 1.0
        if abs((lam_prev - lam_cur) / denom) > gap_min:
            break
        idx -= 1
    nev_conv = max(nev_conv_prev, c0_eff + idx)

    act = [c0_eff + i for i in range(scan_from, cw) if unconv[i]]
    nxt = c0_eff + cw
    while len(act) < bs and nxt < size_x:
        act.append(nxt)
        nxt += 1
    if not act:
        act = list(range(min(nev_conv, size_x - 1),
                         min(nev_conv + bs, size_x)))
    act = act[:bs]
    act_cnt = len(act)
    act_padded = act + [act[-1]] * (bs - act_cnt)
    return nev_conv, np.asarray(act_padded, np.int64), act_cnt


# --------------------------------------------------------------------------
# solve loop
# --------------------------------------------------------------------------


def _init_fill_orth(b_op, x, zero_tol: float, passes: int, orth_method: str):
    """One InitializeX trial: B-orthonormalize the block."""
    bmv = None if b_op is None else b_op.matvec
    return orth_within(x, bmv, zero_tol=zero_tol, passes=passes,
                       method=orth_method, precision="auto")


def _init_x(b_op, x0, size_x: int, n: int, dtype, generator, zero_tol,
            passes, orth_method: str = "evp"):
    """InitializeX: keep user vectors, fill with random, B-orthonormalize;
    re-randomize dependent columns until the block has full rank."""
    if x0 is not None:
        k0 = x0.shape[1]
        pad = set_random(generator, (n, size_x - k0), dtype)
        x = torch.cat([x0.to(dtype), pad], dim=1)
    else:
        x = set_random(generator, (n, size_x), dtype)
    for _ in range(5):
        x, rank = _init_fill_orth(b_op, x, zero_tol, passes, orth_method)
        r = int(rank)
        if r == size_x:
            return x
        x[:, r:] = set_random(generator, (n, size_x - r), dtype)
    raise RuntimeError("InitializeX: could not build a full-rank "
                       "B-orthonormal block")


def _not_ported(params: GCGParams, mesh) -> None:
    if params.fuse > 0:
        raise NotImplementedError("fuse > 0 (fused iterations) is not "
                                  "ported yet (ROADMAP Queue 1 item 8)")
    if mesh is not None:
        raise NotImplementedError("mesh (distribution) is not ported yet "
                                  "(ROADMAP Queue 1 item 12)")
    if params.checkpoint_path:
        raise NotImplementedError("checkpoint_path is not ported yet "
                                  "(ROADMAP Queue 1 item 11)")
    if params.profile_dir:
        raise NotImplementedError("profile_dir is not ported yet "
                                  "(ROADMAP Queue 1 item 11)")


def gcg_solve(a_op, b_op=None, params: GCGParams = GCGParams(),
              x0: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None,
              mesh=None) -> GCGResult:
    """Solve ``A x = lambda B x`` for the ``params.nev`` smallest eigenpairs
    on the operators' device.

    ``x0``: optional ``(n, k)`` starting vectors (numpy or tensor); the rest
    of the block is drawn from ``generator`` (default: seed 0 on the
    device)."""
    _not_ported(params, mesh)
    n = a_op.shape[0]
    p = params.resolved(n)
    bs, nev0 = p.block_size, p.nev
    size_x = p.nev_init
    dtype = p.dtype
    device = a_op.device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    cg = BlockPCGParams(max_iter=p.cg_max_iter, rate=p.cg_rate, tol=p.cg_tol,
                        tol_type=p.cg_tol_type)
    timers = {k: 0.0 for k in ("initX", "checkconv", "compP", "compX",
                               "compW", "linsol", "compRR", "compRV",
                               "total")}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        sync()
        timers[name] += time.perf_counter() - t0
        return out

    # ---- InitializeX + first RR -----------------------------------------
    t_start = time.perf_counter()
    if x0 is not None:
        x0 = torch.as_tensor(x0, dtype=dtype, device=device)
    x = timed("initX", _init_x, b_op, x0, size_x, n, dtype, generator,
              p.orth_zero_tol, p.orth_passes, p.orth_method)
    m = size_x + 2 * bs
    v = torch.zeros((n, m), dtype=dtype, device=device)
    v[:, :size_x] = x
    ss_eval, ss_evec, h, ritz, v = timed("compRR", _initial_rr, a_op, v,
                                         size_x, bs)

    nev_target = nev0 if size_x >= p.nev_max else min(2 * bs, nev0)
    nev_conv = 0
    act_idx_prev = None
    act_cnt_prev = 0
    num_iter = 0
    iter_budget = p.max_iter
    history = []
    res_h = np.zeros((bs,))
    skip_p = True  # no P on the first iteration
    stall = 0

    if p.verbose:
        print(f"GCG: n={n} nev={nev0} bs={bs} sizeX={size_x} "
              f"nevMax={p.nev_max}")
        print("numIter\tnevConv")

    while True:
        # ---- CheckConvergence ------------------------------------------
        if num_iter > 0:
            cw = min(max(p.check_max or 2 * bs, bs), size_x)
            c0 = nev_conv
            c0_eff = min(c0, size_x - cw)
            scan_from = c0 - c0_eff
            res = timed("checkconv", _residual_norms, a_op, b_op, ritz,
                        ss_eval, c0_eff, cw)
            res_h = res.cpu().numpy()
            ss_eval_h = ss_eval.cpu().numpy()
            nev_conv, act_idx, act_cnt = _check_convergence_host(
                res_h, ss_eval_h, c0_eff, scan_from, nev_conv, size_x, bs,
                p.tol_abs, p.tol_rel, p.gap_min, p.multi_max)
            if p.verbose:
                first_unconv = nev_conv if nev_conv < size_x else size_x - 1
                print(f"{num_iter}\t{nev_conv}\t"
                      f"[{first_unconv}] {ss_eval_h[first_unconv]:.14e} "
                      f"(res window max {res_h.max():.4e})")
            history.append((num_iter, nev_conv))
        else:
            ss_eval_h = ss_eval.cpu().numpy()
            act_idx = np.minimum(np.arange(nev_conv, nev_conv + bs),
                                 size_x - 1)
            act_cnt = bs

        # ---- converged / restart growth ----------------------------------
        if nev_conv >= nev_target:
            if nev_conv >= nev0 or size_x >= p.nev_max:
                break
            extra = min(2 * bs, p.nev_max - size_x)
            ritz = _expand_ritz(v, ss_evec, ritz, size_x, extra)
            size_x += extra
            nev_target = min(nev_target + extra, nev0)
            m = size_x + 2 * bs
            v = torch.zeros((n, m), dtype=dtype, device=device)
            v[:, :size_x] = ritz
            ss_eval_h = ss_eval.cpu().numpy()
            lam_new = np.concatenate([ss_eval_h[:size_x],
                                      np.full(2 * bs, ss_eval_h[size_x - 1])])
            ss_eval = torch.as_tensor(lam_new, dtype=dtype, device=device)
            ss_evec = torch.eye(m, dtype=dtype, device=device)
            h = torch.diag(ss_eval[:m])
            h[size_x:, size_x:] = 0.0
            iter_budget -= num_iter
            num_iter = 0
            skip_p = True
            act_idx = np.minimum(np.arange(nev_conv, nev_conv + bs),
                                 size_x - 1)
            act_cnt = bs
            if p.verbose:
                print(f"GCG restart: sizeX -> {size_x}, "
                      f"target -> {nev_target}")

        if num_iter >= iter_budget:
            break

        # ---- ComputeP (previous iteration's active set) ------------------
        if skip_p or act_idx_prev is None:
            p_cnt = 0
            h_pp = torch.zeros((bs, bs), dtype=dtype, device=device)
            v[:, size_x:size_x + bs] = 0.0
            skip_p = False
        else:
            v, p_cnt, h_pp = timed(
                "compP", _compute_p, v, ss_evec, h,
                torch.as_tensor(act_idx_prev, device=device), act_cnt_prev,
                size_x, bs, p.orth_zero_tol, p.orth_passes, p.orth_method)

        # ---- ComputeX ----------------------------------------------------
        v = timed("compX", _set_x, v, ritz, size_x)

        # ---- ComputeW ----------------------------------------------------
        sigma = p.cg_shift
        if p.cg_auto_shift:
            lam_c = ss_eval_h[min(nev_conv, size_x - 2)]
            lam_c1 = ss_eval_h[min(nev_conv + 1, size_x - 1)]
            sigma += float(-lam_c + 0.01 * (lam_c1 - lam_c))
        t0 = time.perf_counter()
        v, w_cnt, cg_iters, cg_res = _compute_w(
            a_op, b_op, v, ritz, ss_eval,
            torch.as_tensor(act_idx, device=device), act_cnt, sigma,
            size_x, bs, cg, p.orth_zero_tol, p.orth_passes, p.cg_order,
            p.cg_mixed, p.cg_refine, p.orth_method)
        sync()
        timers["compW"] += time.perf_counter() - t0
        timers["linsol"] += time.perf_counter() - t0

        act_idx_prev, act_cnt_prev = act_idx, act_cnt

        # ---- RayleighRitz + RitzVec ---------------------------------------
        ss_eval, ss_evec, h, ritz = timed(
            "compRR", _rayleigh_ritz, a_op, v, h_pp, ss_eval, p_cnt, w_cnt,
            size_x, bs)

        p_cnt_h, w_cnt_h = int(p_cnt), int(w_cnt)
        if p.verbose >= 2:
            print(f"  dbg: p_cnt={p_cnt_h} w_cnt={w_cnt_h} "
                  f"cg_iters={cg_iters} sigma={sigma:.3e} "
                  f"cg_res_max={float(cg_res.max()):.3e} "
                  f"act={act_idx[:act_cnt]}")

        # stagnation guard: P and W both deflated -> the subspace is fixed
        if p_cnt_h == 0 and w_cnt_h == 0:
            stall += 1
            if stall >= 2:
                if p.verbose:
                    print("GCG: subspace stagnated (P and W deflated); "
                          "stopping")
                num_iter += 1
                break
        else:
            stall = 0
        num_iter += 1

    timers["total"] = time.perf_counter() - t_start
    total_iter = num_iter + (p.max_iter - iter_budget)
    if p.verbose:
        keys = ("checkconv", "compP", "compRR", "compRV", "compW", "compX",
                "initX")
        tt = max(timers["total"], 1e-12)
        print("|--GCG----------------------------")
        print("|checkconv  compP  compRR  compRV  compW(linsol)  compX  "
              "initX  total")
        print("|" + "  ".join(f"{timers[k]:.2f}" for k in keys + ("total",)))
        print("|" + "  ".join(f"{100 * timers[k] / tt:.1f}%" for k in keys))
        print("|--GCG----------------------------")
        print(f"GCG: {total_iter} iterations, nevConv={nev_conv}, "
              f"{timers['total']:.3f} s")
    return GCGResult(eval=ss_eval[:size_x].cpu().numpy(), evec=ritz,
                     nev_conv=int(nev_conv), num_iter=int(total_iter),
                     res_norms=res_h, timers=timers, history=history)
