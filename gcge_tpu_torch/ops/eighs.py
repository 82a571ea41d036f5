"""Projected-problem eigensolvers — the counterpart of ``gcge_tpu/ops/eighs.py``.

Five backends, chosen by :func:`eigh`:

* ``'device'`` (and ``'auto'``, which resolves to it off the TPU, as in
  ``gcge_tpu``): :func:`safe_eigh`, ``torch.linalg.eigh`` in the operand's
  precision with a shift and a NaN guard;
* ``'jacobi'``: :func:`eigh_jacobi`, that eigh as a warm start and then
  :func:`jacobi_polish`, cyclic Jacobi sweeps on ``u0^T h u0``;
* ``'newton'``: :func:`eigh_newton`, masked Newton refinement of the
  eigenvectors at O(m^3) a step plus batched mean-shifted eighs of the
  near-degenerate runs (``gcge_tpu``'s large-m path, and the one its
  structural Rayleigh-Ritz warm start seeds), whose work splits over the
  ranks of a mesh by columns and by cluster blocks;
* ``'host'``: LAPACK on the host (``torch.linalg.eigh`` of a CPU copy).

The Jacobi sweeps run in one launch of a hand-written CUDA kernel on a card
(:func:`jacobi_sweeps`, ``csrc/jacobi.cu``); on CPU tensors they run the
plain systolic round of ``gcge_tpu`` (:func:`jacobi_sweeps_plain`), which is
also the kernel's oracle.

No function here reads a device value back to the host outside
:func:`host_read_allowed`: the data-dependent loops of ``gcge_tpu`` (the
refinement's ``keep_going``, the closing stage's loop) run a fixed trip count
in which the steps after the stop change nothing, the sweep loop exits inside
the kernel, and the branches that skip whole stages (the closing stage and
each of its rounds, GCG's structural warm start) read their flag in the wait
of an eigh that comes before them anyway (:func:`safe_eigh`'s ``extra``).
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from gcge_tpu_torch.ops import _build

# calls since the last reset: each is one wait of the host for the device on
# a card (see host_read_allowed).  "safe_eigh": calls of safe_eigh (a batched
# call counts once); "host": eighs by the host backend
CALLS = {"safe_eigh": 0, "host": 0}
# launches of the Jacobi kernel (csrc/jacobi.cu) since the last reset
LAUNCHES = {"jacobi": 0}
# eigh_newton since the last reset: "calls"; "closing_rounds", the rounds of
# its closing stage that ran (each a batched eigh of up to eight blocks of
# min(512, m) rows and one Jacobi launch on them); under a mesh, the
# collectives of its partition: "gathers" (all_gathers) and "broadcasts"
NEWTON = {"calls": 0, "closing_rounds": 0, "gathers": 0, "broadcasts": 0}
# eigh_newton's work under a mesh since the last reset, by the width it ran
# on in this rank: "cols", its O(m^3) products by their columns (|J_r|);
# "blocks", its batched cluster eighs and Jacobi polishes by their blocks
SPLIT = {"cols": {}, "blocks": {}}

# orth_block takes eigh_newton for Grams of at least this many columns, as
# gcge_tpu does (its F32_WARM_MIN_M).  gcge_tpu's eigh_newton also turns its
# 'auto' warm start to the f32 eigh from here on, because its TPU compiler
# fails on the f64 eigh past about 1000 rows; off the TPU the port's 'auto'
# warm start is the f64 eigh at every m (warm_dtype='f32' asks for the f32
# one), and the environment override GCGE_F32_WARM_MIN_M is not ported
F32_WARM_MIN_M = 768
# m at which gcge_tpu's TPU 'auto' turns from 'jacobi' to 'newton' (kept for
# the same rule's callers; off the TPU 'auto' is 'device')
NEWTON_MIN_M = 256
BACKENDS = ("auto", "device", "jacobi", "newton", "host")


@contextlib.contextmanager
def host_read_allowed(device: torch.device):
    """The one region of the fused iteration in which the host waits for
    the device: ``torch.linalg.eigh`` reads cuSOLVER's ``info`` back, the
    NaN guard reads its flag and the flags a caller gave it (the host
    backend copies its matrix).  A caller that runs under
    ``torch.cuda.set_sync_debug_mode`` to prove that nothing else waits
    finds the mode lifted here, and restored after."""
    mode = torch.cuda.get_sync_debug_mode() if device.type == "cuda" else 0
    if mode == 0:
        yield
        return
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def _read(flags: list) -> list[bool]:
    """0-d bool tensors to Python bools, in one copy."""
    return [bool(f) for f in torch.stack(flags).tolist()]


def safe_eigh(h: torch.Tensor, extra=None, finish=None):
    """``torch.linalg.eigh`` with a shift and a NaN retry; ``h`` one
    matrix or a batch ``(..., m, m)``.

    The base call is always shifted by ``1e-10 * max|diag|`` (eigenvectors
    unchanged, the shift subtracted from the eigenvalues), with a single
    escalation to ``1e-7`` for the matrices whose result holds NaNs — the
    rule of ``gcge_tpu.ops.eighs.safe_eigh`` (under ``vmap`` there), kept
    so both packages see the same spectra.  The NaN test reads one flag back
    to the host.

    ``extra``: a function of the result ``(w, u)`` giving a list of 0-d bool
    tensors that are read in the same copy as the NaN flag; then
    ``(w, u, flags)`` is returned, the flags as Python bools.  A caller
    whose branch needs a device value reads it here, in a wait that happens
    anyway.

    ``finish``: a function of each attempt's ``(w, u, bad)`` (``bad`` the
    NaN flag of each matrix) giving the ``(w, u, bad)`` that the NaN test,
    the retry's select and ``extra`` then see: :func:`eigh_newton`'s
    cluster stage polishes its blocks there and, under a mesh, gathers
    every rank's slice of the batch, so that every rank reads the same
    flags and retries together."""
    scale = h.diagonal(dim1=-2, dim2=-1).abs().amax(-1, keepdim=True) + 1e-300
    eye = torch.eye(h.shape[-1], dtype=h.dtype, device=h.device)

    def attempt(rel_reg: float):
        reg = rel_reg * scale
        w, u = torch.linalg.eigh(h + reg[..., None] * eye)
        w = w - reg
        bad = torch.isnan(w).any(-1) | torch.isnan(u).any(-1).any(-1)
        return (w, u, bad) if finish is None else finish(w, u, bad)

    CALLS["safe_eigh"] += 1
    with host_read_allowed(h.device):
        w, u, bad = attempt(1e-10)
        flags = [bad.any()]
        if extra is not None:
            flags += extra(w, u)
        got = _read(flags)
        if got[0]:
            w2, u2, _ = attempt(1e-7)
            w = torch.where(bad[..., None], w2, w)
            u = torch.where(bad[..., None, None], u2, u)
            if extra is not None:       # the flags of the result returned
                got = [True] + _read(extra(w, u))
    if extra is None:
        return w, u
    return w, u, got[1:]


# --------------------------------------------------------------------------
# Jacobi sweeps
# --------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _round_robin_rounds(m: int):
    """Round-robin pairings: m-1 rounds of m/2 disjoint pairs covering all
    index pairs once (circle method).  m must be even.  Returns a tuple of
    (p, q) numpy index arrays per round."""
    assert m % 2 == 0
    players = list(range(m))
    rounds = []
    for _ in range(m - 1):
        p = np.asarray([players[i] for i in range(m // 2)], np.int32)
        q = np.asarray([players[m - 1 - i] for i in range(m // 2)], np.int32)
        lo = np.minimum(p, q)
        hi = np.maximum(p, q)
        rounds.append((lo, hi))
        players = [players[0]] + [players[-1]] + players[1:-1]
    return tuple(rounds)


def _schur_cs(app, aqq, apq):
    """Stable 2x2 symmetric Schur rotation ``(c, s)`` zeroing ``a_pq``
    (Golub & Van Loan), with ``gcge_tpu``'s guards: ``t = 0`` where
    ``|a_pq| <= 1e-300``, ``t = 1`` (45 degrees) where ``tau = 0``, and
    ``tau`` clipped to 1e7 in the stable branch, past which
    ``t = 1/(2 tau)``.  Every operation is one rounded PyTorch operation,
    the order the CUDA kernel repeats."""
    small = apq.abs() <= 1e-300
    apq_safe = torch.where(small, 1.0, apq)
    tau = (aqq - app) / (2.0 * apq_safe)
    big = tau.abs() > 1e7
    tau_c = tau.clamp(-1e7, 1e7)
    t_stable = torch.sign(tau_c) / (tau_c.abs() + torch.sqrt(1.0 + tau_c * tau_c))
    t = torch.where(big, 0.5 / torch.where(big, tau, 1.0), t_stable)
    t = torch.where(tau == 0.0, 1.0, t)
    t = torch.where(small, 0.0, t)
    c = 1.0 / torch.sqrt(1.0 + t * t)
    s = t * c
    return c, s


def _sigma(me: int, device) -> torch.Tensor:
    """The circle method as a position permutation: new[0] = old[0],
    new[1] = old[me-1], new[k] = old[k-1]; of order me-1, so a full sweep
    restores the original order."""
    return torch.as_tensor(np.r_[0, me - 1, np.arange(1, me - 1)],
                           dtype=torch.int64).to(device)


def _jacobi_round_systolic(h, v, sigma):
    """One round of me/2 disjoint rotations on a batch ``(..., me, me)``:
    positions ``(i, me-1-i)`` paired, rows then columns rotated, then every
    matrix permuted by ``sigma`` (``gcge_tpu``'s scatter-free round)."""
    me = h.shape[-1]
    m2 = me // 2
    d = h.diagonal(dim1=-2, dim2=-1)
    apq = h.flip(-1).diagonal(dim1=-2, dim2=-1)[..., :m2]   # h[i, me-1-i]
    c, s = _schur_cs(d[..., :m2], d[..., m2:].flip(-1), apq)
    cr, sr = c[..., :, None], s[..., :, None]
    cc, sc = c[..., None, :], s[..., None, :]
    # rows: (J^T h)[p] = c h[p] - s h[q]; (J^T h)[q] = s h[p] + c h[q]
    top = h[..., :m2, :]
    botf = h[..., m2:, :].flip(-2)                  # row i = h[me-1-i]
    h = torch.cat([cr * top - sr * botf, (sr * top + cr * botf).flip(-2)],
                  dim=-2)
    # cols: (X J)[:, p] = c X[:, p] - s X[:, q]; (X J)[:, q] = s X[:, p] + c X[:, q]
    left = h[..., :, :m2]
    rightf = h[..., :, m2:].flip(-1)
    h = torch.cat([cc * left - sc * rightf, (sc * left + cc * rightf).flip(-1)],
                  dim=-1)
    vl = v[..., :, :m2]
    vrf = v[..., :, m2:].flip(-1)
    v = torch.cat([cc * vl - sc * vrf, (sc * vl + cc * vrf).flip(-1)], dim=-1)
    h = h.index_select(-2, sigma).index_select(-1, sigma)
    v = v.index_select(-1, sigma)
    return h, v


def _off_norm(h1):
    """Largest |off-diagonal entry| of each matrix of the batch."""
    off = h1 - torch.diag_embed(h1.diagonal(dim1=-2, dim2=-1))
    return off.abs().amax((-2, -1))


def jacobi_sweeps_plain(h1: torch.Tensor, sweeps: int):
    """Plain version of the Jacobi kernel: on each matrix of the batch
    ``h1 (..., me, me)`` (me even), up to ``sweeps`` sweeps of ``me - 1``
    systolic rounds, stopping a matrix before a sweep once its largest
    off-diagonal entry is at most ``1e-13 * max|h1|``.  Returns ``(h1, v,
    k)``: the rotated matrices, the accumulated rotations (from the
    identity) and each matrix's sweep count (int32).  Reads the stop flags
    back to the host once a sweep: the kernel's oracle and the CPU path."""
    me = h1.shape[-1]
    sigma = _sigma(me, h1.device)
    v = torch.eye(me, dtype=h1.dtype, device=h1.device).expand(h1.shape)
    v = v.clone()
    scale = torch.clamp(h1.abs().amax((-2, -1)), min=1e-300)
    off_tol = 1e-13 * scale
    k = torch.zeros(h1.shape[:-2], dtype=torch.int32, device=h1.device)
    for _ in range(sweeps):
        go = _off_norm(h1) > off_tol
        if not bool(go.any()):
            break
        h2, v2 = h1, v
        for _ in range(me - 1):
            h2, v2 = _jacobi_round_systolic(h2, v2, sigma)
        h1 = torch.where(go[..., None, None], h2, h1)
        v = torch.where(go[..., None, None], v2, v)
        k = k + go.to(torch.int32)
    return h1, v, k


# shared memory a block of the Jacobi kernel may take (of the H100's 227 KB)
JACOBI_SMEM = 227 * 1024
# the most blocks a cluster of the Jacobi kernel may have (Hopper's
# non-portable cluster size), and the SMs the plan assumes off the card
JACOBI_MAX_CLUSTER = 16
JACOBI_SMS = 132
# the plan gives a block at least this many rows of its matrix
JACOBI_MIN_ROWS = 4


@dataclass(frozen=True)
class JacobiPlan:
    """Launch plan of the Jacobi kernel: a cluster of ``cluster`` blocks a
    matrix, each owning ``rows`` consecutive rows (the last blocks may own
    fewer or none) and running ``threads`` threads; H's two buffers in
    shared memory where ``h_shared`` (else in device memory), V where
    ``v_shared``; ``smem`` bytes of dynamic shared memory a block."""
    cluster: int
    rows: int
    threads: int
    h_shared: bool
    v_shared: bool
    smem: int


def _jacobi_layout(me: int, cluster: int, rows: int) -> JacobiPlan | None:
    """Threads and placement of ``cluster`` blocks of ``rows`` rows: a
    thread per column pair and a group of rows (up to 512 threads of
    pairs, at most 1,024), and the shared memory of ``csrc/jacobi.cu``'s
    layout: H's two buffers where they fit beside the tables, V where it
    fits beside them; None where the tables alone do not fit."""
    m2 = me // 2
    groups = max(1, min(rows, 512 // m2)) if m2 <= 512 else 1
    threads = min(1024, -(-m2 * groups // 32) * 32)
    base = 32 * m2 + 16 * me + 20 * rows + 288
    if base > JACOBI_SMEM:
        return None
    mat = 8 * rows * me
    h_shared = base + 2 * mat <= JACOBI_SMEM
    v_shared = base + mat * (2 * int(h_shared) + 1) <= JACOBI_SMEM
    smem = base + mat * (2 * int(h_shared) + int(v_shared))
    return JacobiPlan(cluster, rows, threads, h_shared, v_shared, smem)


def jacobi_plan(me: int, batch: int, sms: int = JACOBI_SMS,
                cluster: int | None = None, resident=None) -> JacobiPlan:
    """Launch plan of the Jacobi kernel for ``batch`` matrices of order
    ``me`` on a card of ``sms`` SMs.  Of the cluster sizes C from
    ``min(16, sms // batch)`` (at least :data:`JACOBI_MIN_ROWS` rows a
    block) down to 1, each with ``ceil(me / C)`` rows a block and C cut to
    the blocks that own rows, it takes the one of least cost ``waves x
    (rows x me x (2 where V lies in device memory, else 1) + 4,096)``: the
    waves are ``ceil(batch / resident(plan))``, where ``resident(plan)``
    is the number of such clusters the card holds at once
    (``cudaOccupancyMaxActiveClusters``; ``sms // C`` where it is not
    given), 4,096 prices a round's fixed chain in row entries, and V in
    device memory doubles a row's cost (measured on an H100: 8 blocks of
    480 run faster on 9 blocks each with V in shared memory than on 16 in
    two waves, 8 of 512 the other way round).  Ties go to the larger C.
    ``cluster`` forces C (measurements and tests; blocks may then own no
    rows).  A plan the card cannot hold once raises ``RuntimeError``."""
    if me < 2 or me % 2:
        raise ValueError(f"jacobi_plan: even order expected, got {me}")
    if cluster is not None:
        if not 1 <= cluster <= JACOBI_MAX_CLUSTER:
            raise ValueError(f"jacobi_plan: cluster of 1 to "
                             f"{JACOBI_MAX_CLUSTER} blocks, got {cluster}")
        plans = [_jacobi_layout(me, cluster, -(-me // cluster))]
    else:
        top = min(JACOBI_MAX_CLUSTER, max(1, sms // max(batch, 1)),
                  -(-me // JACOBI_MIN_ROWS))
        plans = []
        for c in range(top, 0, -1):
            rows = -(-me // c)
            plans.append(_jacobi_layout(me, -(-me // rows), rows))
    plans = [plan for plan in plans if plan is not None]
    if not plans:
        raise ValueError(f"jacobi_plan: order {me} needs more than "
                         f"{JACOBI_SMEM} bytes of tables a block")
    best, best_cost = None, None
    for plan in plans:
        held = resident(plan) if resident is not None \
            else sms // plan.cluster
        if held < 1:
            continue
        waves = -(-batch // held)
        cost = waves * (plan.rows * me * (1 + (not plan.v_shared)) + 4096)
        if best is None or cost < best_cost:
            best, best_cost = plan, cost
    if best is None:
        plan = plans[-1]
        raise RuntimeError(f"jacobi_plan: the card holds no cluster of "
                           f"{plan.cluster} blocks of {plan.threads} threads "
                           f"and {plan.smem} bytes of shared memory")
    return best


@lru_cache(maxsize=None)
def jacobi_resident(index: int, plan: JacobiPlan) -> int:
    """Clusters of ``plan``'s shape card ``index`` holds at once
    (``cudaOccupancyMaxActiveClusters``), asked once for each shape."""
    with torch.cuda.device(index):
        held = _build.lib().gcge_jacobi_max_clusters(
            plan.cluster, plan.threads, int(plan.h_shared),
            int(plan.v_shared), plan.smem)
    if held < 0:
        _build.check("gcge_jacobi_max_clusters", -held)
    return held


def jacobi_card_plan(me: int, batch: int, device,
                     cluster: int | None = None) -> JacobiPlan:
    """:func:`jacobi_plan` on a card: its SMs, and its occupancy asked
    once for each shape; each plan made once."""
    device = torch.device(device)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return _card_plan(me, batch, index, cluster)


@lru_cache(maxsize=None)
def _card_plan(me: int, batch: int, index: int,
               cluster: int | None) -> JacobiPlan:
    return jacobi_plan(me, batch, _build.sm_count(torch.device("cuda", index)),
                       cluster, lambda plan: jacobi_resident(index, plan))


def jacobi_sweeps(h1: torch.Tensor, sweeps: int, cluster: int | None = None):
    """The Jacobi sweeps of :func:`jacobi_sweeps_plain` on ``h1 (me, me)``
    or ``(B, me, me)``, f64, ``me`` even: on a CUDA tensor one launch of the
    kernel of ``csrc/jacobi.cu`` (a cluster of blocks a matrix; every
    sweep, round and stop test inside it, no host read); on a CPU tensor
    the plain version.  ``cluster`` forces the cluster size (measurements
    and tests; the same bits at every size)."""
    if h1.dim() not in (2, 3) or h1.shape[-1] != h1.shape[-2] \
            or h1.shape[-1] % 2:
        raise ValueError(f"jacobi_sweeps: (B, me, me) or (me, me) with me "
                         f"even expected, got {tuple(h1.shape)}")
    if h1.device.type == "cpu":
        return jacobi_sweeps_plain(h1, sweeps)
    if h1.device.type != "cuda":
        raise ValueError(f"jacobi_sweeps: unsupported device {h1.device}")
    if h1.dtype != torch.float64:
        raise TypeError(f"jacobi_sweeps: the CUDA kernel takes float64, got "
                        f"{h1.dtype}")
    me = h1.shape[-1]
    batch = h1.reshape(-1, me, me).contiguous().clone()
    nb = batch.shape[0]
    v = torch.empty_like(batch)
    k = torch.empty((nb,), dtype=torch.int32, device=h1.device)
    if nb:
        plan = jacobi_card_plan(me, nb, h1.device, cluster)
        # H's second buffer, where it does not live in shared memory
        scratch = batch if plan.h_shared else torch.empty_like(batch)
        with torch.cuda.device(h1.device):
            stream = torch.cuda.current_stream(h1.device).cuda_stream
            err = _build.lib().gcge_jacobi_sweeps(
                batch.data_ptr(), scratch.data_ptr(), v.data_ptr(),
                k.data_ptr(), nb, me, sweeps, plan.cluster, plan.rows,
                plan.threads, int(plan.h_shared), int(plan.v_shared),
                plan.smem, stream)
        _build.check("gcge_jacobi_sweeps", err)
        LAUNCHES["jacobi"] += 1
    return (batch.reshape(h1.shape), v.reshape(h1.shape),
            k.reshape(h1.shape[:-2]))


def jacobi_polish(h, w0, u0, sweeps: int = 3):
    """Polish an approximate eigendecomposition ``(w0, u0)`` of symmetric
    ``h`` (one matrix or a batch): Jacobi sweeps on ``h1 = u0^T h u0``
    (odd m padded with a decoupled dummy slot), stopping once the
    off-diagonal norm reaches the rounding floor (``sweeps`` is the cap).
    Returns ``(w, u)`` ascending.  ``w0`` is not used (``gcge_tpu``'s
    signature)."""
    del w0
    m = h.shape[-1]
    h1 = u0.transpose(-2, -1) @ (h @ u0)
    h1 = 0.5 * (h1 + h1.transpose(-2, -1))
    me = m + (m % 2)
    if me != m:
        h1 = torch.nn.functional.pad(h1, (0, 1, 0, 1))
    h1, v, _ = jacobi_sweeps(h1, sweeps)
    w = h1.diagonal(dim1=-2, dim2=-1)[..., :m]
    v = v[..., :m, :m]
    order = torch.argsort(w, dim=-1, stable=True)
    w = torch.gather(w, -1, order)
    u = torch.gather(u0 @ v, -1, order[..., None, :].expand(u0.shape))
    return w, u


def eigh_jacobi(h, sweeps: int = 2):
    """:func:`safe_eigh` as the warm start, then :func:`jacobi_polish`."""
    w0, u0 = safe_eigh(h)
    return jacobi_polish(h, w0, u0, sweeps=sweeps)


# --------------------------------------------------------------------------
# Large-m eigh: Newton eigenvector refinement + batched cluster rotations
# (gcge_tpu/ops/eighs.py:233-697; its comments give the measurements behind
# each rule)
# --------------------------------------------------------------------------


def _keep(go, new, old):
    """``new`` where the 0-d bool ``go`` holds, else ``old``, elementwise
    over tuples: a loop step that comes after the stop changes nothing."""
    return tuple(torch.where(go, a, b) for a, b in zip(new, old))


def column_ranges(m: int, world: int) -> list[tuple[int, int]]:
    """The contiguous ranges ``[j0, j1)`` of :func:`eigh_newton`'s partition
    of ``m`` columns (or blocks) over ``world`` ranks, one a rank in rank
    order: ``ceil(m / world)`` each, the last ones shorter or empty where
    ``world`` does not divide ``m``, so that the ranges, each padded to the
    same width and gathered in rank order, hold the ``m`` first."""
    k = -(-m // world)
    return [(min(r * k, m), min((r + 1) * k, m)) for r in range(world)]


class _Split:
    """:func:`eigh_newton`'s partition over the ranks of ``mesh`` (a row
    mesh, or every rank of a grid): this rank's columns ``J_r`` of the
    ``m x m`` factors, its slice of a batch of cluster blocks, and the
    collectives that give every rank the whole, the same bits on each.
    Without a mesh (``mesh=None``) one rank holds every column and every
    block, the collectives return their input, and nothing is counted."""

    def __init__(self, mesh, m: int):
        self.mesh = mesh.everyone() if hasattr(mesh, "everyone") else mesh
        self.world, self.rank = ((1, 0) if mesh is None
                                 else (self.mesh.world, self.mesh.rank))
        self.m = m
        self.k = -(-m // self.world)
        self.j = slice(*column_ranges(m, self.world)[self.rank])

    def count(self, kind: str, width: int) -> None:
        if self.mesh is not None:
            widths = SPLIT[kind]
            widths[width] = widths.get(width, 0) + 1

    def start(self, w0, u, warm_h1):
        """Rank 0's warm start ``(w0, u, warm_h1)`` on every rank, by one
        broadcast (``warm_h1`` may be None)."""
        if self.mesh is None:
            return w0, u, warm_h1
        NEWTON["broadcasts"] += 1
        start = [w0[None, :], u] + ([] if warm_h1 is None else [warm_h1])
        start = self.mesh.broadcast(torch.cat(start))
        return (start[0], start[1:self.m + 1],
                None if warm_h1 is None else start[self.m + 1:])

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``a @ b``, ``b`` this rank's columns of an ``m x m`` factor."""
        self.count("cols", b.shape[1])
        return a @ b

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The ``(m, m)`` whose columns ``J_r`` each rank holds as ``x``."""
        if self.mesh is None:
            return x
        NEWTON["gathers"] += 1
        world, rows = self.world, x.shape[0]
        x = torch.nn.functional.pad(x, (0, self.k - x.shape[1]))
        full = self.mesh.gather(x).view(world, rows, self.k)
        return full.permute(1, 0, 2).reshape(rows, world * self.k)[
            :, :self.m].contiguous()

    def block_slice(self, nblk: int) -> slice:
        """This rank's slice of ``nblk`` blocks padded to a multiple of the
        rank count (see :meth:`blocks_padded`)."""
        kb = -(-nblk // self.world)
        return slice(self.rank * kb, (self.rank + 1) * kb)

    def blocks_padded(self, nblk: int) -> int:
        return -(-nblk // self.world) * self.world

    def gather_blocks(self, wb, vb, bad):
        """Every rank's ``(wb, vb, bad)`` of its slice of the blocks, in
        block order, by one all_gather."""
        if self.mesh is None:
            return wb, vb, bad
        NEWTON["gathers"] += 1
        c = wb.shape[-1]
        part = torch.cat([vb, wb[:, None, :],
                          bad.to(vb.dtype)[:, None, None].expand(-1, 1, c)],
                         dim=1)
        full = self.mesh.gather(part)
        return full[:, c], full[:, :c], full[:, c + 1, 0] > 0


def eigh_newton(h, iters: int = 4, theta: float | None = None, cap: int = 64,
                nblk: int | None = None, polish_sweeps: int = 4, warm=None,
                warm_dtype: str = "auto", passes: int | None = None,
                mesh=None, cluster_first: bool | None = None,
                out: str = "replicated", warm_h1=None):
    """Eigendecomposition of symmetric ``h`` for large m (ascending), at
    O(m^3) a step: ``gcge_tpu``'s :func:`eigh_newton`.

    Each pass runs (1) masked Newton refinement ``U <- orth(U (I + E))``,
    ``E = H1 / (d_i - d_j)`` on the pairs whose gap exceeds ``gap_tol = 8
    off0``, with a trust cap on ``||E||_2``, a divergence guard and a
    best-state rollback, and (2) batched cluster rotations: contiguous runs
    of eigenvalues closer than ``gap_tol`` gathered into ``cap``-sized
    blocks, each mean-shifted, eigensolved (one batched :func:`safe_eigh`)
    and Jacobi-polished (one launch of the Jacobi kernel), the rotations
    scattered back.  A closing stage escalates the gap tolerance while the
    coupling stays above the re-entrant floor.

    ``warm``: a ``(w0, u0)`` warm start in place of the eigh; ``warm_h1``:
    ``u0^T h u0`` where the caller knows it (GCG's structural warm start).
    ``warm_dtype``: ``'f32'`` takes the f32 eigh as the warm start, with
    three passes; any other value (``'auto'``, ``'f64'``) the f64 eigh (``gcge_tpu``'s
    ``'auto'`` is ``'f32'`` from :data:`F32_WARM_MIN_M` rows on, where its
    TPU compiler fails on the f64 eigh).  ``theta``, ``cap``, ``nblk``,
    ``polish_sweeps``, ``iters``, ``passes`` and ``cluster_first`` as in
    ``gcge_tpu``.

    The refinement's loop runs ``iters`` steps, each step after its stop
    discarded by a select.  The closing stage and each of its rounds run
    only where their condition, read in the wait of the block eigh before
    them, holds: no wait is added to the eighs'.  ``NEWTON`` counts the
    calls and the closing rounds that ran.

    ``mesh`` (a row mesh or a grid): the O(m^3) work is split over every
    rank of the mesh, ``gcge_tpu``'s analogue of the reference's
    spectrum-sliced ``dsyevx`` (``ops_eig_sol_gcg.c:1084-1189``).  Every
    rank starts from rank 0's ``(w0, u0)`` (and ``warm_h1``), one
    broadcast.  Rank ``r`` then forms the columns ``J_r`` of each ``m x m``
    product (:func:`column_ranges`: contiguous, in rank order, ``m`` need
    not divide) and one all_gather gives every rank the whole: in
    ``h1 = u^T h u``, in the refinement's ``u (I + E)``, its Newton-Schulz
    step and in the cluster stage's ``u S``; the cluster stage's batched
    eigh and Jacobi polish run on this rank's slice of the blocks (padded
    to a multiple of the rank count), whose ``(wb, vb)`` one all_gather
    stitches.  Every O(m^2) step and every flag is computed from gathered
    values, so every rank takes the same branches and ends with the same
    bits, with no broadcast at the end.  ``gcge_tpu`` shards over its
    mesh's first axis; the port splits over every rank of a grid
    (``GridMesh.everyone``), whose rows would otherwise repeat the work.
    The batched eigh of a slice may take another routine than the whole
    batch's, so the result equals ``mesh=None``'s to rounding; on one rank
    it is ``mesh=None``'s bits.  ``NEWTON`` counts the gathers and
    broadcasts, ``SPLIT`` the products' columns and the blocks' slices.

    ``out``: ``'replicated'``, the whole ``u``; ``'cols'``, under a mesh
    this rank's columns ``J_r`` of ``u`` (the explicit form of
    ``gcge_tpu``'s column-sharded result; every rank holds the whole ``u``
    after the last gather anyway), without one the whole ``u``.  ``w`` is
    always whole."""
    if out not in ("replicated", "cols"):
        raise ValueError(f"out must be 'replicated' or 'cols', got {out!r}")
    if passes is not None and passes < 1:
        raise ValueError(f"eigh_newton needs passes >= 1, got {passes}")
    if warm_h1 is not None and warm is None:
        raise ValueError("warm_h1 requires warm")
    m = h.shape[0]
    dev, dt = h.device, h.dtype
    if nblk is None:
        nblk = max(1, min(m // 2, 64))
    NEWTON["calls"] += 1
    split = _Split(mesh, m)
    use_f32_warm = warm is None and warm_dtype == "f32"
    if passes is None:
        passes = 3 if use_f32_warm else 1
    if warm is not None:
        w0, u = warm
    elif use_f32_warm:
        w32, u32 = safe_eigh(h.float())
        w0, u = w32.to(dt), u32.to(dt)
    else:
        w0, u = safe_eigh(h)
    w0, u, warm_h1 = split.start(w0, u, warm_h1)
    scale = torch.clamp(w0.abs().max(), min=1e-300)
    eye = torch.eye(m, dtype=dt, device=dev)
    offmask = 1.0 - eye
    eps = float(torch.finfo(dt).eps)
    off_floor_first = (32.0 * eps) * scale
    off_floor_reent = (1024.0 * eps) * scale
    inf = torch.full((), math.inf, dtype=dt, device=dev)
    idx = torch.arange(m, device=dev)

    def h1_of(u):
        h1 = split.gather(split.mm(u.T, split.mm(h, u[:, split.j])))
        return 0.5 * (h1 + h1.T)

    def gap_tol_of(h1):
        if theta is not None:
            return theta * scale
        off0 = (h1 * offmask).abs().max()
        return torch.clamp(8.0 * off0, min=(64.0 * eps) * scale)

    def refine(u, h1, off_floor):
        """Masked Newton refinement (stage 1): ``iters`` steps, each
        discarded once ``gcge_tpu``'s loop would have stopped; returns the
        best state seen."""
        gap_tol = gap_tol_of(h1)

        def masked(h1):
            d = h1.diagonal()
            delta = d[None, :] - d[:, None]         # delta[j, i] = d_i - d_j
            return delta, delta.abs() > gap_tol

        def masked_off(h1):
            _, mask = masked(h1)
            return torch.where(mask, h1, 0.0).abs().max()

        off_entry = masked_off(h1)
        st = (u, h1, inf, u, h1, inf)           # u, h1, off, best u, h1, off
        for _ in range(iters):
            u_, h1_, _, bu, bh1, boff = st
            off = masked_off(h1_)
            go = (off > off_floor) & (off < 8.0 * off_entry)
            better = off < boff
            bu = torch.where(better, u_, bu)
            bh1 = torch.where(better, h1_, bh1)
            boff = torch.minimum(off, boff)
            delta, mask = masked(h1_)
            e = torch.where(mask, h1_ / torch.where(mask, delta, 1.0), 0.0)
            ea = e.abs()
            e_2 = torch.sqrt(ea.sum(0).max() * ea.sum(1).max())
            e = e * torch.clamp(0.25 / torch.clamp(e_2, min=1e-300), max=1.0)
            j = split.j
            un = split.gather(split.mm(u_, (eye + e)[:, j]))
            g_j = split.mm(un.T, un[:, j])
            un = split.gather(split.mm(un, 1.5 * eye[:, j] - 0.5 * g_j))
            st = _keep(go, (un, h1_of(un), off, bu, bh1, boff), st)
        u, h1, _, bu, bh1, boff = st
        worse = masked_off(h1) > boff
        return (torch.where(worse, bu, u), torch.where(worse, bh1, h1),
                gap_tol)

    def cluster_rotate(u, h1, gap_tol, c=None, nblk_=None, by_len=False,
                       then=None):
        """Batched mean-shifted block eighs on near-degenerate runs (stage
        2).  Returns the rotated ``(u, w)``.  ``then``: a function of the
        rotated ``(u, w)`` returning ``(flags, more)``, queued before the
        block eigh's wait reads its NaN flag, so that ``flags`` (0-d bool
        tensors) are read in that same wait; then ``(u, w, flags, more)``
        is returned, the flags as Python bools."""
        d = h1.diagonal()
        c = cap if c is None else c
        nblk_ = nblk if nblk_ is None else nblk_
        gaps = torch.cat([(2.0 * gap_tol).reshape(1), d[1:] - d[:-1]])
        b0 = gaps > gap_tol                             # cluster starts
        start0 = torch.cummax(torch.where(b0, idx, 0), 0).values
        pos0 = idx - start0
        b = b0 | (pos0 % c == 0)                        # split at cap
        seg = torch.cumsum(b.to(torch.int64), 0) - 1    # segment ids
        seg_len = torch.zeros(m, dtype=torch.int64, device=dev).index_add_(
            0, seg, torch.ones(m, dtype=torch.int64, device=dev))
        len_at = seg_len.index_select(0, seg)
        multi_start = b & (len_at >= 2)
        if by_len:
            pri = torch.where(multi_start, len_at, 0)
            cand = torch.argsort(-pri, stable=True)[:nblk_]
            starts = torch.where(pri.index_select(0, cand) > 0, cand, m)
        else:
            # jnp.nonzero(multi_start, size=nblk_, fill_value=m) by a sort
            starts = torch.sort(torch.where(multi_start, idx, m)).values
            starts = starts[:nblk_]
        # under a mesh padded to a multiple of the rank count
        nb = split.blocks_padded(nblk_)
        if starts.shape[0] < nb:
            starts = torch.cat([starts, starts.new_full(
                (nb - starts.shape[0],), m)])
        valid_blk = starts < m
        lens = torch.where(valid_blk, seg_len.index_select(
            0, seg.index_select(0, torch.clamp(starts, max=m - 1))), 0)
        ar_c = torch.arange(c, device=dev)
        rows = torch.clamp(starts[:, None] + ar_c[None, :], 0, m - 1)
        in_blk = (ar_c[None, :] < lens[:, None]) & valid_blk[:, None]
        sub = h1[rows[:, :, None], rows[:, None, :]]    # (nblk, c, c)
        mvalid = in_blk[:, :, None] & in_blk[:, None, :]
        sub = torch.where(mvalid, sub, 0.0)
        fin = in_blk.to(dt)
        eye_c = torch.eye(c, dtype=dt, device=dev)
        mu = (sub * eye_c).sum((1, 2)) / torch.clamp(fin.sum(1), min=1.0)
        blk_norm = sub.abs().amax((1, 2)) + gap_tol * c
        pad_diag = (ar_c.to(dt) + 2.0)[None, :] * (2.0 * blk_norm)[:, None]
        diag_new = torch.where(in_blk, -mu[:, None], pad_diag)
        sub = sub + diag_new[:, :, None] * eye_c

        # this rank's slice of the blocks, eigensolved and polished here (in
        # safe_eigh's finish); safe_eigh's flags and selects see every
        # rank's
        blocks = sub[split.block_slice(nb)]
        split.count("blocks", blocks.shape[0])

        def finish(wb0, vb0, bad):
            wb, vb = jacobi_polish(blocks, wb0, vb0, sweeps=polish_sweeps)
            return split.gather_blocks(wb, vb, bad)

        def rotate(wb, vb):
            # the block rotations scattered into a block-diagonal m x m one
            # (each entry gets one block's value, the rest adds zeros)
            flat = (rows[:, :, None] * m + rows[:, None, :]).reshape(-1)
            s_rot = torch.zeros(m * m, dtype=dt, device=dev).index_add_(
                0, flat, torch.where(mvalid, vb, 0.0).reshape(-1)).view(m, m)
            covered = torch.zeros(m, dtype=torch.int64,
                                  device=dev).index_add_(
                0, rows.reshape(-1), in_blk.to(torch.int64).reshape(-1)) > 0
            s_rot = s_rot + torch.diag(torch.where(covered, 0.0, 1.0).to(dt))
            w = torch.where(covered, 0.0, d).index_add_(
                0, rows.reshape(-1),
                torch.where(in_blk, wb + mu[:, None], 0.0).reshape(-1))
            return split.gather(split.mm(u, s_rot[:, split.j])), w

        if then is None:
            return rotate(*safe_eigh(blocks, finish=finish))
        done = {}

        def extra(wb0, vb0):
            done["uw"] = rotate(wb0, vb0)
            flags, done["more"] = then(*done["uw"])
            return flags

        _, _, flags = safe_eigh(blocks, extra, finish=finish)
        return (*done["uw"], flags, done["more"])

    def tot_off(h1c):
        return (h1c * offmask).abs().max()

    h1 = warm_h1 if warm_h1 is not None else h1_of(u)
    w = h1.diagonal()
    if cluster_first is None:
        cluster_first = use_f32_warm or warm is not None
    if cluster_first:
        u, w = cluster_rotate(u, h1, gap_tol_of(h1))
        h1 = h1_of(u)
    for p in range(passes - 1):
        u, h1, gap_tol = refine(
            u, h1, off_floor_first if p == 0 else off_floor_reent)
        u, w = cluster_rotate(u, h1, gap_tol)
        h1 = h1_of(u)
    u, h1, gap_tol = refine(
        u, h1, off_floor_first if passes == 1 else off_floor_reent)

    # The closing stage (gcge_tpu/ops/eighs.py:610-680): while the coupling
    # stays above the re-entrant floor, escalate the gap tolerance, rotate
    # the widest runs in blocks of up to c2 and refine again, at most three
    # rounds.  Its trigger (the coupling of the h1 that predates the last
    # cluster stage, widened by sqrt(c2)) and each round's loop condition
    # are computed before the wait of the block eigh that precedes them and
    # read in it: the stage adds no wait of its own.
    c2 = min(512, m)
    nblk2 = max(1, min(8, m // 2))
    stale = tot_off(h1) * math.sqrt(float(c2)) > off_floor_reent
    gt_prev, off_prev = gap_tol, inf

    def first_round(u_new, w_new):
        h1c = h1_of(u_new)
        off = tot_off(h1c)
        return [stale & (off > off_floor_reent) & (off < 0.5 * off_prev)
                & (gt_prev < scale)], h1c

    u, w, (go,), h1c = cluster_rotate(u, h1, gap_tol, then=first_round)
    for _ in range(3):
        if not go:
            break
        gt = torch.maximum(gap_tol_of(h1c), 32.0 * gt_prev)
        off_before = tot_off(h1c)

        def next_round(u_new, w_new):
            u2, h1c2, _ = refine(u_new, h1_of(u_new), off_floor_reent)
            off = tot_off(h1c2)
            return [(off > off_floor_reent) & (off < 0.5 * off_before)
                    & (gt < scale)], (u2, h1c2)

        NEWTON["closing_rounds"] += 1
        _, _, (go,), (u, h1c) = cluster_rotate(
            u, h1c, gt, c=c2, nblk_=nblk2, by_len=True, then=next_round)
        w = h1c.diagonal()
        gt_prev = gt

    order = torch.argsort(w, stable=True)
    w, u = w.index_select(0, order), u.index_select(1, order)
    if out == "cols":
        u = u[:, split.j]
    return w, u


def _host_eigh(h):
    """LAPACK on the host: ``h`` copied to the CPU, ``torch.linalg.eigh``
    there, the result copied back to ``h``'s device.  On a card the copy is
    a wait, inside :func:`host_read_allowed`, counted in ``CALLS["host"]``."""
    CALLS["host"] += 1
    with host_read_allowed(h.device):
        w, u = torch.linalg.eigh(h.cpu())
        return w.to(h.device), u.to(h.device)


def check_backend(backend: str) -> None:
    """Raise ``ValueError`` unless ``backend`` is one of :data:`BACKENDS`."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown eigh backend {backend!r}; expected one of "
                         f"{BACKENDS}")


def eigh(h: torch.Tensor, backend: str = "auto", mesh=None, warm=None,
         warm_h1=None, cluster_first=None, passes=None
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric eigendecomposition, ascending, by ``backend``:
    ``'auto'`` and ``'device'`` :func:`safe_eigh` (``gcge_tpu``'s ``'auto'``
    picks Jacobi or Newton only on a TPU in f64), ``'jacobi'``
    :func:`eigh_jacobi`, ``'newton'`` :func:`eigh_newton` (which alone takes
    ``warm``, ``warm_h1``, ``cluster_first`` and ``passes``), ``'host'``
    LAPACK on the host.  Under a row mesh or a grid ``'newton'`` splits its
    work over the ranks (see :func:`eigh_newton`); every other backend
    solves its (identical) ``h`` on every rank and then takes rank 0's
    ``(w, u)``, one ``m x m`` broadcast, so that the ranks can never take
    different branches on eigenvalues that differ in the last bit."""
    check_backend(backend)
    if backend == "newton":
        return eigh_newton(h, mesh=mesh, warm=warm, warm_h1=warm_h1,
                           cluster_first=cluster_first, passes=passes)
    if backend == "host":
        w, u = _host_eigh(h)
    elif backend == "jacobi":
        w, u = eigh_jacobi(h)
    else:
        w, u = safe_eigh(h)
    if mesh is None:
        return w, u
    wu = mesh.broadcast(torch.cat([w[None, :], u]))
    return wu[0], wu[1:]
