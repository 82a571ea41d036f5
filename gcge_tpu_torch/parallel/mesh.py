"""The row mesh of a distributed solve — the counterpart of
``gcge_tpu/parallel/mesh.py``.

The reference distributes A, B and every multivector by row blocks over MPI
ranks (SURVEY.md §2; PETSc ``Mat``/``BV``).  ``gcge_tpu`` does the same on a
1-D ``jax.sharding.Mesh`` that one process drives.  The port follows MPI's
shape: one process per card (or per CPU worker) on ``torch.distributed``,
NCCL for CUDA tensors and gloo for CPU tensors.  A :class:`RowMesh` names the
process group, the rank, the number of ranks and the rank's device; every
tall tensor of a rank holds that rank's rows only, in equal blocks
(:func:`pad_problem` makes ``n`` a multiple of the rank count), and every
contraction over rows is a local product followed by :meth:`RowMesh.psum`.

Not carried over: ``grid_mesh`` (the 2-D mesh, ROADMAP Queue 1 item 12b),
``mv_spec``, ``shard_mv`` and ``replicate``, which place arrays of one
controller on many devices and have no counterpart when each rank holds its
own rows.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist


def backend_for(device) -> str:
    """The ``torch.distributed`` backend of tensors on ``device``: NCCL for a
    card, gloo for the CPU."""
    kind = torch.device(device).type
    if kind == "cuda":
        return "nccl"
    if kind == "cpu":
        return "gloo"
    raise ValueError(f"no torch.distributed backend for device {device}")


@dataclass(frozen=True)
class RowMesh:
    """A 1-D mesh of ``world`` ranks over the rows: ``group`` (the process
    group), this process's ``rank`` in it, its ``device`` and the global
    ranks of the group's members (``peers``, for point-to-point messages).
    Rank ``r`` owns the rows ``[r * n / world, (r + 1) * n / world)`` of an
    ``n``-row problem (:meth:`block`)."""

    group: Any
    rank: int
    world: int
    device: torch.device
    peers: tuple[int, ...]

    def block(self, n: int) -> tuple[int, int]:
        """``(r0, ln)``: the first row and the row count of this rank's
        block of an ``n``-row problem."""
        if n % self.world:
            raise ValueError(f"{n} rows do not split into {self.world} equal "
                             f"blocks: pad the problem first (pad_problem)")
        ln = n // self.world
        return self.rank * ln, ln

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks, in every rank (one
        ``all_reduce``); ``t`` is summed in place where it is contiguous."""
        t = t.contiguous()
        dist.all_reduce(t, group=self.group)
        return t

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum of ``t`` over the ranks, in every rank."""
        t = t.contiguous()
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return t

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``t`` in every rank (in place where contiguous)."""
        t = t.contiguous()
        dist.broadcast(t, src=self.peers[src], group=self.group)
        return t

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The rows of every rank, stacked in rank order: ``(world * ln,
        ...)`` from each rank's ``(ln, ...)``."""
        out = torch.empty((self.world * x.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        # all_gather_single is all_gather_into_tensor's newer name
        gather = getattr(dist, "all_gather_single", None) or \
            dist.all_gather_into_tensor
        gather(out, x.contiguous(), group=self.group)
        return out


def row_mesh(group=None, device=None) -> RowMesh:
    """The row mesh over ``group`` (default: the default process group,
    which must be initialized: ``torchrun``, or
    :func:`gcge_tpu_torch.parallel.multihost.bootstrap`).  ``device``
    defaults to the current card under NCCL and to the CPU under gloo; a
    device of the other kind raises."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("row_mesh needs an initialized default process "
                           "group (torchrun, or "
                           "gcge_tpu_torch.parallel.multihost.bootstrap)")
    group = dist.group.WORLD if group is None else group
    backend = str(dist.get_backend(group))
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) \
            if backend == "nccl" else torch.device("cpu")
    device = torch.device(device)
    if backend_for(device) != backend:
        raise ValueError(f"a {backend} process group cannot carry tensors on "
                         f"{device} (NCCL: cuda, gloo: cpu)")
    world = dist.get_world_size(group)
    peers = tuple(dist.get_global_rank(group, r) for r in range(world))
    return RowMesh(group, dist.get_rank(group), world, device, peers)


def grid_mesh(*args, **kwargs):
    """The 2-D ``(rows, cols)`` mesh of ``gcge_tpu`` is not ported yet."""
    raise NotImplementedError("grid_mesh (the 2-D mesh) is not ported yet "
                              "(ROADMAP Queue 1 item 12b)")


def shard_rows(mesh: RowMesh, x) -> torch.Tensor:
    """This rank's rows of a global ``(n, ...)`` array, on its device."""
    x = torch.as_tensor(x)
    r0, ln = mesh.block(x.shape[0])
    return x[r0:r0 + ln].to(mesh.device).contiguous()


def gather_rows(mesh: RowMesh, x: torch.Tensor, n: int | None = None
                ) -> torch.Tensor:
    """The global array of the ranks' row blocks ``x``, in every rank; its
    first ``n`` rows where given (the rows before :func:`pad_problem`'s
    padding)."""
    full = mesh.gather(x)
    return full if n is None else full[:n]


def pad_problem(a_op, b_op, world: int, pad_value: float | None = None):
    """Pad a problem so that ``n`` splits into ``world`` equal blocks.

    The padded rows must not disturb the smallest eigenpairs, so they get a
    large decoupled diagonal, ``max|a| * n`` for a DIA, CSR or ELL ``a``
    (``1e12`` otherwise), and a unit diagonal in B: their eigenvalues sort
    to the top of the spectrum (``gcge_tpu``'s rule).  Returns ``(a_padded,
    b_padded, n)`` with ``n`` the original size."""
    from gcge_tpu_torch.ops.onehot import CsrOperator
    from gcge_tpu_torch.ops.operators import (DenseOperator, DiagOperator,
                                              DiaOperator, HybridOperator,
                                              IdentityOperator,
                                              SparseOperator)

    n = a_op.shape[0]
    n_pad = (-n) % world
    if n_pad == 0:
        return a_op, b_op, n
    if pad_value is None:
        pad_value = float(a_op.values.abs().max()) * n if isinstance(
            a_op, (DiaOperator, CsrOperator, SparseOperator)) else 1e12

    def pad_csr_rows(op, diag_value):
        """``op`` with n_pad rows and columns more; the new rows hold
        ``diag_value`` on the diagonal, or nothing where it is None."""
        rowptr, colidx, values = op.rowptr, op.colidx, op.values
        k = 0 if diag_value is None else 1
        rowptr = torch.cat([rowptr, rowptr[-1] + k * torch.arange(
            1, n_pad + 1, dtype=rowptr.dtype, device=rowptr.device)])
        if k:
            colidx = torch.cat([colidx, torch.arange(
                n, n + n_pad, dtype=colidx.dtype, device=colidx.device)])
            values = torch.cat([values, torch.full(
                (n_pad,), diag_value, dtype=values.dtype,
                device=values.device)])
        return CsrOperator(rowptr, colidx, values, op.n_cols + n_pad)

    def pad_square(op, diag_value):
        if isinstance(op, DiaOperator):
            vals = torch.nn.functional.pad(op.values, (0, n_pad))
            offsets = op.offsets
            if 0 in offsets:
                d0 = offsets.index(0)
            else:
                vals = torch.cat([vals, torch.zeros_like(vals[:1])])
                offsets = offsets + (0,)
                d0 = len(offsets) - 1
            vals[d0, n:] = diag_value
            return DiaOperator(vals, offsets, n + n_pad)
        if isinstance(op, CsrOperator):
            return pad_csr_rows(op, diag_value)
        if isinstance(op, SparseOperator):
            vals = torch.nn.functional.pad(op.values, (0, 0, 0, n_pad))
            idx = torch.nn.functional.pad(op.indices, (0, 0, 0, n_pad))
            vals[n:, 0] = diag_value
            idx[n:, 0] = torch.arange(n, n + n_pad, device=idx.device)
            return SparseOperator(vals, idx, n + n_pad)
        if isinstance(op, HybridOperator):
            # the remainder's padded rows carry no entries
            return HybridOperator(pad_square(op.dia, diag_value),
                                  None if op.rest is None
                                  else pad_csr_rows(op.rest, None))
        if isinstance(op, DiagOperator):
            return DiagOperator(torch.cat([op.d, torch.full(
                (n_pad,), diag_value, dtype=op.d.dtype, device=op.d.device)]))
        if isinstance(op, DenseOperator):
            a = torch.nn.functional.pad(op.a, (0, n_pad, 0, n_pad))
            a[n:, n:] = diag_value * torch.eye(n_pad, dtype=a.dtype,
                                               device=a.device)
            return DenseOperator(a)
        if isinstance(op, IdentityOperator):
            if diag_value != 1.0:
                raise ValueError("an identity A cannot carry the pad value")
            return IdentityOperator(n + n_pad, op.dtype, op.device)
        raise NotImplementedError(f"pad_problem: {type(op).__name__}")

    a_pad = pad_square(a_op, pad_value)
    b_pad = None if b_op is None else pad_square(b_op, 1.0)
    return a_pad, b_pad, n
