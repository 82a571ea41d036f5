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

A :class:`GridMesh` (:func:`grid_mesh`) is the 2-D ``(rows, cols)`` mesh:
the ranks laid out row-major, a row group of ``n_rows`` ranks for each grid
column (each such group is a row mesh, over which the operators are
sharded, so every row block is replicated along the columns) and a column
group of ``n_cols`` ranks for each grid row, over which a solve splits the
columns of its multivectors (:mod:`gcge_tpu_torch.ops.multivec`).

Not carried over: ``mv_spec``, ``shard_mv`` and ``replicate``, which place
arrays of one controller on many devices and have no counterpart when each
rank holds its own rows and columns.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
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

    @property
    def lead(self) -> bool:
        """Whether this rank prints and writes for the mesh: its rank 0."""
        return self.rank == 0

    def warm(self) -> None:
        """One collective on every group of the mesh.  NCCL sets up a
        group's communicator at its first collective, which must not fall
        inside a CUDA graph capture."""
        self.psum(torch.zeros(1, device=self.device))


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
    device = _backend_device(group, device)
    world = dist.get_world_size(group)
    peers = tuple(dist.get_global_rank(group, r) for r in range(world))
    return RowMesh(group, dist.get_rank(group), world, device, peers)


@dataclass(frozen=True, kw_only=True)
class GridMesh(RowMesh):
    """A 2-D ``(n_rows, n_cols)`` mesh, the counterpart of ``gcge_tpu``'s
    ``grid_mesh``: global rank ``g`` of the grid sits at ``(g // n_cols, g %
    n_cols)``.

    It is a :class:`RowMesh` over this rank's *row group*, the ``n_rows``
    ranks of its grid column (``group``, ``rank``, ``world``, ``peers``; also
    :attr:`rows`): the operators are sharded over it, and every contraction
    over rows (:meth:`psum`) is summed over it.  ``cols`` is the group of
    the ``n_cols`` ranks of this rank's grid row, ``col`` this rank's place
    in it.  ``world_group`` holds every rank of the grid: :meth:`broadcast`
    sends over it from the grid's rank 0, so that a value every rank must
    share (the projected eigenpairs, the fused loop's read a chunk) has the
    same bits on every rank of the grid.

    ``col_split`` is the number of column shards of a solve's multivectors:
    ``n_cols`` where each rank holds ``1/n_cols`` of their columns (column
    ``j`` on the rank with ``col == j % n_cols``), 1 where every rank of a
    row holds every column (:meth:`replicated`)."""

    cols: Any
    col: int
    n_cols: int
    world_group: Any
    world_rank: int
    world_root: int            # global rank of the grid's rank 0
    col_split: int

    @property
    def rows(self) -> RowMesh:
        """The row mesh of this rank's grid column."""
        return RowMesh(self.group, self.rank, self.world, self.device,
                       self.peers)

    @property
    def n_rows(self) -> int:
        return self.world

    @property
    def lead(self) -> bool:
        return self.world_rank == 0

    def replicated(self) -> "GridMesh":
        """The same grid with every column on every rank of a row."""
        return replace(self, col_split=1)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """The grid's rank 0's ``t`` on every rank of the grid (in place
        where contiguous); ``src`` must be 0."""
        if src != 0:
            raise ValueError("a grid broadcasts from its rank 0 only")
        t = t.contiguous()
        dist.broadcast(t, src=self.world_root, group=self.world_group)
        return t

    def col_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``(n_cols, ...)``: ``x`` of every rank of this rank's grid row,
        stacked by column index (one ``all_gather``)."""
        out = torch.empty((self.n_cols * x.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        gather = getattr(dist, "all_gather_single", None) or \
            dist.all_gather_into_tensor
        gather(out, x.contiguous(), group=self.cols)
        return out.view((self.n_cols,) + tuple(x.shape))

    def col_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks of this rank's grid row."""
        t = t.contiguous()
        dist.all_reduce(t, group=self.cols)
        return t

    def everyone(self) -> RowMesh:
        """A row mesh over every rank of the grid (for checks that every
        rank holds the same values)."""
        size = self.world * self.n_cols
        return RowMesh(self.world_group, self.world_rank, size, self.device,
                       tuple(dist.get_global_rank(self.world_group, r)
                             for r in range(size)))

    def warm(self) -> None:
        zero = torch.zeros(1, device=self.device)
        self.psum(zero)
        self.col_sum(zero)
        self.broadcast(zero)


def _backend_device(group, device):
    backend = str(dist.get_backend(group))
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) \
            if backend == "nccl" else torch.device("cpu")
    device = torch.device(device)
    if backend_for(device) != backend:
        raise ValueError(f"a {backend} process group cannot carry tensors on "
                         f"{device} (NCCL: cuda, gloo: cpu)")
    return device


def grid_mesh(n_rows: int, n_cols: int, group=None, device=None
              ) -> GridMesh:
    """The ``(n_rows, n_cols)`` grid over ``group`` (default: the default
    process group, which must be initialized), whose size must be ``n_rows *
    n_cols``.  Every rank of the default group calls it (it makes one
    process group for each grid column and each grid row, all of them in
    the same order on every rank).  ``device`` as in :func:`row_mesh`.  The
    grid splits a solve's columns over ``n_cols`` (``col_split``)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("grid_mesh needs an initialized default process "
                           "group (torchrun, or "
                           "gcge_tpu_torch.parallel.multihost.bootstrap)")
    group = dist.group.WORLD if group is None else group
    device = _backend_device(group, device)
    size = dist.get_world_size(group)
    if n_rows < 1 or n_cols < 1 or n_rows * n_cols != size:
        raise ValueError(f"a ({n_rows}, {n_cols}) grid needs "
                         f"{n_rows * n_cols} ranks; the group has {size}")
    members = [dist.get_global_rank(group, r) for r in range(size)]
    me = dist.get_rank(group)
    row, col = divmod(me, n_cols)
    row_group = col_group = None
    # every rank makes every group, in one order
    for c in range(n_cols):
        g = dist.new_group([members[i * n_cols + c] for i in range(n_rows)])
        if c == col:
            row_group = g
    for r in range(n_rows):
        g = dist.new_group([members[r * n_cols + j] for j in range(n_cols)])
        if r == row:
            col_group = g
    peers = tuple(members[i * n_cols + col] for i in range(n_rows))
    return GridMesh(row_group, row, n_rows, device, peers, cols=col_group,
                    col=col, n_cols=n_cols, world_group=group,
                    world_rank=me, world_root=members[0], col_split=n_cols)


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
