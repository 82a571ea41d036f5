"""Process-group bring-up and per-rank data ingestion — the counterpart of
``gcge_tpu/parallel/multihost.py``.

The reference runs one MPI rank a process and builds or reads each rank's
row block locally (PETSc ``MatLoad``, PHG assembly); ``gcge_tpu`` assembles
global sharded arrays from process-local blocks.  In the port each rank
keeps its own rows, so ingestion is a matter of building the rank's sharded
operator from its block without any rank ever holding the global matrix:

* :func:`bootstrap` — ``torch.distributed.init_process_group`` (idempotent),
  NCCL for a card and gloo for the CPU;
* :func:`mv_from_host_blocks` — a rank's rows of a multivector;
* :func:`dia_from_host_blocks` — the sharded DIA operator from a rank's
  value rows;
* :func:`csr_from_host_blocks` — the sharded CSR operator from a rank's rows
  (the counterpart of ``ell_from_host_blocks``): the band, which sets the
  halo window, is the maximum over the ranks;
* :func:`hybrid_row_mesh` — the row mesh, checked to be in host-major
  order.
"""

from __future__ import annotations

import socket
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from gcge_tpu_torch.parallel.dist_ops import window_csr, window_dia
from gcge_tpu_torch.parallel.mesh import RowMesh, backend_for, row_mesh


def bootstrap(init_method: str | None = None, world_size: int | None = None,
              rank: int | None = None, device="cuda") -> tuple[int, int]:
    """Initialize the default process group unless it is; returns ``(rank,
    world_size)``.  The backend follows ``device`` (NCCL for ``cuda``, gloo
    for ``cpu``); an initialized group of the other backend raises.
    ``init_method``: e.g. ``tcp://localhost:<port>``, with ``world_size`` and
    ``rank``; ``None`` reads them from the environment, as ``torchrun`` sets
    it (``env://``).  The counterpart of ``MPI_Init``."""
    backend = backend_for(device)
    if dist.is_initialized():
        if str(dist.get_backend()) != backend:
            raise ValueError(f"the default process group runs "
                             f"{dist.get_backend()}, not {backend} for "
                             f"{device}")
    else:
        kwargs = {}
        if world_size is not None:
            kwargs["world_size"] = world_size
        if rank is not None:
            kwargs["rank"] = rank
        dist.init_process_group(backend, init_method=init_method or "env://",
                                **kwargs)
    return dist.get_rank(), dist.get_world_size()


def check_host_major(hosts: Sequence[str]) -> None:
    """Raise ``ValueError`` unless the ranks of each host are contiguous in
    ``hosts`` (the host of each rank, in rank order)."""
    seen = set()
    for prev, host in zip([None] + list(hosts), hosts):
        if host != prev:
            if host in seen:
                raise ValueError(f"the ranks are not in host-major order: "
                                 f"{list(hosts)}")
            seen.add(host)


def hybrid_row_mesh(group=None, device=None) -> RowMesh:
    """The row mesh over ``group`` (:func:`row_mesh`), checked to be in
    host-major order: each host's ranks are contiguous, so neighbouring row
    blocks exchange their halos inside a host and cross hosts once at each
    host boundary.  ``gcge_tpu`` orders its devices so; with one process a
    card the order is the ranks', which ``torchrun`` numbers host by host
    (and ``torch.distributed.new_group`` sorts), so the port checks it:
    one ``all_gather_object`` of the host names, ``ValueError`` where a
    host's ranks are not contiguous."""
    mesh = row_mesh(group, device)
    hosts = [None] * mesh.world
    dist.all_gather_object(hosts, socket.gethostname(), group=mesh.group)
    check_host_major(hosts)
    return mesh


def _n_global(mesh: RowMesh, ln: int, n_global: int | None) -> int:
    n = ln * mesh.world if n_global is None else int(n_global)
    if n != ln * mesh.world:
        raise ValueError(f"{ln} rows a rank on {mesh.world} ranks is not "
                         f"{n} rows")
    return n


def mv_from_host_blocks(mesh: RowMesh, local_block, n_global=None,
                        dtype=torch.float64) -> torch.Tensor:
    """This rank's ``(ln, m)`` block of a multivector, on its device, as the
    solver takes it (every rank passes its own rows, in rank order)."""
    block = torch.as_tensor(np.asarray(local_block), dtype=dtype,
                            device=mesh.device)
    _n_global(mesh, block.shape[0], n_global)
    return block


def dia_from_host_blocks(mesh: RowMesh, local_values, offsets,
                         n_global: int | None = None, dtype=torch.float64):
    """The sharded DIA operator from this rank's value rows ``(ndiag, ln)``:
    ``local_values[d, i] = A[r0 + i, r0 + i + offsets[d]]``, zero where that
    column lies outside the global matrix.  The offsets are the same on
    every rank."""
    vals = torch.as_tensor(np.asarray(local_values), dtype=dtype)
    n = _n_global(mesh, vals.shape[1], n_global)
    return window_dia(mesh, vals, offsets, n)


def csr_from_host_blocks(mesh: RowMesh, local_rowptr, local_colidx,
                         local_values, n_global: int | None = None,
                         dtype=torch.float64):
    """The sharded CSR operator from this rank's rows in CSR (``rowptr``
    from 0, ``colidx`` global column numbers).  The halo window is the
    band of the whole matrix: one ``all_reduce`` of each rank's band."""
    rowptr = np.asarray(local_rowptr, np.int64)
    colidx = np.asarray(local_colidx, np.int64)
    ln = len(rowptr) - 1
    n = _n_global(mesh, ln, n_global)
    r0, _ = mesh.block(n)
    rows = r0 + np.repeat(np.arange(ln), np.diff(rowptr))
    band = colidx - rows
    reach = torch.tensor([max(0, -int(band.min())) if len(band) else 0,
                          max(0, int(band.max())) if len(band) else 0],
                         dtype=torch.int64, device=mesh.device)
    hl, hr = (int(v) for v in mesh.pmax(reach).cpu())
    return window_csr(mesh, rowptr, colidx, local_values, n, hl, hr, dtype)
