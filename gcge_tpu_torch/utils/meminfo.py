"""Device memory observability — the counterpart of
``gcge_tpu/utils/meminfo.py``.

The reference tracks host allocations with its bundled memwatch library
(``test/memwatch.{c,h}``), a leak tracker for hand-managed C memory.  Under
PyTorch nothing is freed by hand either, but the same questions remain: how
much device memory do the solver's workspaces pin, and does a solve leave
live tensors behind?  The allocator's counters come from
``torch.cuda.memory_stats`` (``None`` on the CPU, where there is no such
allocator, as ``gcge_tpu`` gives ``None`` where PJRT has no stats), and the
census of live tensors on a device, ``jax.live_arrays()``'s counterpart, from
the garbage collector's objects.
"""

from __future__ import annotations

import gc
from dataclasses import dataclass

import torch


@dataclass
class MemSnapshot:
    bytes_in_use: int | None
    peak_bytes_in_use: int | None
    bytes_limit: int | None
    num_live_arrays: int
    live_array_bytes: int

    def __str__(self):
        def fmt(b):
            return "n/a" if b is None else f"{b / 2**20:.1f} MiB"

        return (
            f"in_use={fmt(self.bytes_in_use)} "
            f"peak={fmt(self.peak_bytes_in_use)} "
            f"limit={fmt(self.bytes_limit)} "
            f"live_arrays={self.num_live_arrays} "
            f"({fmt(self.live_array_bytes)})"
        )


def _device(device) -> torch.device:
    if device is None:
        return torch.device("cuda", torch.cuda.current_device()) \
            if torch.cuda.is_available() else torch.device("cpu")
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _live_tensors(device=None) -> list[torch.Tensor]:
    """The tensors alive on ``device`` (default: the current card, else the
    CPU) that the garbage collector tracks, one per storage: views of one
    storage count once."""
    device = _device(device)
    seen, out = set(), []
    for obj in gc.get_objects():
        # type(), not isinstance(): the latter reads __class__, which some
        # module-level stand-ins answer with a deprecation warning
        if not issubclass(type(obj), torch.Tensor):
            continue
        try:
            if obj.device != device:
                continue
            key = obj.untyped_storage().data_ptr()
        except (RuntimeError, ReferenceError):
            continue
        if key not in seen:
            seen.add(key)
            out.append(obj)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.untyped_storage().nbytes()


def snapshot(device=None) -> MemSnapshot:
    """Current device memory use: the caching allocator's counters on a card
    (``None`` on the CPU) and a census of the live tensors."""
    device = _device(device)
    stats = torch.cuda.memory_stats(device) if device.type == "cuda" else {}
    live = _live_tensors(device)
    return MemSnapshot(
        bytes_in_use=stats.get("allocated_bytes.all.current"),
        peak_bytes_in_use=stats.get("allocated_bytes.all.peak"),
        bytes_limit=torch.cuda.get_device_properties(device).total_memory
        if device.type == "cuda" else None,
        num_live_arrays=len(live),
        live_array_bytes=sum(_nbytes(t) for t in live),
    )


def workspace_bytes(n: int, nev: int, block_size: int = 0, nev_max: int = 0,
                    dtype_bytes: int = 8) -> int:
    """Predicted GCG workspace, ``gcge_tpu``'s formula (after the reference's
    workspace sizing, ``ops_eig_sol_gcg.c:1624-1656``): the basis
    ``V (n, size_x + 2 bs)``, the Ritz block and the block CG's vectors on
    the active window."""
    bs = block_size or max(nev // 5, 1)
    size_x = nev_max or 2 * nev
    m = size_x + 2 * bs
    v = n * m
    ritz = n * size_x
    cg = 4 * n * bs
    return (v + ritz + cg) * dtype_bytes


class MemWatch:
    """Context manager printing the memory change of a region, and the
    allocator's peak inside it on a card.

    >>> with MemWatch("gcg solve"):
    ...     gcg_solve(a, b, params)
    """

    def __init__(self, label: str = "", device=None, printer=print):
        self.label = label
        self.device = _device(device)
        self.printer = printer

    def __enter__(self):
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        self.before = snapshot(self.device)
        return self

    def __exit__(self, *exc):
        after = snapshot(self.device)
        self.after = after
        d_live = after.live_array_bytes - self.before.live_array_bytes
        d_cnt = after.num_live_arrays - self.before.num_live_arrays
        peak = "" if after.peak_bytes_in_use is None else \
            f"; peak {after.peak_bytes_in_use / 2**30:.3f} GiB"
        self.printer(
            f"[memwatch] {self.label}: live {d_cnt:+d} arrays "
            f"({d_live / 2**20:+.1f} MiB){peak}; now {after}"
        )
        return False


# --------------------------------------------------------------------------
# Leak tracking — the memwatch parity piece.  memwatch records every malloc
# with its file:line and reports those never freed.  The counterpart here of
# "never freed" is a tensor created inside a region that is still alive after
# it: a solver caching a tensor on an object, a module-level cache growing a
# call.  LeakTracker diffs the live-tensor census by storage between marks;
# leak_check runs a callable twice and demands that the second call leave
# nothing new behind (the first may fill caches legitimately).
# --------------------------------------------------------------------------


@dataclass
class LeakReport:
    """Survivors of a tracked region, grouped by (shape, dtype)."""

    new_arrays: int
    new_bytes: int
    groups: dict  # (shape, dtype) -> (count, bytes)

    def __str__(self):
        if not self.new_arrays:
            return "[leaktracker] clean: no surviving device allocations"
        lines = [
            f"[leaktracker] {self.new_arrays} surviving arrays "
            f"({self.new_bytes / 2**20:.2f} MiB):"
        ]
        for (shape, dtype), (cnt, nbytes) in sorted(
                self.groups.items(), key=lambda kv: -kv[1][1]):
            lines.append(f"  {cnt:4d} x {dtype}{list(shape)}  "
                         f"{nbytes / 2**20:8.2f} MiB")
        return "\n".join(lines)


class LeakTracker:
    """Storage-identity diff of the live-tensor census.

    >>> lt = LeakTracker()
    >>> lt.start()
    >>> ... run the region ...
    >>> report = lt.stop()     # tensors created in the region, still alive
    """

    def __init__(self, device=None):
        self.device = _device(device)
        self._before: set | None = None

    def start(self):
        self._before = {t.untyped_storage().data_ptr()
                        for t in _live_tensors(self.device)}
        return self

    def stop(self) -> LeakReport:
        if self._before is None:
            raise RuntimeError("LeakTracker.stop() before start()")
        survivors = [t for t in _live_tensors(self.device)
                     if t.untyped_storage().data_ptr() not in self._before]
        groups: dict = {}
        for t in survivors:
            key = (tuple(t.shape), str(t.dtype))
            cnt, nbytes = groups.get(key, (0, 0))
            groups[key] = (cnt + 1, nbytes + _nbytes(t))
        self._before = None
        return LeakReport(
            new_arrays=len(survivors),
            new_bytes=sum(_nbytes(t) for t in survivors),
            groups=groups,
        )


def leak_check(fn, *args, allow_bytes: int = 0, device=None, **kwargs):
    """Raise ``AssertionError`` with the grouped survivor report if a
    steady-state call of ``fn`` leaves more than ``allow_bytes`` of new live
    tensors behind on ``device``.

    Runs ``fn`` once untracked (filling caches: the kernel library, an
    operator's f32 values, launch plans), drops the result, then once more
    under :class:`LeakTracker`: growth a steady-state call is what an
    iterative solver must not have (memwatch's workflow, recast for a
    runtime with garbage collection)."""
    result = fn(*args, **kwargs)
    del result
    gc.collect()
    lt = LeakTracker(device)
    lt.start()
    result = fn(*args, **kwargs)
    del result
    gc.collect()
    report = lt.stop()
    if report.new_bytes > allow_bytes:
        raise AssertionError(str(report))
    return report
