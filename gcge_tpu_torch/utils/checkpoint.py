"""Checkpoint and resume of the eigensolver's state — the counterpart of
``gcge_tpu/utils/checkpoint.py``.

The reference has no checkpointing; its nearest capability is the warm
start (``InitializeX`` takes ``nevGiven`` vectors).  The Ritz values and
vectors go into one ``.npz`` with ``gcge_tpu``'s layout (``eval``, ``evec``,
``nev_conv``, ``num_iter``, ``params_json``), so a checkpoint written by
either package loads in the other; a resume passes the saved ``evec`` as
``x0``.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch


def save_checkpoint(path: str, result, params=None) -> None:
    """Write a :class:`~gcge_tpu_torch.solvers.gcg.GCGResult` (``evec``
    global, on any device) and the plain fields of ``params``."""
    meta = {}
    if params is not None:
        meta = {f.name: getattr(params, f.name)
                for f in dataclasses.fields(params)
                if isinstance(getattr(params, f.name),
                              (int, float, str, bool))}
    evec = result.evec
    if torch.is_tensor(evec):
        evec = evec.cpu().numpy()
    np.savez_compressed(
        path,
        eval=np.asarray(result.eval),
        evec=np.asarray(evec),
        nev_conv=np.asarray(result.nev_conv),
        num_iter=np.asarray(result.num_iter),
        params_json=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
    )


def load_checkpoint(path: str, device="cuda"):
    """``(eval, evec, nev_conv, params_dict)``: numpy eigenvalues, the Ritz
    vectors as a tensor on ``device``, the converged count and the saved
    params; pass ``evec`` as ``x0=`` to
    :func:`gcge_tpu_torch.solvers.gcg.gcg_solve` to resume."""
    with np.load(path) as z:
        eval_ = z["eval"]
        evec = torch.as_tensor(z["evec"], device=device)
        nev_conv = int(z["nev_conv"])
        params = json.loads(bytes(z["params_json"].tobytes()).decode()
                            or "{}")
    return eval_, evec, nev_conv, params
