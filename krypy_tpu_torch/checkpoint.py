"""Preemption-safe checkpoint / resume (counterpart of
:mod:`krypy_tpu.checkpoint`).

* :func:`save` / :func:`load` -- persist any nested dict/list of arrays
  (solver results, deflation bases, recycling state) to a directory in
  the JAX package's portable form: ``arrays.npz`` (a key's ``/`` written
  as ``__``) plus ``meta.json``, each written to a temporary file and
  renamed into place, so a directory either package writes loads in the
  other;
* :func:`resumable_restarted_gmres` -- a restarted GMRES driver that
  persists the iterate after every restart cycle and resumes mid-solve
  after a preemption;
* :class:`CheckpointedRecycling` -- wraps
  :class:`~krypy_tpu_torch.functional.deflation.RecyclingGmres`,
  persisting the recycled deflation basis between solves/processes.
"""

import json
import os
import warnings

import numpy as np
import torch

from .arnoldi import host

__all__ = [
    "save",
    "load",
    "resumable_restarted_gmres",
    "CheckpointedRecycling",
]


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix.rstrip("/")] = tree
    return out


def save(path, tree):
    """Persist a (nested dict/list of) array tree to ``path``; tensors are
    written from wherever they live.

    Atomic: writes to a temp file and renames, so a preemption mid-write
    never corrupts the previous checkpoint.
    """
    flat = _flatten(tree)
    arrays = {}
    meta = {}
    for key, val in flat.items():
        if val is None:
            meta[key] = {"kind": "none"}
        elif isinstance(val, (int, float, bool, str)):
            meta[key] = {"kind": "scalar", "value": val}
        else:
            meta[key] = {"kind": "array"}
            arrays[key.replace("/", "__")] = host(val)
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, ".tmp.npz")
    with open(tmp, "wb") as fh:
        np.savez(fh, **arrays)
    os.replace(tmp, os.path.join(path, "arrays.npz"))
    tmp_meta = os.path.join(path, ".tmp.json")
    with open(tmp_meta, "w") as fh:
        json.dump(meta, fh)
    os.replace(tmp_meta, os.path.join(path, "meta.json"))


def load(path, device=True):
    """Load a checkpoint written by :func:`save` as a flat dict keyed by
    '/'-joined paths.  Arrays come back as tensors on ``"cuda"`` with
    ``device=True``, on ``device`` where it is a device (a string or
    ``torch.device``), or as numpy with ``device=False``.  Returns None if
    no checkpoint exists."""
    meta_path = os.path.join(path, "meta.json")
    if not os.path.exists(meta_path):
        return None
    if device is True:
        device = "cuda"
    with open(meta_path) as fh:
        meta = json.load(fh)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        out = {}
        for key, info in meta.items():
            if info["kind"] == "none":
                out[key] = None
            elif info["kind"] == "scalar":
                out[key] = info["value"]
            else:
                arr = data[key.replace("/", "__")]
                out[key] = (torch.as_tensor(arr, device=device)
                            if device is not False else arr)
    return out


def resumable_restarted_gmres(
    A,
    b,
    checkpoint_dir,
    *,
    max_restarts=0,
    maxiter=None,
    tol=1e-5,
    **kwargs,
):
    """Restarted GMRES that checkpoints the iterate after every restart
    and resumes from the last checkpoint if one exists.

    ``b`` is a tensor (its device is the solve's) or numpy (it goes to
    ``"cuda"``).  Returns the
    :class:`~krypy_tpu_torch.functional.common.SolveResult` of the final
    cycle with the concatenated residual history; ``checkpoint_dir``
    holds ``x``, that history and the restart counter.
    """
    from .functional import BREAKDOWN, CONVERGED
    from .functional.common import SolveResult
    from .functional.gmres import gmres

    b = torch.as_tensor(b, device=b.device if isinstance(
        b, torch.Tensor) else "cuda")
    state = load(checkpoint_dir, device=b.device)
    if state is not None:
        x = state["x"]
        resnorms = list(host(state["resnorms"]))
        start = int(state["restart"])
    else:
        x = torch.zeros(b.reshape(-1).shape[0], dtype=b.dtype,
                        device=b.device)
        if b.ndim > 1:
            x = x[:, None]
        resnorms = []
        start = 0

    result = None
    for restart in range(start, max_restarts + 1):
        result = gmres(A, b, x0=x, tol=tol, maxiter=maxiter, **kwargs)
        niter = int(result.niter)
        chunk = list(host(result.resnorms)[: niter + 1])
        resnorms = resnorms[:-1] + chunk if resnorms else chunk
        x = result.x
        save(
            checkpoint_dir,
            {
                "x": x,
                "resnorms": np.asarray(resnorms),
                "restart": restart + 1,
            },
        )
        if int(result.status) in (CONVERGED, BREAKDOWN):
            break
    history = torch.as_tensor(np.asarray(resnorms), device=b.device)
    if result is None:
        # everything already done in a previous process; rebuild a result
        result_status = CONVERGED if resnorms and resnorms[-1] <= tol else 1
        return SolveResult(
            x=x,
            resnorms=history,
            niter=torch.tensor(len(resnorms) - 1, device=b.device),
            status=torch.tensor(result_status, device=b.device),
        )
    return result._replace(resnorms=history)


class CheckpointedRecycling:
    """A :class:`~krypy_tpu_torch.functional.deflation.RecyclingGmres`
    whose recycled deflation basis persists across processes: after each
    solve the deflation vectors for the NEXT system are extracted and
    saved, so a restarted process resumes the recycling sequence where it
    left off.  A basis loaded from ``checkpoint_dir`` goes to ``device``
    (keyword-only; ``None`` means ``"cuda"``)."""

    def __init__(self, checkpoint_dir, *, device=None, **kwargs):
        from .functional.deflation import RecyclingGmres

        self.checkpoint_dir = checkpoint_dir
        self._rec = RecyclingGmres(**kwargs)
        state = load(checkpoint_dir,
                     device="cuda" if device is None else device)
        if state is not None and state.get("U") is not None:
            # resume: reuse the persisted deflation basis directly
            self._rec._U = state["U"]
            self._rec._last_internals = None

    def solve(self, A, b, **kwargs):
        from .functional.deflation import ritz_deflation_vectors

        result = self._rec.solve(A, b, **kwargs)
        # extract and persist the next solve's deflation basis now; a
        # failure here must not lose the solve result, but it must not be
        # silent either -- a checkpoint that quietly never checkpoints is
        # worse than a warning
        try:
            U_next = ritz_deflation_vectors(
                self._rec._last_internals,
                n_vectors=self._rec.n_vectors,
                which=self._rec.which,
                hermitian=self._rec.hermitian,
            )
            save(self.checkpoint_dir, {"U": U_next})
        except Exception as exc:  # noqa: BLE001 -- persist-or-warn barrier
            warnings.warn(
                "recycling checkpoint NOT saved: extraction/persistence "
                f"of the deflation basis failed with {exc!r}; the solve "
                "result is unaffected but a process restart will not "
                "resume the recycling sequence from this solve."
            )
        return result
