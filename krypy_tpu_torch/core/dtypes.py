"""dtype and shape helpers (counterpart of :mod:`krypy_tpu.core.dtypes`)
over torch dtypes."""

import numpy as np
import torch

__all__ = ["find_common_dtype", "shape_vec", "shape_vecs", "asarray",
           "torch_dtype"]


def torch_dtype(dt):
    """A torch dtype for ``dt``: a torch dtype, a numpy dtype, or anything
    ``np.dtype`` takes (``"float32"``, ``float``, ...)."""
    if isinstance(dt, torch.dtype):
        return dt
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dt))).dtype


def asarray(x, device="cuda"):
    """Coerce input to a tensor; None passes through.  A tensor keeps its
    device; anything else (numpy arrays, lists, scalars) goes to
    ``device``."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x
    return torch.tensor(np.asarray(x), device=device)


def find_common_dtype(*args):
    """Common torch dtype of tensors / operators / dtypes; ignores None and
    objects without a dtype, promoted by ``torch.promote_types`` (as
    numpy's promotion for the float and complex dtypes: float32 with
    float64 gives float64, float64 with complex64 complex128).  Without
    any dtype it is float64, the port's default float."""
    dtypes = []
    for arg in args:
        if arg is None:
            continue
        if isinstance(arg, (np.dtype, str, type, torch.dtype)):
            try:
                dtypes.append(torch_dtype(arg))
            except TypeError:
                pass
        elif getattr(arg, "dtype", None) is not None:
            dtypes.append(torch_dtype(arg.dtype))
    if not dtypes:
        return torch.float64
    out = dtypes[0]
    for dt in dtypes[1:]:
        out = torch.promote_types(out, dt)
    return out


def shape_vec(x):
    """Reshape a ``(n,)`` vector into a ``(n, 1)`` column."""
    return x.reshape(x.shape[0], 1)


def shape_vecs(*args, device="cuda"):
    """Bring all array arguments into column shape ``(n, 1)``.

    Returns ``(flat_vecs, args)`` where ``flat_vecs`` is True iff every
    array argument came in flat ``(n,)`` form, so that solvers can return
    results in the caller's shape convention.  numpy arrays become
    tensors on ``device`` (:func:`asarray`); tensors keep their device.
    """
    out = []
    flat_vecs = True
    for arg in args:
        if arg is not None and hasattr(arg, "shape") and hasattr(arg, "ndim"):
            arg = asarray(arg, device=device)
            if arg.ndim == 1:
                arg = shape_vec(arg)
            else:
                flat_vecs = False
        out.append(arg)
    return flat_vecs, out
