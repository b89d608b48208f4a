"""Gram-Schmidt kernels of the GMRES basis: CUDA wrappers and their plain
PyTorch versions.

Counterparts of the Pallas kernels in
``krypy_tpu/kernels/orthogonalize.py``.  The three that
``ortho="cgs2_fused"`` runs, over the leading ``rows`` rows of a
row-major ``(m, N)`` basis ``V``:

* :func:`project_prefix` (K4): ``c = (conj(V[:rows]) w) * mask``, one
  sweep of the prefix;
* :func:`apply_project` (K5): ``w1 = w - c[:rows]^T V[:rows]`` and
  ``c2 = (conj(V[:rows]) w1) * mask`` in ONE sweep (each element of V
  read once, used twice);
* :func:`update_prefix` (K6): ``w - c[:rows]^T V[:rows]``;

and :func:`cgs2_fused`, their composition K4 -> K5 -> K6: two-pass
classical Gram-Schmidt in three sweeps of the prefix, with
:func:`cgs2_fused_sharded` (K9) its form on a basis whose columns are
split over a mesh.  And the one behind
``ortho="cgs_pallas"``/``"cgs2_pallas"``:

* :func:`cgs_project` (K7): one classical Gram-Schmidt pass, ``c =
  (conj(V[:rows]) w) * mask`` and ``w - c^T B[:rows]`` with ``B`` either
  ``V`` or a second (dual) basis, the only kernel that serves GMRES with
  an inner-product-changing preconditioner ``M`` (``V = M B``), with
  :func:`cgs_project_blocks` its form on a basis split over a mesh.

Coefficient vectors have length m, zero past ``rows``.

``rows`` is a run-time argument (the JAX package's static prefix buckets
and Mosaic tile rules are not ported), and N needs no particular
divisibility.  Each wrapper launches its CUDA kernel
(``csrc/orthogonalize.cu``, float32 and float64) for a tensor on a CUDA
device, raises for any other dtype there, and runs the plain version only
for tensors on the CPU.
"""

import torch

from ..parallel import all_reduce_sum
from ._launch import LAUNCHES, jax_keywords
from ._launch import launch as _launch

__all__ = [
    "project_prefix",
    "apply_project",
    "update_prefix",
    "cgs2_fused",
    "cgs2_fused_sharded",
    "cgs2_fused_blocks",
    "cgs_project",
    "cgs_project_blocks",
    "cgs_project_torch",
    "project_prefix_torch",
    "apply_project_torch",
    "update_prefix_torch",
    "launch_config",
    "row_chunk",
    "max_rows",
]

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
#: threads per block of the sweeps
THREADS = 256
#: cap on the grid of K5 and K6 (and K7's phase 1 where it is K6's): a
#: fixed number (not the card's SM count), so the reduction order, and
#: with it every bit of the result, depends on N alone
MAX_BLOCKS = 1024
#: K4 (and K7's phase 0 and shifted phase 1): the 16-byte column groups
#: (4 float32 or 2 float64 columns) each thread takes per row of its
#: block's contiguous range; the grid is the number of such ranges that
#: cover N
GROUPS_PER_THREAD = 16
#: K4's chunks of rows summed in registers, its C instantiations
ROW_CHUNKS = (8, 16)
#: K5's shared-memory budget per block: the staged column tile
#: (rows x threads values) plus the coefficients and warp totals
_K5_SMEM = 200 * 1024
#: the most dynamic shared memory a block can have on Hopper (the kernels
#: opt in above the default 48 KB)
_SMEM_MAX = 232448


def _smem(kernel, rows, threads, itemsize):
    """Dynamic shared memory of one block, as ``orthogonalize.cu`` asks
    for it: K4 none (its chunk's warp totals are static), K5 the
    coefficients, warp totals and staged column tile, K6 the
    coefficients, K7 its phase 1's (its coefficients)."""
    per_row = {"project_prefix": 0,
               "apply_project": 1 + threads // 32 + threads,
               "update_prefix": 1,
               "cgs_project": 1}[kernel]
    return itemsize * rows * per_row


def row_chunk(rows):
    """K4's chunk of rows at a prefix of ``rows``: the smallest of
    ``ROW_CHUNKS`` that holds the whole prefix (so ``w`` is read once),
    else the largest (each chunk reads ``w`` again)."""
    return next((c for c in ROW_CHUNKS if rows <= c), ROW_CHUNKS[-1])


def launch_config(N, rows, itemsize, kernel):
    """``(blocks, threads)`` of ``kernel``'s sweep over N columns,
    ``THREADS`` threads a block.  K4 (and K7's phase 0 and shifted
    phase 1, ``"cgs_project"``): one block per contiguous range of
    ``THREADS * GROUPS_PER_THREAD`` 16-byte column groups.  K5 and K6
    (and K7's other phase 1): at most ``MAX_BLOCKS`` blocks, each walking
    its columns in a grid-stride loop; K5 halves its threads, down to one
    warp, while its staged tile exceeds the budget.  The grid depends on
    N, ``rows`` and the dtype alone.  Raises ``ValueError`` where
    ``rows`` do not fit one block's shared memory (see
    :func:`max_rows`)."""
    threads = THREADS
    if kernel == "apply_project":
        while threads > 32 and _smem(kernel, rows, threads,
                                     itemsize) > _K5_SMEM:
            threads //= 2
    if _smem(kernel, rows, threads, itemsize) > _SMEM_MAX:
        raise ValueError(
            f"{kernel}: rows={rows} do not fit one block's shared memory "
            f"at {itemsize}-byte elements (at most "
            f"{max_rows(itemsize, kernel)} rows)"
        )
    if kernel in ("project_prefix", "cgs_project"):
        groups = -(-N * itemsize // 16)
        return max(1, -(-groups // (threads * GROUPS_PER_THREAD))), threads
    return max(1, min(-(-N // threads), MAX_BLOCKS)), threads


def max_rows(itemsize, kernel="apply_project"):
    """The tallest prefix that ``kernel`` launches on at
    ``itemsize``-byte elements (None: no limit).  The default is the
    limit of the three prefix sweeps together, 1709 float32 or 854
    float64 rows: K5's staged tile at its smallest block (one warp)
    binds, and a GMRES basis of ``maxiter + 1`` rows above it cannot run
    ``cgs2_fused`` on the card.  K4 (``"project_prefix"``) keeps no
    per-row shared memory and has no limit; ``"cgs_project"`` (K7, bound
    by its phase 1's coefficients) takes 58112 float32 or 29056 float64
    rows."""
    threads = 32 if kernel == "apply_project" else THREADS
    per_row = _smem(kernel, 1, threads, itemsize)
    return _SMEM_MAX // per_row if per_row else None


def _check(name, V, rows, vecs, coeffs):
    """Validate the operands; return ``(rows, on_cuda)``."""
    if V.ndim != 2:
        raise ValueError(f"{name}: V must be 2-D (m, N), got {V.shape}")
    m, N = V.shape
    rows = m if rows is None else int(rows)
    if not 1 <= rows <= m:
        raise ValueError(f"{name}: rows={rows} outside [1, {m}]")
    for t, n in [(v, N) for v in vecs] + [(c, m) for c in coeffs]:
        if t.shape != (n,):
            raise ValueError(f"{name}: operand of shape {tuple(t.shape)}, "
                             f"expected ({n},)")
        if t.device != V.device or t.dtype != V.dtype:
            raise ValueError(f"{name}: operands differ in device or dtype")
    for t in (V, *vecs, *coeffs):
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    if V.device.type == "cuda":
        if V.dtype not in _SUFFIX:
            raise TypeError(f"{name}: the CUDA kernel takes float32 or "
                            f"float64, got {V.dtype}")
        return rows, True
    if V.device.type != "cpu":
        raise ValueError(f"{name}: unsupported device {V.device}")
    return rows, False


def _mask(mask, V):
    """The per-row mask in the basis dtype (the JAX wrappers cast it
    likewise)."""
    return mask.to(device=V.device, dtype=V.dtype).contiguous()


def _padded(c, m):
    return torch.nn.functional.pad(c, (0, m - c.shape[0]))


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def project_prefix_torch(V, w, mask, rows):
    """Plain version of K4: ``c = (conj(V[:rows]) w) * mask[:rows]``,
    zero-padded to length m."""
    c = (V[:rows].conj() @ w) * mask[:rows]
    return _padded(c, V.shape[0])


def apply_project_torch(V, w, c, mask, rows):
    """Plain version of K5: ``(w1, c2)`` with ``w1 = w - c[:rows] @
    V[:rows]`` and ``c2 = (conj(V[:rows]) w1) * mask[:rows]`` padded to
    m."""
    Vr = V[:rows]
    w1 = w - c[:rows] @ Vr
    return w1, _padded((Vr.conj() @ w1) * mask[:rows], V.shape[0])


def update_prefix_torch(V, w, c, rows):
    """Plain version of K6: ``w - c[:rows] @ V[:rows]``."""
    return w - c[:rows] @ V[:rows]


def cgs_project_torch(V, w, mask, basis, rows):
    """Plain version of K7: ``(w - c @ basis[:rows], c padded to m)``
    with ``c = (conj(V[:rows]) w) * mask[:rows]``; two products in the
    input's dtype."""
    c = (V[:rows].conj() @ w) * mask[:rows]
    return w - c @ basis[:rows], _padded(c, V.shape[0])


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def project_prefix(V, w, mask, *, rows=None, block_n=32768,
                   interpret=False):
    """K4: one masked projection sweep over the leading ``rows`` rows of
    ``V``; returns ``c`` of length m (zero past ``rows``).  Counterpart
    of ``krypy_tpu.kernels.orthogonalize.project_prefix`` (``block_n``,
    ``interpret``: :func:`~krypy_tpu_torch.kernels._launch.
    jax_keywords`)."""
    mask = _mask(mask, V)
    rows, cuda = _check("project_prefix", V, rows, (w,), (mask,))
    if jax_keywords(interpret) or not cuda:
        return project_prefix_torch(V, w, mask, rows)
    m, N = V.shape
    blocks, threads = launch_config(N, rows, V.element_size(),
                                   "project_prefix")
    partial = torch.empty(blocks * rows, dtype=V.dtype, device=V.device)
    c = torch.empty(m, dtype=V.dtype, device=V.device)
    _launch(
        "project_prefix", f"krypy_project_prefix_{_SUFFIX[V.dtype]}",
        (V.data_ptr(), w.data_ptr(), mask.data_ptr(), partial.data_ptr(),
         c.data_ptr(), N, rows, m, blocks, threads, row_chunk(rows)),
        V.device,
    )
    return c


def apply_project(V, w, c, mask, *, rows=None, block_n=32768,
                  interpret=False):
    """K5: the fused update and second projection in ONE sweep of the
    prefix: ``w1 = w - c[:rows]^T V[:rows]``, ``c2 = (conj(V[:rows]) w1)
    * mask``; returns ``(w1, c2)`` with ``c2`` of length m.  Counterpart
    of ``krypy_tpu.kernels.orthogonalize.apply_project`` (``block_n``,
    ``interpret``: :func:`~krypy_tpu_torch.kernels._launch.
    jax_keywords`)."""
    mask = _mask(mask, V)
    rows, cuda = _check("apply_project", V, rows, (w,), (c, mask))
    if jax_keywords(interpret) or not cuda:
        return apply_project_torch(V, w, c, mask, rows)
    m, N = V.shape
    blocks, threads = launch_config(N, rows, V.element_size(),
                                   "apply_project")
    partial = torch.empty(blocks * rows, dtype=V.dtype, device=V.device)
    w1 = torch.empty(N, dtype=V.dtype, device=V.device)
    c2 = torch.empty(m, dtype=V.dtype, device=V.device)
    _launch(
        "apply_project", f"krypy_apply_project_{_SUFFIX[V.dtype]}",
        (V.data_ptr(), w.data_ptr(), c.data_ptr(), mask.data_ptr(),
         w1.data_ptr(), partial.data_ptr(), c2.data_ptr(), N, rows, m,
         blocks, threads),
        V.device,
    )
    return w1, c2


def update_prefix(V, w, c, *, rows=None, block_n=32768, interpret=False):
    """K6: ``w - c[:rows]^T V[:rows]`` in one sweep of the prefix.
    Counterpart of ``krypy_tpu.kernels.orthogonalize.update_prefix``
    (``block_n``, ``interpret``: :func:`~krypy_tpu_torch.kernels._launch.
    jax_keywords`)."""
    rows, cuda = _check("update_prefix", V, rows, (w,), (c,))
    if jax_keywords(interpret) or not cuda:
        return update_prefix_torch(V, w, c, rows)
    N = V.shape[1]
    blocks, threads = launch_config(N, rows, V.element_size(),
                                   "update_prefix")
    out = torch.empty(N, dtype=V.dtype, device=V.device)
    _launch(
        "update_prefix", f"krypy_update_prefix_{_SUFFIX[V.dtype]}",
        (V.data_ptr(), w.data_ptr(), c.data_ptr(), out.data_ptr(), N, rows,
         blocks, threads),
        V.device,
    )
    return out


def cgs2_fused(V, w, mask, *, rows=None, block_n=32768, interpret=False):
    """Two-pass classical Gram-Schmidt of ``w`` against the leading
    ``rows`` rows of ``V`` in three sweeps (K4 -> K5 -> K6); returns
    ``(w2, c1 + c2)``.  Counterpart of
    ``krypy_tpu.kernels.orthogonalize.cgs2_fused`` (``block_n``,
    ``interpret``: :func:`~krypy_tpu_torch.kernels._launch.
    jax_keywords`)."""
    kw = dict(rows=rows, interpret=interpret)
    c1 = project_prefix(V, w, mask, **kw)
    w1, c2 = apply_project(V, w, c1, mask, **kw)
    return update_prefix(V, w1, c2, **kw), c1 + c2


def cgs2_fused_sharded(V, w, mask, *, mesh, rows=None, n=None,
                       axis_name=None, block_n=32768, interpret=None):
    """K9 under the JAX package's contract: :func:`cgs2_fused_blocks`
    where the global N divides over ``mesh``, else ``ValueError`` with
    the JAX package's wording (its ``shard_map`` takes equal blocks
    only).  ``n`` is the global N; without it the blocks' lengths are
    summed first (one all-reduce more).  Counterpart of
    ``krypy_tpu.kernels.orthogonalize.cgs2_fused_sharded`` (``axis_name``,
    ``block_n``, ``interpret``: :func:`~krypy_tpu_torch.kernels._launch.
    jax_keywords`)."""
    plain = jax_keywords(interpret, axis_name)
    if n is None:
        n = int(all_reduce_sum(torch.tensor(V.shape[1], device=V.device),
                               mesh))
    if n % mesh.size != 0:
        raise ValueError(
            f"N={n} must divide over the mesh size {mesh.size} for the "
            "sharded fused path (cgs2_fused_blocks takes blocks of any "
            "length)")
    return cgs2_fused_blocks(V, w, mask, mesh=mesh, rows=rows,
                             interpret=plain)


def cgs2_fused_blocks(V, w, mask, *, mesh, rows=None, interpret=False):
    """K9: :func:`cgs2_fused` on a basis whose columns are split over
    ``mesh`` (a :class:`krypy_tpu_torch.parallel.Mesh`): ``V`` is the
    rank's ``(m, n_loc)`` columns and ``w`` its block, of any length
    (the blocks of :func:`krypy_tpu_torch.parallel.block_of` where N
    does not divide over the mesh).  K4 on the rank's columns, the sum
    of the partial coefficients over the ranks, K5, the second sum, K6:
    three local sweeps and two
    :func:`~krypy_tpu_torch.parallel.all_reduce_sum` calls of m values
    (the JAX package's ``cgs2_fused_sharded``, its lines 399-414, line
    for line).  Returns ``(w2, c1 + c2)``, the rank's block of ``w2``
    and the coefficients, the same on every rank.  On the card ``rows``
    must fit the kernels (:func:`max_rows`), as for :func:`cgs2_fused`.
    On a CUDA tensor it counts one ``cgs2_fused_sharded`` launch beside
    K4-K6's own; ``interpret=True`` runs their plain versions."""
    kw = dict(rows=rows, interpret=interpret)
    c1 = all_reduce_sum(project_prefix(V, w, mask, **kw), mesh)
    w1, c2p = apply_project(V, w, c1, mask, **kw)
    c2 = all_reduce_sum(c2p, mesh)
    w2 = update_prefix(V, w1, c2, **kw)
    if V.is_cuda and not interpret:
        LAUNCHES["cgs2_fused_sharded"] += 1
    return w2, c1 + c2


def cgs_project_blocks(V, w, mask, basis=None, *, mesh, rows=None):
    """K7 on a basis whose columns are split over ``mesh`` (a
    :class:`krypy_tpu_torch.parallel.Mesh`): ``V``, ``basis`` (default
    ``V``) and ``w`` are the rank's columns, of any length.  K7's phase 0
    is K4's sweep and its phase 1 K6's update, so the sharded form is K4
    on the rank's columns, the sum of the partial coefficients over the
    ranks (one :func:`~krypy_tpu_torch.parallel.all_reduce_sum` of m
    values), then K6 along ``basis``: ``c = (conj(V[:rows]) w) * mask``,
    ``w - c^T B[:rows]``.  Returns ``(w_orth, c)``, the rank's block and
    the coefficients, the same on every rank; the launches count as K4's
    and K6's."""
    c = all_reduce_sum(project_prefix(V, w, mask, rows=rows), mesh)
    return update_prefix(V if basis is None else basis, w, c, rows=rows), c


def cgs_project(V, w, mask, basis=None, *, rows=None, block_n=16384,
                interpret=False):
    """K7: one classical Gram-Schmidt projection pass over the leading
    ``rows`` rows, ``c = (conj(V[:rows]) w) * mask`` and ``w_orth = w -
    c^T B[:rows]``; returns ``(w_orth, c)`` with ``c`` of length m, zero
    past ``rows``.  ``basis`` is the ``(m, N)`` basis to subtract along
    (default ``V``; the dual basis P of GMRES with ``M``, where ``V = M
    P``).  Counterpart of ``krypy_tpu.kernels.orthogonalize.cgs_project``;
    ``rows`` (default m) replaces its full-height masked sweep.  Phase 0
    is K4's sweep (the same coefficient bits as :func:`project_prefix`);
    phase 1 is K6's update or, where N is not a multiple of the 16-byte
    group (4 float32 or 2 float64 columns), an update on K4's grid that
    reads every row in aligned 16-byte groups shifted across lanes.
    ``block_n``, ``interpret``: :func:`~krypy_tpu_torch.kernels._launch.
    jax_keywords`."""
    mask = _mask(mask, V)
    B = V if basis is None else basis
    rows, cuda = _check("cgs_project", V, rows, (w,), (mask,))
    if B.shape != V.shape or B.dtype != V.dtype or B.device != V.device \
            or not B.is_contiguous():
        raise ValueError(
            "cgs_project: basis must be contiguous and match V's shape, "
            f"dtype and device, got {tuple(B.shape)} {B.dtype} {B.device}")
    if jax_keywords(interpret) or not cuda:
        return cgs_project_torch(V, w, mask, B, rows)
    m, N = V.shape
    blocks, threads = launch_config(N, rows, V.element_size(),
                                   "cgs_project")
    update_blocks, _ = launch_config(N, rows, V.element_size(),
                                     "update_prefix")
    partial = torch.empty(blocks * rows, dtype=V.dtype, device=V.device)
    w_out = torch.empty(N, dtype=V.dtype, device=V.device)
    c = torch.empty(m, dtype=V.dtype, device=V.device)
    _launch(
        "cgs_project", f"krypy_cgs_project_{_SUFFIX[V.dtype]}",
        (V.data_ptr(), B.data_ptr(), w.data_ptr(), mask.data_ptr(),
         partial.data_ptr(), w_out.data_ptr(), c.data_ptr(), N, rows, m,
         blocks, threads, row_chunk(rows), update_blocks),
        V.device,
    )
    return w_out, c
