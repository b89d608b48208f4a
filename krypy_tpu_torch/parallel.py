"""Meshes over ``torch.distributed``: the distributed layer of the port
(counterpart of :mod:`krypy_tpu.parallel`).

The JAX package shards over a 1-D device mesh by GSPMD: vectors and the
Krylov basis ``(m+1, N)`` are split along N, the small dense state
(Hessenberg, Givens, projected rhs) is replicated, and XLA inserts the
collectives.  Here a mesh is a ``torch.distributed`` process group, one
process per shard.  Each rank holds its own contiguous block of every
N-long vector and of every basis row, the solvers run unchanged on those
blocks inside ``with mesh:``, and the port's code communicates in two
places only, both counted (:data:`COLLECTIVES`):

* :func:`all_reduce_sum`: each reduction over N is a local partial and
  one all-reduce (inner products and norms in
  :func:`krypy_tpu_torch.functional.common.make_inner`, the coefficient
  sums of the sharded CGS2 kernel);
* :func:`halo_exchange`: the one-row halo of the sharded stencil, the
  counterpart of the JAX kernel's ``ppermute``.

Both NCCL's and gloo's all-reduce hand every rank the same bits, so every
rank reads the same host scalars and takes the same branches: replicated
state stays identical without a broadcast.

The transport follows the group's backend, never a caught failure: with
NCCL, CUDA tensors go straight to ``dist.all_reduce`` and
``dist.batch_isend_irecv``; gloo has no CUDA send, receive or
all-reduce, so CUDA tensors are staged through pinned host memory, and
CPU tensors go straight.

Typical use, one process per rank (``torchrun`` or
``torch.multiprocessing``)::

    parallel.init_distributed("tcp://localhost:29500", world_size, rank)
    mesh = parallel.make_mesh()                 # device cuda:<local rank>
    A = ops.poisson_2d(nx, impl="cuda", mesh=mesh, device=mesh.device)
    b = parallel.shard_vector(b_global, mesh)   # this rank's block
    with mesh:
        result = functional.cg(A, b, tol=1e-8, maxiter=500)
    x = parallel.gather_vector(result.x, mesh)  # every rank: the whole x
"""

import datetime
import os
import subprocess
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "init_distributed",
    "Mesh",
    "make_mesh",
    "active_mesh",
    "active_mesh_size",
    "block_of",
    "shard_vector",
    "make_global_vector",
    "replicate",
    "sharded_solve",
    "gather_vector",
    "all_reduce_sum",
    "halo_exchange",
    "COLLECTIVES",
    "collective_counts",
    "reset_collective_counts",
    "file_rendezvous",
    "launch_ranks",
]

#: calls of each collective helper (the port's only communication)
COLLECTIVES = {"all_reduce_sum": 0, "halo_exchange": 0}

#: the meshes of the enclosing ``with mesh:`` blocks, innermost last
_ACTIVE = []


def collective_counts():
    """Copy of the per-helper call counters."""
    return dict(COLLECTIVES)


def reset_collective_counts():
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


def init_distributed(init_method=None, world_size=None, rank=None,
                     backend=None, timeout=None, local_device_count=None):
    """Join this process to the world: a wrapper of
    ``dist.init_process_group``.  ``backend`` defaults to NCCL where torch
    sees a CUDA device and gloo elsewhere; ``timeout`` (seconds) bounds
    every collective.  ``init_method``, ``world_size`` and ``rank`` default
    to torch's environment variables (what ``torchrun`` sets).

    ``local_device_count`` (the JAX package's count of virtual XLA
    devices) has no counterpart, a rank being one process: passing it
    raises ``ValueError``."""
    if local_device_count is not None:
        raise ValueError(
            "local_device_count has no counterpart in the port: a mesh is "
            "a process group with one process per shard; start that many "
            "ranks instead")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs = {}
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=-1 if world_size is None
                            else world_size,
                            rank=-1 if rank is None else rank, **kwargs)


class Mesh:
    """A 1-D mesh over the vector axis: the world's process group, the
    axis name ``"n"``, its ``size``, this process's ``rank`` and the ``device`` that holds
    its blocks (default ``cuda:<local rank>``, the local rank from
    ``LOCAL_RANK`` as ``torchrun`` sets it, else the rank; ``device="cpu"``
    for ranks on the CPU).  Use it as a context manager, the counterpart
    of ``with mesh:``: inside it the solvers reduce over the mesh.

    Unlike the JAX package's ``active_mesh``, a mesh of ONE rank counts
    as a mesh: its collectives are real calls (of one rank)."""

    def __init__(self, device=None):
        if not dist.is_initialized():
            raise RuntimeError("torch.distributed is not initialized: call "
                               "parallel.init_distributed first")
        self.group = dist.group.WORLD
        self.size = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self.backend = dist.get_backend(self.group)
        self.axis_names = ("n",)
        #: the halo exchanges' buffers, by row width, dtype and device
        self.halo_buffers = {}
        if device is None:
            local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
            device = torch.device("cuda", local % max(
                torch.cuda.device_count(), 1))
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if self.device.index is None:
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
            torch.cuda.set_device(self.device)
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError("an NCCL mesh keeps its blocks on a CUDA "
                             f"device, got {self.device}")

    def __enter__(self):
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return False


def _check_axis(axis_name):
    """A mesh of the port has the one axis ``"n"`` (the world's group);
    ``axis_name`` is accepted for the JAX package's signatures and must
    name it."""
    if axis_name not in (None, "n"):
        raise ValueError(f"axis_name={axis_name!r}: a mesh of the port is "
                         "the world's process group on the one axis 'n'")


def make_mesh(n_devices=None, axis_name="n", device=None):
    """The mesh over the whole world.  ``n_devices``, where given, must be
    the world's size: a mesh has one rank per shard.  ``axis_name`` must
    be ``"n"`` (``ValueError`` otherwise)."""
    _check_axis(axis_name)
    mesh = Mesh(device=device)
    if n_devices is not None and n_devices != mesh.size:
        raise ValueError(f"n_devices={n_devices}, but the process group has "
                         f"{mesh.size} ranks (one rank per shard)")
    return mesh


def active_mesh():
    """The mesh of the innermost enclosing ``with mesh:`` block, or
    None."""
    return _ACTIVE[-1] if _ACTIVE else None


def active_mesh_size():
    """Ranks of the active mesh, or 0 where none is active."""
    mesh = active_mesh()
    return 0 if mesh is None else mesh.size


def block_of(n, mesh):
    """This rank's slice of an axis of length ``n``: the JAX package's
    layout of an uneven split, blocks of ``ceil(n / P)``, the last ones
    shorter (or empty)."""
    step = -(-n // mesh.size)
    return slice(min(mesh.rank * step, n), min((mesh.rank + 1) * step, n))


def shard_vector(x, mesh, axis_name=None):
    """This rank's block of a vector (or of a row-major basis: the LAST
    axis is split, as the JAX ``shard_vector`` does), contiguous on
    ``mesh.device``.  ``x`` is the whole array on every rank (a tensor or
    anything ``np.asarray`` takes); ``axis_name``, where given, must be
    ``"n"``."""
    _check_axis(axis_name)
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x))
    return x[..., block_of(x.shape[-1], mesh)].to(mesh.device).contiguous()


def make_global_vector(mesh, data_for_index, global_shape, dtype=None,
                       axis_name=None, sharded_axis=0):
    """This rank's block of an array that no process holds whole:
    ``data_for_index`` maps the block's index tuple (slices into the
    ``global_shape`` array) to its data, as in the JAX
    ``make_global_vector``; ``sharded_axis`` is split, the others are
    whole; ``axis_name``, where given, must be ``"n"``."""
    _check_axis(axis_name)
    index = [slice(None)] * len(global_shape)
    index[sharded_axis] = block_of(global_shape[sharded_axis], mesh)
    arr = np.asarray(data_for_index(tuple(index)))
    if dtype is not None:
        arr = arr.astype(dtype)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(mesh.device)


def replicate(x, mesh):
    """Small state, the same on every rank, as a tensor on the mesh's
    device."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x))
    return x.to(mesh.device)


def sharded_solve(solver, A, b, mesh=None, **kwargs):
    """Run a solver of :mod:`krypy_tpu_torch.functional` with ``b`` (the
    whole right-hand side, on every rank) and all N-long state sharded
    over the mesh (default: :func:`make_mesh`); the result's ``x`` is this
    rank's block."""
    if mesh is None:
        mesh = make_mesh()
    with mesh:
        return solver(A, shard_vector(b, mesh), **kwargs)


def gather_vector(x, mesh):
    """The whole vector from every rank's block (for tests and checks:
    the solvers never gather).  Every rank must call it; blocks may be
    uneven, as :func:`block_of` lays them out."""
    x = x.reshape(-1)
    n = _host_sum(torch.tensor([x.shape[0]]), mesh)
    step = -(-int(n[0]) // mesh.size)
    pad = torch.zeros(step, dtype=x.dtype, device=x.device)
    pad[: x.shape[0]] = x
    buf = pad.cpu() if mesh.backend != "nccl" and x.is_cuda else pad
    parts = [torch.empty_like(buf) for _ in range(mesh.size)]
    dist.all_gather(parts, buf, group=mesh.group)
    return torch.cat(parts)[: int(n[0])].to(x.device)


def _host_sum(t, mesh):
    """Sum of a small CPU tensor over the ranks (uncounted: set-up)."""
    t = t.clone()
    if mesh.backend == "nccl":
        d = t.to(mesh.device)
        dist.all_reduce(d, group=mesh.group)
        return d.cpu()
    dist.all_reduce(t, group=mesh.group)
    return t


def all_reduce_sum(t, mesh=None):
    """The sum of ``t`` over the ranks of ``mesh`` (default: the active
    mesh), as a new tensor on ``t``'s device; ``t`` is left as it is.
    Counted in ``COLLECTIVES["all_reduce_sum"]``."""
    mesh = active_mesh() if mesh is None else mesh
    if mesh.backend != "nccl" and t.is_cuda:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        dist.all_reduce(host, group=mesh.group)
        out = host.to(t.device)
    else:
        out = t.clone()
        dist.all_reduce(out, group=mesh.group)
    COLLECTIVES["all_reduce_sum"] += 1
    return out


#: elements a halo buffer's rows are rounded up to: every row then starts
#: on a 16-byte boundary, as K8's kernel stages rows in 16-byte copies
_HALO_ALIGN = 4


class _HaloBuffers:
    """The buffers of a mesh's halo exchanges of one row width, dtype and
    device, made once and reused by every such exchange: ``recv`` the two
    received rows (zeros where no neighbour writes), on the rows' device
    for NCCL and CPU rows, in pinned host memory for CUDA rows under gloo;
    for those also ``send`` (pinned: the edge rows staged out) and ``dev``
    (the received rows copied to the device).  Rows are ``pitch`` elements
    apart, a multiple of ``_HALO_ALIGN``."""

    def __init__(self, row, staged):
        n = row.shape[-1]
        self.n = n
        self.pitch = -(-n // _HALO_ALIGN) * _HALO_ALIGN

        def rows(**where):
            return torch.zeros((2, self.pitch), dtype=row.dtype, **where)

        self.recv = rows(pin_memory=True) if staged else rows(
            device=row.device)
        self.send = rows(pin_memory=True) if staged else None
        self.dev = rows(device=row.device) if staged else None

    def stage_out(self, first_row, last_row):
        """Both edge rows into ``send`` in one copy (two where they are not
        disjoint rows of one buffer), then wait for it."""
        from .kernels._launch import copy_rows

        first_row, last_row = first_row.contiguous(), last_row.contiguous()
        es = first_row.element_size()
        width, pitch = self.n * es, self.pitch * es
        gap = last_row.data_ptr() - first_row.data_ptr()
        device = first_row.device
        if gap >= width:
            copy_rows(self.send.data_ptr(), pitch, first_row.data_ptr(), gap,
                      width, 2, device)
        else:
            for k, row in enumerate((first_row, last_row)):
                copy_rows(self.send[k].data_ptr(), pitch, row.data_ptr(),
                          width, width, 1, device)
        torch.cuda.current_stream(device).synchronize()


class _Halo:
    """A posted halo exchange; :meth:`wait` returns ``(top, bottom)``."""

    def __init__(self, works, bufs, mapped):
        self._works, self._bufs, self._mapped = works, bufs, mapped

    def wait(self):
        for w in self._works:
            w.wait()
        b = self._bufs
        rows = b.recv
        if b.dev is not None and not self._mapped:
            if self._works:
                b.dev.copy_(b.recv, non_blocking=True)
            rows = b.dev
        return rows[0, :b.n], rows[1, :b.n]


def halo_exchange(first_row, last_row, mesh=None, async_op=False, *,
                  mapped=False):
    """Send this rank's first row to the rank before it and its last row
    to the rank after it; return ``(top, bottom)``, the previous rank's
    last row and the next rank's first row, zeros where there is no
    neighbour (the Dirichlet edge, as ``ppermute`` gives).  With
    ``async_op=True`` it returns a handle whose ``wait()`` returns them,
    so that local work can run in between: with NCCL the transfers run on
    NCCL's stream and ``wait()`` orders them before later work on the
    current stream, with no host wait; with gloo the rows cross through
    host memory while the card runs what was launched.  Counted in
    ``COLLECTIVES["halo_exchange"]``.

    The rows returned are views of buffers that the mesh keeps for each
    row width and reuses in its next exchange (:class:`_HaloBuffers`):
    copy them to keep them.  CUDA rows under gloo take one staging copy
    each way: both edge rows out to pinned host memory in one copy, and
    the received rows back to the device in one copy, or, with
    ``mapped=True``, none: the rows returned are then the pinned receive
    buffer itself, which a kernel reads in place (K8's)."""
    mesh = active_mesh() if mesh is None else mesh
    key = (first_row.shape[-1], first_row.dtype, first_row.device)
    bufs = mesh.halo_buffers.get(key)
    if bufs is None:
        bufs = mesh.halo_buffers[key] = _HaloBuffers(
            first_row, mesh.backend != "nccl" and first_row.is_cuda)
    peers = [(mesh.rank - 1, 0), (mesh.rank + 1, 1)]
    peers = [(p, k) for p, k in peers if 0 <= p < mesh.size]
    sends = (first_row, last_row)
    if bufs.send is not None and peers:
        bufs.stage_out(first_row, last_row)
        sends = (bufs.send[0, :bufs.n], bufs.send[1, :bufs.n])
    ops = []
    for peer, k in peers:
        peer = dist.get_global_rank(mesh.group, peer)
        ops += [dist.P2POp(dist.isend, sends[k].contiguous(), peer,
                           mesh.group),
                dist.P2POp(dist.irecv, bufs.recv[k, :bufs.n], peer,
                           mesh.group)]
    works = dist.batch_isend_irecv(ops) if ops else []
    COLLECTIVES["halo_exchange"] += 1
    handle = _Halo(works, bufs, mapped)
    return handle if async_op else handle.wait()


def file_rendezvous(workdir):
    """The ``init_method`` of a world whose ranks share ``workdir``'s file
    system: ``file://`` rendezvous, no TCP port to choose."""
    return f"file://{Path(workdir).resolve() / 'rendezvous'}"


def launch_ranks(argv_of_rank, world_size, workdir, timeout, env=None):
    """Start the ``world_size`` processes of one world on this host, the
    command ``argv_of_rank(rank)`` each, with their output in
    ``workdir/rank{rank}.log``, and wait: until every one has ended, one
    has failed, or ``timeout`` seconds have passed.  Every process still
    running then is killed.  ``env`` adds to this process's environment
    (gloo and NCCL use the loopback device unless it says otherwise).

    Returns the ranks' logs; raises ``RuntimeError``, the exit codes and
    the logs in its message, unless every rank exited 0."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    env = {"GLOO_SOCKET_IFNAME": "lo", "NCCL_SOCKET_IFNAME": "lo",
           **os.environ, **(env or {})}
    logs = [open(workdir / f"rank{r}.log", "w+") for r in range(world_size)]
    procs = [subprocess.Popen(argv_of_rank(r), stdout=log,
                              stderr=subprocess.STDOUT, env=env)
             for r, log in enumerate(logs)]
    deadline = time.monotonic() + timeout
    try:
        while time.monotonic() < deadline:
            codes = [p.poll() for p in procs]
            if None not in codes or any(codes):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        text = []
        for log in logs:
            log.seek(0)
            text.append(log.read())
            log.close()
    codes = [p.returncode for p in procs]
    if any(codes):
        raise RuntimeError(
            f"world of {world_size} ranks: exit codes {codes} (a rank failed, "
            f"or the {timeout} s deadline passed)\n" + "\n".join(
                f"--- rank {r} ---\n{t}" for r, t in enumerate(text)))
    return text
