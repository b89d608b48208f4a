"""Shared mesh price model for the ``auto`` scheme and variant rules
(counterpart of :mod:`krypy_tpu.functional.policy`).

Every latency-against-bandwidth decision of the solvers (GMRES
``ortho="auto"``, CG/MINRES ``variant="auto"``, the deflated short
recurrences' ``variant="auto"``) prices the same two quantities:

* the cost of ONE sync point, an all-reduce round trip over the mesh
  (:func:`sync_s`), and
* the cost of streaming one byte of local memory traffic
  (``1 / hbm_bytes_per_s``).

A one-reduce rearrangement trades sync points for extra local traffic,
so the decision is ``syncs_saved * sync_s > extra_sweeps * n_local *
itemsize / hbm_bytes_per_s``, with ``extra_sweeps`` per solver in
:data:`ONE_REDUCE_EXTRA_SWEEPS`.

The constants resolve, in this order, from

1. an explicit module override (``policy.SYNC_S`` /
   ``policy.HBM_BYTES_PER_S``; tests monkeypatch these, and an embedder
   can set them after timing its own fabric),
2. the ``KRYPY_TPU_SYNC_S`` / ``KRYPY_TPU_HBM_BYTES_PER_S`` environment
   variables (the JAX package's names),
3. a table keyed by the device type of the system's tensors
   (``"cuda"``, ``"cpu"``); another device type reads the ``"cuda"`` row.

This module imports neither torch nor jax: a device is named by its type
(a string) or by anything with a ``.type`` (a ``torch.device``).
"""

import os

__all__ = [
    "sync_s",
    "hbm_bytes_per_s",
    "sweep_s",
    "prefer_one_reduce",
    "fused_sharded_wins",
    "ONE_REDUCE_EXTRA_SWEEPS",
]

#: explicit overrides; ``None`` means "resolve from the environment or the
#: table".  Tests monkeypatch these to force either regime.
SYNC_S = None
HBM_BYTES_PER_S = None

#: one sync point (all-reduce round trip), seconds, by device type.
#: ``"cuda"``: one NCCL all-reduce of a one-element float32 tensor on a
#: one-rank world plus the host read a solver loop makes per iteration,
#: median of 200 (chip_smoke.py's onereduce phase; NVIDIA H100 80GB
#: HBM3, power limit 700.00 W).  A one-card floor: no all-reduce between
#: cards has been measured.  ``"cpu"``: the JAX package's order of
#: magnitude for ranks sharing one host, so that ``auto`` on the CPU test
#: meshes picks what the JAX package picks there.
SYNC_S_TABLE = {
    "cuda": 5.926350e-05,
    "cpu": 2e-6,
}

#: local memory stream rate, bytes/second, by device type.  ``"cuda"``: a
#: device copy of a 1 GiB float32 tensor, bytes read plus written over the
#: time, median of 20 (chip_smoke.py's onereduce phase; NVIDIA H100 80GB
#: HBM3, power limit 700.00 W).  ``"cpu"``: the JAX package's figure.
HBM_BYTES_PER_S_TABLE = {
    "cuda": 2.956859e12,
    "cpu": 40e9,
}

#: extra local traffic of the one-reduce rearrangement, in equivalent
#: vector sweeps per iteration: the JAX package's ratios (a solver's
#: measured extra cost per iteration over the time of one vector sweep).
#: The H100's own ratios are measured by chip_smoke.py's onereduce phase
#: and recorded in PERF.md beside these; the table is not changed here.
#: The entries of the solvers not ported yet (``qmr``, ``idrs``,
#: ``shifted_cg``) come with them.
ONE_REDUCE_EXTRA_SWEEPS = {
    "cg": 12.4,
    "minres": 16.2,
    # deflated short recurrences (d = 4); MINRES's fold has CG's shape
    "deflated_cg": 16.0,
    "deflated_minres": 16.0,
}


def _row(table, device):
    kind = "cuda" if device is None else getattr(device, "type", device)
    return table.get(str(kind), table["cuda"])


def sync_s(device=None):
    """Cost of one mesh sync point (all-reduce round trip), seconds, for
    tensors on ``device`` (a device type or a ``torch.device``; default
    ``"cuda"``)."""
    if SYNC_S is not None:
        return float(SYNC_S)
    env = os.environ.get("KRYPY_TPU_SYNC_S")
    if env:
        return float(env)
    return _row(SYNC_S_TABLE, device)


def hbm_bytes_per_s(device=None):
    """Local memory stream rate, bytes/second, for tensors on
    ``device``."""
    if HBM_BYTES_PER_S is not None:
        return float(HBM_BYTES_PER_S)
    env = os.environ.get("KRYPY_TPU_HBM_BYTES_PER_S")
    if env:
        return float(env)
    return _row(HBM_BYTES_PER_S_TABLE, device)


def sweep_s(n_local, itemsize, device=None):
    """Time to stream one ``n_local``-element local vector, seconds."""
    return n_local * itemsize / hbm_bytes_per_s(device)


def prefer_one_reduce(solver, n_local, itemsize, syncs_saved=1,
                      device=None):
    """Should the ``auto`` rule pick the one-reduce variant?  True when
    the sync time saved per iteration exceeds the extra local traffic the
    rearrangement streams per shard.  ``solver`` indexes
    :data:`ONE_REDUCE_EXTRA_SWEEPS`; an unknown solver prices at CG's
    figure.  On a latency-cheap mesh with large shards this is False:
    classic CG, with less local traffic, is the bandwidth choice there."""
    extra = ONE_REDUCE_EXTRA_SWEEPS.get(solver,
                                        ONE_REDUCE_EXTRA_SWEEPS["cg"])
    return syncs_saved * sync_s(device) > extra * sweep_s(
        n_local, itemsize, device)


def fused_sharded_wins(basis_rows, n_local, itemsize, extra_syncs=2,
                       device=None):
    """GMRES on a mesh: does the sharded fused CGS2 (three local sweeps,
    three sync points) beat the one-reduce scheme (one sync point)?  The
    fused scheme saves ONE local sweep of the basis per iteration and
    pays ``extra_syncs`` more all-reduces; it wins where the saved sweep
    takes longer than the extra round trips (a tall basis, a large shard,
    slow memory against the interconnect)."""
    saved_s = sweep_s(basis_rows * n_local, itemsize, device)
    return saved_s > extra_syncs * sync_s(device)
