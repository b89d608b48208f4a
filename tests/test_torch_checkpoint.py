"""The port's ``checkpoint`` module: tests/test_checkpoint.py's four cases
on the port (``device="cpu"``), each against the JAX package's run of
the same case where it solves, and a directory written by each package
loaded by the other: the same keys, scalars equal and arrays bit for
bit."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from krypy_tpu import checkpoint as jcheckpoint, functional as JF
from krypy_tpu import ops as jops
from krypy_tpu_torch import checkpoint, functional as F, interop, ops

torch.set_num_threads(1)


def _tree(lib):
    """tests/test_checkpoint.py's tree, in ``lib``'s arrays (with a
    float32 and a complex leaf, and a list)."""
    arr = (lambda a: torch.tensor(a)) if lib == "torch" else jnp.asarray
    return {
        "x": arr(np.arange(10.0)),
        "nested": {"H": arr(np.eye(3)), "count": 4, "name": "gmres"},
        "missing": None,
        "f32": arr(np.linspace(0, 1, 5).astype(np.float32)),
        "c": arr(np.array([1 + 2j, 3 - 1j])),
        "seq": [arr(np.ones(2)), 1.5, True],
    }


def test_save_load_roundtrip(tmp_path):
    ck = str(tmp_path / "ck")
    checkpoint.save(ck, _tree("torch"))
    out = checkpoint.load(ck, device="cpu")
    assert isinstance(out["x"], torch.Tensor) and out["x"].device.type == \
        "cpu"
    np.testing.assert_allclose(out["x"].numpy(), np.arange(10.0))
    np.testing.assert_allclose(out["nested/H"].numpy(), np.eye(3))
    assert out["nested/count"] == 4
    assert out["nested/name"] == "gmres"
    assert out["missing"] is None
    assert out["f32"].dtype == torch.float32
    assert out["seq/1"] == 1.5 and out["seq/2"] is True
    host = checkpoint.load(ck, device=False)
    assert isinstance(host["x"], np.ndarray)
    np.testing.assert_array_equal(host["c"], [1 + 2j, 3 - 1j])
    # device=True means the card: without one that raises, no fallback
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            checkpoint.load(ck)


def test_load_missing_returns_none(tmp_path):
    assert checkpoint.load(str(tmp_path / "nope")) is None
    assert checkpoint.load(str(tmp_path / "nope"), device="cpu") is None


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_directories_load_across_packages(tmp_path, writer):
    """A directory written by either package loads in the other: the same
    keys, scalars and None equal, arrays bit for bit with their dtypes."""
    ck = str(tmp_path / writer)
    if writer == "jax":
        jcheckpoint.save(ck, _tree("jax"))
        want = jcheckpoint.load(ck, device=False)
        got = checkpoint.load(ck, device=False)
        got_t = checkpoint.load(ck, device="cpu")
    else:
        checkpoint.save(ck, _tree("torch"))
        got = jcheckpoint.load(ck, device=False)
        want = checkpoint.load(ck, device=False)
        got_t = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                 for k, v in jcheckpoint.load(ck).items()}
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        for g in (got[key], got_t[key]):
            if isinstance(w, np.ndarray):
                g = interop.to_numpy(g) if isinstance(g, torch.Tensor) \
                    else np.asarray(g)
                assert g.dtype == w.dtype, key
                np.testing.assert_array_equal(g, w, err_msg=key)
            else:
                assert g == w and type(g) is type(w), key
    with open(f"{ck}/meta.json") as fh:
        assert "nested/H" in fh.read()
    with np.load(f"{ck}/arrays.npz") as data:
        assert "nested__H" in data.files


def test_resumable_restarted_gmres(tmp_path):
    A = np.diag(np.arange(2.0, 102.0))
    b = torch.ones(100, dtype=torch.float64)
    ckdir = str(tmp_path / "solve")

    # run only 2 restart cycles, then "preempt"
    res1 = checkpoint.resumable_restarted_gmres(
        torch.tensor(A), b, ckdir, tol=1e-10, maxiter=10, max_restarts=1)
    assert int(res1.status) == F.MAXITER
    state = checkpoint.load(ckdir, device="cpu")
    assert int(state["restart"]) == 2

    # resume in a "new process": continues from the checkpointed iterate
    res2 = checkpoint.resumable_restarted_gmres(
        torch.tensor(A), b, ckdir, tol=1e-10, maxiter=10, max_restarts=30)
    assert int(res2.status) == F.CONVERGED
    x = interop.to_numpy(res2.x)
    rel = np.linalg.norm(np.ones(100) - A @ x) / 10.0
    assert rel <= 1e-10
    r = interop.to_numpy(res2.resnorms)
    assert r[0] == 1.0
    assert r[-1] <= 1e-10

    # the JAX package's run of the same two processes: the same histories
    jdir = str(tmp_path / "jax")
    jcheckpoint.resumable_restarted_gmres(
        jnp.asarray(A), jnp.ones(100), jdir, tol=1e-10, maxiter=10,
        max_restarts=1)
    jres = jcheckpoint.resumable_restarted_gmres(
        jnp.asarray(A), jnp.ones(100), jdir, tol=1e-10, maxiter=10,
        max_restarts=30)
    want = np.asarray(jres.resnorms)
    assert r.shape == want.shape
    np.testing.assert_allclose(r, want, rtol=1e-6, atol=1e-14)
    np.testing.assert_allclose(x, np.asarray(jres.x), rtol=0, atol=1e-10)

    # a third call finds the finished run on disk and only rebuilds it
    res3 = checkpoint.resumable_restarted_gmres(
        torch.tensor(A), b, ckdir, tol=1e-10, maxiter=10, max_restarts=1)
    assert int(res3.status) == F.CONVERGED
    np.testing.assert_array_equal(interop.to_numpy(res3.x), x)


def test_checkpointed_recycling(tmp_path):
    N = 100
    d = np.linspace(1, 2, N)
    d[:4] = [1e-4, 1e-3, 5e-3, 2e-2]
    A = ops.diagonal(torch.tensor(d, dtype=torch.float64))
    b = torch.ones(N, dtype=torch.float64)
    ckdir = str(tmp_path / "rec")

    rec1 = checkpoint.CheckpointedRecycling(
        ckdir, n_vectors=3, which="sm", hermitian=True, device="cpu")
    r0 = rec1.solve(A, b, tol=1e-6, maxiter=100)

    state = checkpoint.load(ckdir, device="cpu")
    assert state is not None and state.get("U") is not None
    U = state["U"].numpy()
    assert U.shape == (N, 3) and np.all(np.isfinite(U))

    # "new process": the recycled basis comes from disk, on the device
    rec2 = checkpoint.CheckpointedRecycling(
        ckdir, n_vectors=3, which="sm", hermitian=True, device="cpu")
    assert rec2._rec._U is not None
    assert torch.equal(rec2._rec._U, state["U"])
    r1 = rec2.solve(A, b, tol=1e-6, maxiter=100)
    assert int(r1.niter) < int(r0.niter)

    # the JAX package's two processes: the same counts
    jdir = str(tmp_path / "jax")
    jA = jops.diagonal(jnp.asarray(d))
    j0 = jcheckpoint.CheckpointedRecycling(
        jdir, n_vectors=3, which="sm", hermitian=True).solve(
            jA, jnp.ones(N), tol=1e-6, maxiter=100)
    j1 = jcheckpoint.CheckpointedRecycling(
        jdir, n_vectors=3, which="sm", hermitian=True).solve(
            jA, jnp.ones(N), tol=1e-6, maxiter=100)
    assert [int(r0.niter), int(r1.niter)] == [int(j0.niter), int(j1.niter)]
    assert JF.CONVERGED == F.CONVERGED


def test_checkpoint_resumes_a_sequence_as_if_uninterrupted(tmp_path):
    """Save after the second of four solves, resume in a fresh object:
    the reloaded basis is the saved one bit for bit, and the last two
    solves take the uninterrupted sequence's iterations (the chip smoke
    phase runs this at config 4's size)."""
    N = 100
    base = np.linspace(1, 2, N)
    base[:4] = [1e-6, 1e-3, 5e-3, 2e-2]
    ops_seq = [ops.diagonal(torch.tensor(base * (1.0 + 0.01 * i)))
               for i in range(4)]
    b = torch.ones(N, dtype=torch.float64)
    kw = dict(tol=1e-6, maxiter=N)

    whole = F.RecyclingGmres(n_vectors=3, which="sm", hermitian=True)
    want = [int(whole.solve(A, b, **kw).niter) for A in ops_seq]

    ckdir = str(tmp_path / "seq")
    first = checkpoint.CheckpointedRecycling(
        ckdir, n_vectors=3, which="sm", hermitian=True, device="cpu")
    got = [int(first.solve(A, b, **kw).niter) for A in ops_seq[:2]]
    saved = checkpoint.load(ckdir, device=False)["U"]
    second = checkpoint.CheckpointedRecycling(
        ckdir, n_vectors=3, which="sm", hermitian=True, device="cpu")
    np.testing.assert_array_equal(second._rec._U.numpy(), saved)
    got += [int(second.solve(A, b, **kw).niter) for A in ops_seq[2:]]
    assert got == want
