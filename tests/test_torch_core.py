"""The port's core subpackage (krypy_tpu_torch.core) against
krypy_tpu.core on the cases of tests/test_core.py, float64 / complex128 on
the same numpy inputs.

Tolerances: 1e-13 relative to the operands' scale for products, norms,
reflections and rotations (the same arithmetic, summed in another order);
QR factors to 1e-12 of max|X| (LAPACK's Householder QR on both sides, so
the signs agree; modified Gram-Schmidt with ``ip_B`` is the same loop);
operator algebra exact to 1e-12 as in test_core.py.
"""

import numpy as np
import pytest
import scipy.linalg
import torch

import jax.numpy as jnp

from krypy_tpu import utils as ju
from krypy_tpu_torch import errors
from krypy_tpu_torch.core import dtypes, operators as O, products as P, qr as Q
from krypy_tpu_torch.core import rotations as R, timers

from helpers import get_ip_Bs

torch.set_num_threads(1)

_factors = [0.0, 1.0, 1.0j, 1.0 + 1.0j, 1e8, 1e-8]
_B = np.diag(np.linspace(1, 5, 10))


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _ip_pair(i):
    """The ``i``-th inner product of helpers.get_ip_Bs for both packages."""
    Bt = _t(_B)
    port = [None, O.MatrixLinearOperator(_B, device="cpu"),
            lambda x, y: P.ip_euclid(x, Bt.to(y.dtype) @ y)][i]
    return port, get_ip_Bs()[i]


def _close(got, want, tol=1e-13):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(initial=0.0), 1.0)
    assert np.abs(got - want).max(initial=0.0) <= tol * scale


@pytest.mark.parametrize("a", _factors)
@pytest.mark.parametrize("b", _factors)
@pytest.mark.parametrize("length", [10, 1])
def test_house_matches_jax(a, b, length):
    x = np.ones((length, 1), dtype=np.array([a]).dtype) * b
    x[0] = a
    Hj = ju.House(jnp.asarray(x))
    Ht = R.House(_t(x))
    I = np.eye(length)
    for got, want in ((Ht.apply(_t(x)), Hj.apply(jnp.asarray(x))),
                      (Ht.apply(_t(I)), Hj.apply(jnp.asarray(I))),
                      (Ht.matrix(), Hj.matrix()),
                      (Ht.v, Hj.v)):
        _close(got, want, 1e-13)
    assert abs(complex(Ht.alpha) - complex(Hj.alpha)) <= 1e-14
    assert abs(float(Ht.xnorm) - float(Hj.xnorm)) <= 1e-14 * max(
        float(Hj.xnorm), 1.0)
    assert float(Ht.beta) == float(Hj.beta)


@pytest.mark.parametrize("a", _factors)
@pytest.mark.parametrize("b", _factors)
def test_givens_matches_jax(a, b):
    x = np.array([[a], [b]])
    Gj, Gt = ju.Givens(x), R.Givens(x)
    np.testing.assert_allclose(Gt.G, Gj.G, rtol=0, atol=1e-15)
    _close(Gt.apply(_t(x)), np.asarray(Gj.apply(x)), 1e-14)
    assert isinstance(Gt.apply(x), np.ndarray)
    c, s, r = R.givens_coeffs(_t(np.array(a, dtype=x.dtype)),
                              _t(np.array(b, dtype=x.dtype)))
    cj, sj, rj = ju.givens_coeffs(jnp.asarray(x[0, 0]), jnp.asarray(x[1, 0]))
    for got, want in ((c, cj), (s, sj), (r, rj)):
        _close(got, want, 1e-14)
    v, beta, alpha, xn = R.house_vector(_t(x[:, 0]))
    vj, betaj, alphaj, xnj = ju.house_vector(jnp.asarray(x[:, 0]))
    for got, want in ((v, vj), (beta, betaj), (alpha, alphaj), (xn, xnj)):
        _close(got, want, 1e-13)


@pytest.mark.parametrize("X", [np.eye(10, 5), scipy.linalg.hilbert(10)[:, :5]],
                         ids=["eye", "hilbert"])
@pytest.mark.parametrize("ip", [0, 1, 2])
@pytest.mark.parametrize("reorthos", [0, 1, 2])
def test_qr_matches_jax(X, ip, reorthos):
    ipt, ipj = _ip_pair(ip)
    Qt, Rt = Q.qr(_t(X), ip_B=ipt, reorthos=reorthos)
    Qj, Rj = ju.qr(jnp.asarray(X), ip_B=ipj, reorthos=reorthos)
    _close(Qt, Qj, 1e-12)
    _close(Rt, Rj, 1e-12)
    # the port's own properties, as test_core.py states them
    assert np.linalg.norm(Qt.numpy() @ Rt.numpy() - X, 2) <= 1e-14 * max(
        scipy.linalg.svd(X, compute_uv=False))
    assert np.linalg.norm(np.tril(Rt.numpy(), -1)) == 0


@pytest.mark.parametrize("ip", [0, 1, 2])
@pytest.mark.parametrize("k", [1, 3])
def test_products_match_jax(ip, k):
    rng = np.random.default_rng(k)
    X = rng.standard_normal((10, k)) + 1j * rng.standard_normal((10, k))
    Y = rng.standard_normal((10, 2))
    ipt, ipj = _ip_pair(ip)
    _close(P.inner(_t(X), _t(Y), ip_B=ipt),
           ju.inner(jnp.asarray(X), jnp.asarray(Y), ip_B=ipj))
    _close(P.norm(_t(X), ip_B=ipt), ju.norm(jnp.asarray(X), ip_B=ipj))
    _close(P.norm(_t(Y[:, :1])), ju.norm(jnp.asarray(Y[:, :1])))
    _close(P.norm_squared(_t(Y[:, :1])),
           ju.norm_squared(jnp.asarray(Y[:, :1])))
    _close(P.ip_euclid(_t(X), _t(Y)), ju.ip_euclid(jnp.asarray(X),
                                                    jnp.asarray(Y)))
    _close(P.orthonormality(_t(X), ip_B=ipt),
           ju.orthonormality(jnp.asarray(X), ip_B=ipj))


def test_norm_raises_on_indefinite_products():
    x = _t(np.ones((3, 1)))
    with pytest.raises(errors.InnerProductError):
        P.norm_squared(x, inner_product=lambda a, b: -(a.T @ b))
    with pytest.raises(errors.InnerProductError):
        P.norm(x, ip_B=lambda a, b: 1j * (a.T @ b).to(torch.complex128))


def test_norm_MMlr_matches_jax():
    rng = np.random.default_rng(4)
    A = rng.standard_normal((6, 6)) + 6 * np.eye(6)
    d = rng.uniform(1, 2, 6)
    b, x0, yk = (rng.standard_normal((6, 1)) for _ in range(3))
    opt = [O.MatrixLinearOperator(m, device="cpu")
           for m in (np.diag(d), np.diag(1 / d), A, np.eye(6))]
    opj = [ju.MatrixLinearOperator(m)
           for m in (np.diag(d), np.diag(1 / d), A, np.eye(6))]
    got = P.norm_MMlr(*opt, _t(b), _t(x0), _t(yk))
    want = ju.norm_MMlr(*opj, jnp.asarray(b), jnp.asarray(x0),
                        jnp.asarray(yk))
    for g, w in zip(got, want):
        _close(g, w)


def test_operator_algebra_matches_jax():
    A = np.random.RandomState(0).randn(6, 6)
    B = np.random.RandomState(1).randn(6, 6)
    x = np.random.RandomState(2).randn(6, 2)
    At, Bt = (O.MatrixLinearOperator(m, device="cpu") for m in (A, B))
    Aj, Bj = ju.MatrixLinearOperator(A), ju.MatrixLinearOperator(B)
    xt, xj = _t(x), jnp.asarray(x)
    for got, want in (((At + Bt) * xt, (Aj + Bj) * xj),
                      ((At * Bt) * xt, (Aj * Bj) * xj),
                      ((2.5 * At) * xt, (2.5 * Aj) * xj),
                      ((At - Bt) * xt, (Aj - Bj) * xj),
                      ((At ** 3) * xt, (Aj ** 3) * xj),
                      (At.adj * xt, Aj.adj * xj),
                      ((1j * At).adj * xt, (1j * Aj).adj * xj)):
        _close(got, want, 1e-12)
    Id = O.IdentityLinearOperator((6, 6))
    assert (At * Id) is At and (Id * At) is At
    assert float(torch.linalg.norm(O.ZeroLinearOperator((6, 6)) * xt)) == 0
    D = O.DiagonalLinearOperator(np.diag(A), device="cpu")
    _close(D * xt, ju.DiagonalLinearOperator(jnp.asarray(np.diag(A))) * xj)
    # flat-vector application, numpy blocks on the operator's device
    assert tuple((At * x[:, 0]).shape) == (6,)
    Fop = O.FunctionLinearOperator((6, 6), np.float64, lambda v: _t(A) @ v,
                                   lambda v: _t(A).T @ v)
    _close(Fop * xt, A @ x, 1e-12)
    _close(Fop.adj * xt, A.T @ x, 1e-12)
    assert (At + Bt).dtype == torch.float64
    assert (1j * At).dtype == torch.complex128
    with pytest.raises(errors.LinearOperatorError):
        O.LinearOperator((6,), np.float64, dot=lambda v: v)


def test_get_linearoperator_forms():
    import scipy.sparse
    import scipy.sparse.linalg

    A = np.random.RandomState(3).randn(5, 5)
    x = np.random.RandomState(4).randn(5, 2)
    forms = [A, _t(A), scipy.sparse.csr_matrix(A),
             scipy.sparse.linalg.aslinearoperator(A)]
    for form in forms:
        op = O.get_linearoperator((5, 5), form, device="cpu")
        _close(op * _t(x), A @ x, 1e-13)
    assert isinstance(O.get_linearoperator((5, 5), None),
                      O.IdentityLinearOperator)
    with pytest.raises(errors.LinearOperatorError):
        O.get_linearoperator((4, 4), A, device="cpu")
    timer = timers.Timer()
    op = O.get_linearoperator((5, 5), A, timer=timer, device="cpu")
    op * _t(x)
    assert len(timer) == 1 and timer[0] >= 0


def test_timed_operator_and_timings():
    timer = timers.Timer()
    Aop = O.TimedLinearOperator(O.MatrixLinearOperator(np.eye(5),
                                                       device="cpu"), timer)
    Aop * torch.ones((5, 2), dtype=torch.float64)
    assert len(timer) == 1 and timer[0] >= 0
    t = timers.Timings()
    t["a"].extend([3.0, 1.0])
    assert t.get("a") == 1.0 and t.get("b") == 0
    assert t.get_ops({"a": 2, "b": 5}) == 2.0


def test_dtypes_match_jax():
    from krypy_tpu.core import dtypes as jd

    cases = [(np.float32, np.float64), (np.float64, np.complex64),
             (np.float32,), (None, np.complex128)]
    for types in cases:
        args = [None if t is None else np.ones(1, t) for t in types]
        want = jd.find_common_dtype(*args)
        got = dtypes.find_common_dtype(*args)
        assert str(got).split(".")[-1] == str(want)
    assert dtypes.find_common_dtype() == torch.float64
    assert dtypes.find_common_dtype(torch.ones(2, dtype=torch.float32),
                                    np.float64) == torch.float64
    flat, (a, b) = dtypes.shape_vecs(torch.ones(4), np.ones(4),
                                     device="cpu")
    assert flat and tuple(a.shape) == (4, 1) and tuple(b.shape) == (4, 1)
    flat, _ = dtypes.shape_vecs(torch.ones(4), torch.ones((4, 2)))
    assert not flat


def test_shape_vecs_places_numpy_on_device():
    """``shape_vecs`` puts numpy arguments on ``device`` (default
    ``"cuda"``, as ``asarray``; on the CPU here ``device="cpu"``) and
    leaves tensors where they are; None and non-arrays pass through, as
    in the JAX package's ``shape_vecs``."""
    from krypy_tpu.core import dtypes as jd

    t = torch.ones(3, dtype=torch.float64)
    flat, (a, b, c, d) = dtypes.shape_vecs(np.arange(3.0), t, None, 2.0,
                                           device="cpu")
    jflat, (ja, _, jc, jd_) = jd.shape_vecs(np.arange(3.0), np.ones(3), None,
                                            2.0)
    assert flat == jflat
    assert a.device.type == "cpu" and a.dtype == torch.float64
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    assert b.data_ptr() == t.data_ptr() and tuple(b.shape) == (3, 1)
    assert c is None and jc is None and d == jd_ == 2.0
    import inspect

    assert inspect.signature(dtypes.shape_vecs).parameters[
        "device"].default == "cuda"


def test_errors_mirror_jax():
    from krypy_tpu import errors as je

    for name in je.__all__:
        assert hasattr(errors, name)
        assert issubclass(getattr(errors, name), Exception)
    e = errors.ConvergenceError("msg", solver="s")
    assert e.solver == "s"
