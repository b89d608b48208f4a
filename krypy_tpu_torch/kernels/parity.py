"""How the card holds a kernel against its plain version: the tolerances
that ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` use, and the
faults that the prefix-sweep and projection checks must reject.  Nothing
here launches a kernel; it only compares tensors.

Stencil kernels K1-K3 (:func:`fma_atol`): nvcc contracts multiply-adds to
FMA, which skips roundings the plain version makes, so the two differ by
a few ulps of the stencil's intermediate terms; where those terms cancel,
that is more than a few ulps of the output.

Prefix sweeps K4-K6 (:class:`PrefixCheck`): every output is held to its
float64 value.
  * ``w - c[:rows] V[:rows]`` (K5's ``w1``, K6's output), elementwise: a
    sum of ``rows + 1`` terms, so the first-order bound ``2 (rows + 1)
    eps (|w| + |c| |V|)``.
  * A coefficient ``V_r . x`` (K4's ``c``, with x = w; K5's ``c2``, with
    x = the kernel's own ``w1``), a sum of N terms: ``2 eps (|V_r| . |x|)
    + 4 own``, where ``own`` is the plain version's largest distance
    from the same float64 value.  The worst-case ``N eps`` bound would be
    useless here (above 1 at N = 4096^2 in float32); a blocked or tree
    sum's rounding errors add like a random walk, about ``sqrt(N)`` times
    below one rounding of ``|V_r| . |x|``, so ``2 eps (|V_r| . |x|)``
    covers a correct sum in any order while a zeroed, dropped or
    float32-summed coefficient misses it by orders of magnitude
    (:meth:`PrefixCheck.faults` plants each).  The mask scales the
    tolerance, so a masked-out coefficient must be exactly 0.

The projection pass K7 (:class:`ProjectCheck`): its coefficients as K4's,
and ``w - c B[:rows]`` elementwise as above, with ``c`` the coefficients
that came with it (the kernel applies its own), so that a wrong basis, a
dropped row or a foreign coefficient vector shows in ``w'`` while the
coefficients' own summation error does not.
"""

import torch

__all__ = ["fma_atol", "PrefixCheck", "ProjectCheck"]


def fma_atol(want, want64):
    """Absolute tolerance of a stencil kernel against its plain float32
    version ``want``: the larger of ``2e-7 * max|want|`` and four times
    the plain version's own float32 rounding error (its distance from
    the same plain version in float64, ``want64``)."""
    own = float((want.double() - want64).abs().max())
    return max(2e-7 * float(want.abs().max()), 4.0 * own)


def _padded32_sum(V64, x, mask64, m):
    """``(V x) * mask`` summed in float32, back in float64 and padded to
    m: the planted fault for float64 inputs."""
    c = (V64.float() @ x.float()) * mask64.float()
    return torch.nn.functional.pad(c.double(), (0, m - c.shape[0]))


class PrefixCheck:
    """K4-K6 on one set of inputs ``(V, w, c, mask, rows)``, held to
    their float64 values (module docstring).  ``plain`` maps each kernel
    name to its plain version's outputs on the same inputs, as a tuple
    in the order the wrapper returns them (``project_prefix: (c,)``,
    ``apply_project: (w1, c2)``, ``update_prefix: (w2,)``); so does
    ``got`` in :meth:`failures`."""

    def __init__(self, V, w, c, mask, rows, plain):
        self.rows, self.m = rows, V.shape[0]
        self.eps = torch.finfo(V.dtype).eps
        self.V64 = V[:rows].double()
        self.Vabs = self.V64.abs()
        self.mask64 = mask[:rows].double()
        self.w, self.c_in, self.V = w, c, V
        w64, c64 = w.double(), c[:rows].double()
        # K4's c
        self.c1 = (self.V64 @ w64) * self.mask64
        own = (plain["project_prefix"][0][:rows].double() - self.c1).abs()
        self.t_c1 = self._coeff_tol(w64, float(own.max()))
        # w - c V: K5's w1 and K6's output
        self.w_exact = w64 - c64 @ self.V64
        self.t_w = 2 * (rows + 1) * self.eps * (w64.abs()
                                                + c64.abs() @ self.Vabs)
        # K5's c2, from whichever w1 came with it
        pw1, pc2 = plain["apply_project"]
        own = (pc2[:rows].double() - self._c2_exact(pw1)).abs()
        self.own_c2 = float(own.max())

    def _coeff_tol(self, x64, own):
        return (2 * self.eps * (self.Vabs @ x64.abs()) + 4 * own) * \
            self.mask64.abs()

    def _c2_exact(self, w1):
        return (self.V64 @ w1.double()) * self.mask64

    def failures(self, got):
        """Names (``"kernel output"``) of the outputs in ``got`` that miss
        their float64 value, or whose rows past ``rows`` are not 0."""
        bad = []

        def check(label, out, exact, tol):
            n = exact.shape[0]
            if not bool(torch.all(out[n:] == 0)) or not bool(torch.all(
                    (out[:n].double() - exact).abs() <= tol)):
                bad.append(label)

        (c1,) = got["project_prefix"]
        check("project_prefix c", c1, self.c1, self.t_c1)
        w1, c2 = got["apply_project"]
        check("apply_project w1", w1, self.w_exact, self.t_w)
        check("apply_project c2", c2, self._c2_exact(w1),
              self._coeff_tol(w1.double(), self.own_c2))
        (w2,) = got["update_prefix"]
        check("update_prefix w2", w2, self.w_exact, self.t_w)
        return bad

    def faults(self, got):
        """``(label, output, faulty got)`` for each planted fault of the
        kernels' outputs ``got``: each coefficient vector zeroed, the row
        of its largest coefficient dropped, each of ``w1`` and ``w2``
        missing the update of the row with the largest ``|c|``, and, for
        float64 inputs, both coefficient vectors summed in float32.
        :meth:`failures` must name ``output`` for each."""
        rows = self.rows
        (c1,) = got["project_prefix"]
        w1, c2 = got["apply_project"]
        (w2,) = got["update_prefix"]

        def dropped(coeffs):
            out = coeffs.clone()
            out[int(coeffs[:rows].abs().argmax())] = 0
            return out

        j = int(self.c_in[:rows].abs().argmax())
        missing = self.c_in[j] * self.V[j]
        faults = [
            ("c zeroed", "project_prefix c", dict(
                got, project_prefix=(torch.zeros_like(c1),))),
            ("c row dropped", "project_prefix c", dict(
                got, project_prefix=(dropped(c1),))),
            ("c2 zeroed", "apply_project c2", dict(
                got, apply_project=(w1, torch.zeros_like(c2)))),
            ("c2 row dropped", "apply_project c2", dict(
                got, apply_project=(w1, dropped(c2)))),
            ("w1 row dropped", "apply_project w1", dict(
                got, apply_project=(w1 + missing, c2))),
            ("w2 row dropped", "update_prefix w2", dict(
                got, update_prefix=(w2 + missing,))),
        ]
        if self.V.dtype == torch.float64:
            def f32_sum(x):
                return _padded32_sum(self.V64, x, self.mask64, self.m)

            faults += [
                ("c summed in float32", "project_prefix c", dict(
                    got, project_prefix=(f32_sum(self.w),))),
                ("c2 summed in float32", "apply_project c2", dict(
                    got, apply_project=(w1, f32_sum(w1)))),
            ]
        return faults

    def assert_faults_caught(self, got):
        """Raise ``AssertionError`` if a planted fault passes; return how
        many were planted."""
        faults = self.faults(got)
        for label, output, bad in faults:
            if output not in self.failures(bad):
                raise AssertionError(f"planted fault passed the check: "
                                     f"{label}")
        return len(faults)


class ProjectCheck:
    """K7 on one set of inputs ``(V, w, mask, rows, basis)``, held to its
    float64 values (module docstring).  ``plain`` and ``got`` are the
    pair ``(w_out, c)`` as the wrapper returns it; ``basis=None`` means
    ``V``."""

    def __init__(self, V, w, mask, rows, plain, basis=None):
        self.rows, self.m = rows, V.shape[0]
        self.eps = torch.finfo(V.dtype).eps
        self.V, self.w, self.distinct = V, w, basis is not None
        self.V64 = V[:rows].double()
        self.B64 = self.V64 if basis is None else basis[:rows].double()
        self.Babs = self.B64.abs()
        self.mask64 = mask[:rows].double()
        self.w64 = w.double()
        self.c_exact = (self.V64 @ self.w64) * self.mask64
        own = float((plain[1][:rows].double() - self.c_exact).abs().max())
        self.t_c = (2 * self.eps * (self.V64.abs() @ self.w64.abs())
                    + 4 * own) * self.mask64.abs()

    def failures(self, got):
        """Which of ``"w_out"`` and ``"c"`` miss their float64 values
        (``c`` also when a row past ``rows`` is not 0)."""
        w_out, c = got
        rows = self.rows
        bad = []
        if not bool(torch.all(c[rows:] == 0)) or not bool(torch.all(
                (c[:rows].double() - self.c_exact).abs() <= self.t_c)):
            bad.append("c")
        c64 = c[:rows].double()
        tol = 2 * (rows + 1) * self.eps * (self.w64.abs()
                                           + c64.abs() @ self.Babs)
        if not bool(torch.all(
                (w_out.double() - (self.w64 - c64 @ self.B64)).abs()
                <= tol)):
            bad.append("w_out")
        return bad

    def faults(self, got):
        """``(label, output, faulty got)`` for each planted fault: the
        coefficients zeroed, the largest one dropped, ``w_out`` missing
        that row's update, ``w_out`` taken along ``V`` where the basis
        differs from it, and, for float64 inputs, the coefficients summed
        in float32.  :meth:`failures` must name ``output`` for each."""
        w_out, c = got
        rows = self.rows
        j = int(c[:rows].abs().argmax())
        dropped = c.clone()
        dropped[j] = 0
        B_j = self.B64[j].to(w_out.dtype)
        faults = [
            ("c zeroed", "c", (w_out, torch.zeros_like(c))),
            ("c row dropped", "c", (w_out, dropped)),
            ("w_out row dropped", "w_out", (w_out + c[j] * B_j, c)),
        ]
        if self.distinct:
            faults.append(("V in place of the basis", "w_out",
                           (self.w - c[:rows] @ self.V[:rows], c)))
        if self.V.dtype == torch.float64:
            faults.append(("c summed in float32", "c", (
                w_out, _padded32_sum(self.V64, self.w, self.mask64,
                                     self.m))))
        return faults

    def assert_faults_caught(self, got):
        """Raise ``AssertionError`` if a planted fault passes; return how
        many were planted."""
        faults = self.faults(got)
        for label, output, bad in faults:
            if output not in self.failures(bad):
                raise AssertionError(f"planted fault passed the check: "
                                     f"{label}")
        return len(faults)
