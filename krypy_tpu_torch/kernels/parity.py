"""How the card holds a kernel against its plain version: the tolerances
that ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` use, and the
faults that the prefix-sweep check must reject.  Nothing here launches a
kernel; it only compares tensors.

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
"""

import torch

__all__ = ["fma_atol", "PrefixCheck"]


def fma_atol(want, want64):
    """Absolute tolerance of a stencil kernel against its plain float32
    version ``want``: the larger of ``2e-7 * max|want|`` and four times
    the plain version's own float32 rounding error (its distance from
    the same plain version in float64, ``want64``)."""
    own = float((want.double() - want64).abs().max())
    return max(2e-7 * float(want.abs().max()), 4.0 * own)


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
            V32 = self.V64.float()
            mask32 = self.mask64.float()
            pad = self.m - rows

            def f32_sum(x):
                c = (V32 @ x.float()) * mask32
                return torch.nn.functional.pad(c.double(), (0, pad))

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
