"""The filter's launch schedule, checked in a traced run.

``expected_launches`` and ``expected_gen_launches`` are copies of
``chip_smoke.py``'s: the launches of each Chebyshev kernel that the
schedule of ``_sparse_cheb_filter_host_fused`` (and of the SPD-B
composite, ``ops/cheb_gen.py``) gives for the applications recorded. The
traced run compares them with the port's own launch counters
(``ops/cheb_kernels.launch_counts``) over the window and prints the result
on a line of its own.
"""
from __future__ import annotations

import importlib

SPARSE = "feastkit_tpu_torch.solvers.sparse"


def expected_launches(names, applications, steps):
    """Per application of a series of n coefficients on a rung: one 1-step
    init, then over the r = n - 2 remaining steps floor(r/4) 4-step passes,
    a 2-step pass if r mod 4 >= 2 and a 1-step launch if r is odd
    (``steps[rung]`` = 4); r // 2 2-step passes and the odd step (= 2); r
    1-step launches (= 1)."""
    want = dict.fromkeys(names, 0)
    for rung, n in applications:
        r = n - 2
        n4 = r // 4 if steps[rung] == 4 else 0
        n2 = (r - 4 * n4) // 2 if steps[rung] >= 2 else 0
        want[f"cheb_step4_{rung}"] += n4
        want[f"cheb_step2_{rung}"] += n2
        want[f"cheb_step_{rung}"] += 1 + r - 4 * n4 - 2 * n2
    return want


def expected_gen_launches(names, applications, inner, qlen):
    """An application of n outer coefficients runs n - 1 outer steps, each
    with one column-major one-step launch for A, one for the inner init,
    the r = len(qc) - 2 other inner steps split 4 / 2 / 1 as
    ``inner[rung]`` allows, and one combine; the fp64 carry's inner init
    adds a combine per outer step and its outer init one more."""
    from feastkit_tpu_torch.ops.cheb_gen import inner_split
    want = dict.fromkeys(names, 0)
    for rung, n in applications:
        outer = n - 1
        n4, n2, n1 = inner_split(qlen[rung] - 2, inner[rung])
        want[f"cheb_step_cm_{rung}"] += outer * (2 + n1)
        want[f"cheb_step4_{rung}"] += outer * (n4 // 4)
        want[f"cheb_step2_{rung}"] += outer * (n2 // 2)
        ds = rung == "f64"
        want[f"cheb_combine_{rung}"] += outer * (1 + ds) + ds
    return want


class Schedule:
    """Records (rung, series length) of every fused filter application and
    each rung's steps per pass, and the port's launch counters before and
    after."""

    def __init__(self):
        from feastkit_tpu_torch.ops import cheb_kernels
        self.counters = cheb_kernels.launch_counts
        self.applications = {False: [], True: []}
        self.steps = {False: {}, True: {}}
        self.qlen = {}
        self._saved = []
        self.before = self.after = None

    def install(self) -> None:
        mod = importlib.import_module(SPARSE)
        for gen, name in ((False, "_sparse_cheb_filter_host_fused"),
                          (True, "_sparse_cheb_filter_host_fused_gen")):
            orig = getattr(mod, name)
            setattr(mod, name, self._recorder(orig, gen))
            self._saved.append((mod, name, orig))
        self.before = self.counters()

    def _recorder(self, orig, gen):
        def recorder(ctx, Q, *, rung, n_coeffs=None):
            n = len(ctx[rung]["coeffs"])
            if n_coeffs is not None:
                n = min(n, max(int(n_coeffs), 3))
            self.applications[gen].append((rung, n))
            self.steps[gen][rung] = ctx[rung]["inner_steps" if gen
                                              else "steps"]
            if gen:
                self.qlen[rung] = len(ctx[rung]["qc"])
            return orig(ctx, Q, rung=rung, n_coeffs=n_coeffs)
        return recorder

    def restore(self) -> None:
        self.after = self.counters()
        while self._saved:
            mod, name, orig = self._saved.pop()
            setattr(mod, name, orig)

    def verdict(self) -> tuple:
        """(matches, expected, counted) over the window."""
        names = list(self.before)
        got = {n: self.after[n] - self.before[n] for n in names}
        want = expected_launches(names, self.applications[False],
                                 self.steps[False])
        gen = expected_gen_launches(names, self.applications[True],
                                    self.steps[True], self.qlen)
        want = {n: want[n] + gen[n] for n in names}
        return want == got, want, got
