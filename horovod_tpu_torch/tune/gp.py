"""Pure-Python port of the native GP/EI engine (``cpp/src/autotune.cc``).

The port's copy of ``horovod_tpu/tune/gp.py``, kept whole: it is plain
float math, and ``tests/test_torch_tune.py`` holds it against the C++
engine (``hvd_autotune_gp_probe`` in the port's build of the core) and the
JAX package's copy.

The eager runtime's autotuner is a dependency-free Gaussian-process
regressor with Expected-Improvement acquisition, re-implemented in C++
inside the native core. The compiled-path offline tuner
(``tune/tuner.py``, ``tools/autotune_compiled.py``) needs the SAME
machinery but runs on a laptop with no native core loaded, so this module
is a line-for-line port: RBF kernel with short length scales on the
continuous dims and a longer one on the categorical {0,1} embeddings,
a hand-rolled Cholesky solve (the design space is 5-D and sample counts
are tens), and EI maximized over a deterministic candidate grid.

Everything is plain Python floats — no numpy, no randomness — so two runs
from the same inputs produce BYTE-identical results, and the math agrees
with the C++ engine to float64 rounding (``tests/test_tune.py`` checks a
golden 5-D trace against an ``hvd_autotune_gp_probe`` build of
``autotune.cc`` itself).

Constants (``kLength``/``kCatLength``/``NOISE``/``XI``) deliberately
mirror ``autotune.cc``; changing one side without the other breaks the
golden-trace agreement test.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

# RBF length scales: continuous dims decorrelate quickly; a categorical
# flip is informative but should not decorrelate totally (autotune.cc
# kLength / kCatLength).
LENGTH = 0.25
CAT_LENGTH = 0.75

# Observation noise added to the kernel diagonal (autotune.cc kNoise) and
# the EI exploration margin (kXi).
NOISE = 0.05
XI = 0.01

# How many leading dims are continuous; the rest use CAT_LENGTH
# (autotune.cc hardcodes 2 continuous + 3 categorical).
N_CONTINUOUS = 2


def kernel(a: Sequence[float], b: Sequence[float],
           n_continuous: int = N_CONTINUOUS) -> float:
    d = 0.0
    for i, (ai, bi) in enumerate(zip(a, b)):
        ls = LENGTH if i < n_continuous else CAT_LENGTH
        d += (ai - bi) * (ai - bi) / (ls * ls)
    return math.exp(-d / 2.0)


def cholesky(a: List[float], n: int) -> bool:
    """In-place Cholesky of a row-major SPD matrix; False if not SPD."""
    for i in range(n):
        for j in range(i + 1):
            s = a[i * n + j]
            for k in range(j):
                s -= a[i * n + k] * a[j * n + k]
            if i == j:
                if s <= 0:
                    return False
                a[i * n + i] = math.sqrt(s)
            else:
                a[i * n + j] = s / a[j * n + j]
    return True


def chol_solve(L: Sequence[float], n: int, b: List[float]) -> List[float]:
    """Solve L L^T x = b in place given the Cholesky factor."""
    for i in range(n):
        s = b[i]
        for k in range(i):
            s -= L[i * n + k] * b[k]
        b[i] = s / L[i * n + i]
    for i in range(n - 1, -1, -1):
        s = b[i]
        for k in range(i + 1, n):
            s -= L[k * n + i] * b[k]
        b[i] = s / L[i * n + i]
    return b


def norm_cdf(z: float) -> float:
    return 0.5 * math.erfc(-z / math.sqrt(2.0))


def norm_pdf(z: float) -> float:
    return math.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)


@dataclass
class GP:
    """A fitted GP over normalized observations. ``ys`` are raw scores;
    internally they are max-normalized and mean-centered exactly as the
    C++ Tune() step does, so posterior means are comparable across the
    two implementations."""

    xs: List[Tuple[float, ...]]
    L: List[float]
    alpha: List[float]
    fbest: float
    n_continuous: int = N_CONTINUOUS

    @property
    def n(self) -> int:
        return len(self.xs)


def fit(xs: Sequence[Sequence[float]], ys: Sequence[float],
        n_continuous: int = N_CONTINUOUS) -> Optional[GP]:
    """Fit K = k(X,X) + NOISE*I, alpha = K^-1 y (y mean-centered,
    max-normalized). Returns None when the Cholesky fails (degenerate
    duplicate designs) — the caller falls back to its best-known point,
    like the C++ engine's early return."""
    n = len(xs)
    if n == 0 or len(ys) != n:
        return None
    ymax = 1e-9
    for y in ys:
        ymax = max(ymax, y)
    yn = [y / ymax for y in ys]
    mean = sum(yn) / n
    yn = [y - mean for y in yn]
    pts = [tuple(float(v) for v in x) for x in xs]
    K = [0.0] * (n * n)
    for i in range(n):
        for j in range(n):
            K[i * n + j] = kernel(pts[i], pts[j], n_continuous)
        K[i * n + i] += NOISE
    L = list(K)
    if not cholesky(L, n):
        return None
    alpha = chol_solve(L, n, list(yn))
    return GP(xs=pts, L=L, alpha=alpha, fbest=max(yn),
              n_continuous=n_continuous)


def posterior(gp: GP, c: Sequence[float]) -> Tuple[float, float]:
    """Posterior (mean, variance) at candidate ``c`` (variance includes
    the NOISE prior term, matching autotune.cc)."""
    n = gp.n
    c = tuple(float(v) for v in c)
    k = [kernel(c, gp.xs[i], gp.n_continuous) for i in range(n)]
    mu = 0.0
    for i in range(n):
        mu += k[i] * gp.alpha[i]
    v = chol_solve(gp.L, n, list(k))
    var = kernel(c, c, gp.n_continuous) + NOISE
    for i in range(n):
        var -= k[i] * v[i]
    return mu, max(var, 1e-10)


def expected_improvement(gp: GP, c: Sequence[float]) -> float:
    mu, var = posterior(gp, c)
    sigma = math.sqrt(var)
    z = (mu - gp.fbest - XI) / sigma
    return (mu - gp.fbest - XI) * norm_cdf(z) + sigma * norm_pdf(z)


def ei_argmax(gp: GP, candidates: Sequence[Sequence[float]]) -> int:
    """Index of the EI-maximizing candidate; strict ``>`` comparison in
    iteration order makes ties deterministic (first wins), matching the
    C++ grid scan."""
    best_ei = -1.0
    best = 0
    for idx, c in enumerate(candidates):
        ei = expected_improvement(gp, c)
        if ei > best_ei:
            best_ei = ei
            best = idx
    return best


class Lcg:
    """Tiny deterministic PRNG (numerical-recipes LCG) for seeding the
    initial design — independent of Python's ``random`` so the sample
    sequence is byte-stable across interpreter versions."""

    def __init__(self, seed: int):
        self.state = (int(seed) ^ 0x9E3779B9) & 0xFFFFFFFF

    def next_u32(self) -> int:
        self.state = (1664525 * self.state + 1013904223) & 0xFFFFFFFF
        return self.state

    def next_index(self, n: int) -> int:
        return self.next_u32() % max(int(n), 1)
