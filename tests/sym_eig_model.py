"""A numpy model of ``csrc/sym_eig.cu``'s loop, lane by lane: one warp's 32
lanes as the rows of an array ``a[32, n]`` (lane j < 16 holds column j of
A, lane 16 + j column j of V), shuffles as gathers along the lanes, the
kernel's compile-time round-robin schedule, its skip rule, its
one-reciprocal-one-square-root form of Rutishauser's rotation and its
parallel stop test. The arithmetic is numpy's in the matrix's type
(correctly rounded division and square root where the kernel refines the
SFU's approximations, and no fused multiply-adds), so the model follows the
kernel's order of operations, not its last bits.

    python tests/sym_eig_model.py   # sweeps and errors on random SPD matrices
"""

from __future__ import annotations

import numpy as np

MAX_SWEEPS = 30  # kMaxSweeps


def round_robin(n: int):
    """The kernel's schedule (``pair_p`` / ``pair_q``): m = n + n % 2
    indices, m - 1 steps of m / 2 disjoint pairs (p < q); a pair with
    q == n (odd n) is the dummy's."""
    m = n + n % 2
    mm = m - 1
    return [[(r, mm)] + [tuple(sorted(((r + k) % mm, (r - k) % mm))) for k in range(1, m // 2)]
            for r in range(mm)]


def partner(j: int, r: int, n: int) -> int:
    """Column j's partner in step r, the kernel's run-time formula (no
    division: p + q = 2 r mod (m - 1))."""
    m = n + n % 2
    mm = m - 1
    if j >= m:
        return j
    if j == mm:
        return r
    if j == r:
        return mm
    x = 2 * r - j
    x = x + mm if x < 0 else x
    return x - mm if x >= mm else x


def rotation(app, aqq, apq):
    """(c, s, t) with t = 2 a_pq sgn(d) / (|d| + sqrt(d^2 + 4 a_pq^2)), d =
    a_qq - a_pp (Rutishauser's t, multiplied through by 2 |a_pq|),
    c = 1 / sqrt(t^2 + 1), s = t c."""
    one = app.dtype.type(1)
    with np.errstate(all="ignore"):
        d = aqq - app
        r = np.sqrt(d * d + 4 * apq * apq)
        two_apq = 2 * apq
        t = np.where(d < 0, -two_apq, two_apq) * (one / (np.abs(d) + r))
        c = one / np.sqrt(t * t + one)
    return c, t * c, t


def jacobi(A, stop: str = "test", max_sweeps: int = MAX_SWEEPS):
    """The kernel's loop on one symmetric ``A [n, n]`` (float32 or float64)
    -> (w ascending, V with the eigenvectors as columns, sweeps, the final
    scaled A's registers with column j from lane j; a rotated pair's block
    is 0 there, its diagonal kept apart). ``stop="test"`` is the kernel's
    stop (a test of every pair before each sweep); ``stop="sweep"`` the
    former one (sweeps until one rotates nothing, that sweep not counted)."""
    A = np.asarray(A)
    dt = A.dtype.type
    n = A.shape[0]
    lanes = np.arange(32)
    j = lanes & 15
    is_a = lanes < 16
    a = np.zeros((32, n), A.dtype)
    a[:n] = A.T  # lane j: column j
    a[16:16 + n] = np.eye(n, dtype=A.dtype)
    big = np.abs(A).max()
    e = int(np.frexp(big)[1]) - 1 if big > 0 and np.isfinite(big) else 0
    a[:16] = np.ldexp(a[:16], -e).astype(A.dtype)
    eps = np.finfo(A.dtype).eps
    eps2 = dt(eps * eps)
    noise = eps2 * np.sqrt(np.sum(a[:16] * a[:16], dtype=A.dtype))

    def rotates(apq, app, aqq):
        with np.errstate(all="ignore"):
            return (apq * apq > eps2 * np.abs(app * aqq)) & (np.abs(apq) > noise)

    def pick(idx):
        return a[lanes, np.minimum(idx, n - 1)]

    # The diagonal, kept apart (lane j: a_jj) and updated by Rutishauser's
    # a_pp - t a_pq, a_qq + t a_pq.
    dg = pick(j)

    def diagonal_enough():
        return not any(rotates(a[q, :q], dg[:q], dg[q]).any() for q in range(n))

    def sweep():
        nonlocal a, dg
        rotated = False
        for r, pairs in enumerate(round_robin(n)):
            pj = np.array([partner(int(x), r, n) for x in j])
            lo = j < pj
            o_own = pick(pj)
            x_self, x_part = dg[j], dg[pj]
            apq = o_own[np.where(lo, pj, j)]  # lane q's register p
            app, aqq = np.where(lo, x_self, x_part), np.where(lo, x_part, x_self)
            rot = (j < n) & (pj < n) & (pj != j) & rotates(apq, app, aqq)
            other = a[(lanes & 16) | pj]
            c, s, t = rotation(app, aqq, apq)
            sg = np.where(lo, -s, s)
            a = np.where(rot[:, None], sg[:, None] * other + c[:, None] * a, a)
            with np.errstate(all="ignore"):
                dg = np.where(rot, np.where(lo, app - t * apq, aqq + t * apq), dg)
            for p, q in pairs:
                if q >= n or not (rot[p] and lo[p]):
                    continue
                x, y = a[:16, p].copy(), a[:16, q].copy()
                a[:16, p] = -s[p] * y + c[p] * x
                a[:16, q] = s[p] * x + c[p] * y
                a[[p, q], p] = 0  # the pair's block: its diagonal is in dg
                a[[p, q], q] = 0
            rotated |= bool(rot.any())
        return rotated

    sweeps = 0
    if stop == "test":
        while sweeps < max_sweeps and not diagonal_enough():
            sweep()
            sweeps += 1
    else:
        while sweeps < max_sweeps and sweep():
            sweeps += 1
    d = dg[:n]
    order = np.argsort(d, kind="stable")  # ties by index, as the ranks
    w = np.ldexp(d[order], e).astype(A.dtype)
    V = a[16:16 + n].T[:, order]
    return w, V, sweeps, a[:n].T.copy()


def kkt(rng, locked: int):
    """A 12 x 12 KKT matrix [[A, C^T], [C, 0]] of an SPD 6 x 6 A with
    ``locked`` constraint rows (unit eigen-directions of the subspaces) and
    the other rows zero, and its right-hand side."""
    X = rng.normal(size=(6, 6))
    A = X @ X.T * 100.0 + np.diag([1e3, 1e3, 1e3, 1e2, 1e2, 1e-1])
    C = np.zeros((6, 6))
    for i in range(locked):
        v = rng.normal(size=3)
        C[i, (i // 3) * 3:(i // 3) * 3 + 3] = v / np.linalg.norm(v)
    M = np.zeros((12, 12))
    M[:6, :6], M[:6, 6:], M[6:, :6] = A, C.T, C
    return M, rng.normal(size=12)


def families(rng, n: int):
    """The chain's matrix families at size n, float64, each ``[k, n, n]``:
    SPD normal equations (one with a weak direction), diagonal (with a
    repeated entry), zero, repeated eigenvalues (a rotated diagonal with
    every value twice), the SPD ones at scales 1e-20 and 1e20 and, at
    n = 12, KKT matrices with 0, 1, 3 and 5 locked rows."""
    X = rng.normal(size=(3, n, n))
    spd = X @ X.transpose(0, 2, 1) * 50.0
    spd[0, -1, :] *= 1e-2
    spd[0, :, -1] *= 1e-2
    diag = rng.normal(size=n) * 10.0
    diag[-1] = diag[0]
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    vals = np.repeat(rng.uniform(1.0, 5.0, size=(n + 1) // 2), 2)[:n]
    out = dict(spd=spd, diagonal=np.diag(diag)[None], zero=np.zeros((1, n, n)),
               repeated=(Q * vals) @ Q.T, scale_1e_20=spd * 1e-20, scale_1e20=spd * 1e20)
    out["repeated"] = ((out["repeated"] + out["repeated"].T) / 2)[None]
    if n == 12:
        for locked in (0, 1, 3, 5):
            out[f"kkt{locked}"] = np.stack([kkt(rng, locked)[0] for _ in range(2)])
    return out


def pseudo_solve(w, V, b, rcond=1e-7):
    """``minimizers.solve_normal_equations`` on an eigen-decomposition."""
    aw = np.abs(w)
    with np.errstate(all="ignore"):
        inv = np.where(aw > rcond * aw.max(), 1.0 / w, 0.0)
    return V @ (inv * (V.T @ b))


if __name__ == "__main__":
    rng = np.random.default_rng(0)
    for n in (3, 6, 12, 16):
        X = rng.normal(size=(n, n))
        A = X @ X.T
        w, V, sweeps, _ = jacobi(A)
        err = np.abs(w - np.linalg.eigvalsh(A)).max() / np.abs(A).max()
        print(f"n={n}: {sweeps} sweeps, eigenvalue error {err:.2e} of the scale")
