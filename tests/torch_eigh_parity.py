"""How far the port's ``eigh3x3`` is from the JAX package's on the CPU, and a
candidate solver that reproduces XLA's CPU evaluation bit for bit in the
odometry's KNN normals. The candidate is not wired into the port: with it
the odometry's normals equal JAX's on every row, but the pipeline parity
test's data seed 3 parts at step 7 (ROADMAP queue 3).

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_eigh_parity.py            # step table
    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_eigh_parity.py --seed 3   # pipeline gaps

What XLA's CPU backend does, found from its dumps (``--xla_dump_to``) and
by experiment: it contracts a multiply feeding an add into one fused
multiply-add, and which one of two candidate multiplies it fuses depends on
the fused loop (the eigenvalue outputs, the eigenvector loops and the X-ICP
blocks inside the jitted ICP loop differ); it calls the C library's ``cosf``
and ``atan2f`` (``arccos(r)`` is ``atan2f(sqrt((1 - r) * (r + 1)), r)``); it
multiplies by the float32 reciprocals of 3 and 6 and folds ``3 * (t / 3)``
to ``t``; in the normals it folds ``(dot / count) / scale`` into
``dot / (count * scale)``. With glibc as the C library, ``cosf`` is ARM's
optimized-routines algorithm (its ``__sincosf_table`` constants below),
``atan2f`` and ``atanf`` are fdlibm's float32 ones. PyTorch's CPU square
root (float32 and float64) is not correctly rounded on an AVX-512 build;
through float64 it is.
"""

from __future__ import annotations

import argparse
import math
import os
import struct
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
from tests.torch_jax_paths import use_jax_fused_path  # noqa: E402

use_jax_fused_path()

import tests.conftest  # noqa: E402,F401  (JAX on the CPU)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from open3d_slam_private_tpu.ops import knn as jknn  # noqa: E402
from open3d_slam_private_tpu.ops import normals as jnm  # noqa: E402
from open3d_slam_private_tpu.ops import pointcloud as jpc  # noqa: E402
from open3d_slam_private_tpu.slam import odometry as jodo  # noqa: E402
from open3d_slam_private_tpu_torch.ops import normals as tnm  # noqa: E402
from open3d_slam_private_tpu_torch.ops.knn import sq_norms  # noqa: E402


def fma(a, b, c):
    return torch.addcmul(c.double(), a.double(), b.double()).float()


def sqrt(x):
    return torch.sqrt(x.double()).float()


def _f32(bits):
    return struct.unpack("<f", struct.pack("<I", bits))[0]


_HPI_INV, _HPI = float.fromhex("0x1.45f306dc9c883p+23"), float.fromhex("0x1.921fb54442d18p+0")
_C = [float.fromhex(h) for h in ("0x1p0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5",
                                 "-0x1.6c087e89a359dp-10", "0x1.99343027bf8c3p-16")]
_S = [float.fromhex(h) for h in ("-0x1.555545995a603p-3", "0x1.1107605230bc4p-7", "-0x1.994eb3774cf24p-13")]
_ATANHI = [_f32(b) for b in (0x3EED6338, 0x3F490FDA, 0x3F7B985E, 0x3FC90FDA)]
_ATANLO = [_f32(b) for b in (0x31AC3769, 0x33222168, 0x33140FB4, 0x33A22168)]
_AT = [_f32(b) for b in (0x3EAAAAAB, 0xBE4CCCCD, 0x3E124925, 0xBDE38E38, 0x3DBA2E6E, 0xBD9D8795,
                         0x3D886B35, 0xBD6EF16B, 0x3D4BDA59, 0xBD15A221, 0x3C8569D7)]
_PI, _PI_LO, _PI_O_2 = _f32(0x40490FDB), _f32(0xB3BBBD2E), _f32(0x3FC90FDB)


def cosf(y):
    """glibc's cosf for float32 |y| < 120."""
    x = y.double()
    top = (y.view(torch.int32) >> 20) & 0x7FF
    n = torch.where(top < 0x3F4, 0, ((x * _HPI_INV).to(torch.int32) + 0x800000) >> 24)
    x = torch.where(top < 0x3F4, x, x - n.double() * _HPI)
    sign = torch.where(((n + 1) & 2) == 0, 1.0, -1.0).double()
    neg_c = torch.where((n & 2) == 0, 1.0, -1.0).double()
    xs, x2 = x * sign, x * x
    x4 = x2 * x2
    c = (_C[0] + x2 * _C[1]) + x4 * _C[2] + (x4 * x2) * (_C[3] + x2 * _C[4])
    x3 = xs * x2
    s = (xs + x3 * _S[0]) + (x3 * x2) * (_S[1] + x2 * _S[2])
    return torch.where(top < 0x398, 1.0, torch.where((n & 1) == 0, c * neg_c, s).float())


def _atanf_pos(x):
    """glibc's atanf for float32 x >= 0."""
    ix = x.view(torch.int32)
    one = torch.ones_like(x)
    idn = torch.where(ix < 0x3EE00000, -1, torch.where(ix < 0x3F300000, 0, torch.where(
        ix < 0x3F980000, 1, torch.where(ix < 0x401C0000, 2, 3))))
    t = torch.where(idn == -1, x, torch.where(idn == 0, (2.0 * x - one) / (2.0 + x), torch.where(
        idn == 1, (x - one) / (x + one), torch.where(idn == 2, (x - 1.5) / (one + 1.5 * x), -1.0 / x))))
    z = t * t
    w = z * z
    s1 = z * (_AT[0] + w * (_AT[2] + w * (_AT[4] + w * (_AT[6] + w * (_AT[8] + w * _AT[10])))))
    s2 = w * (_AT[1] + w * (_AT[3] + w * (_AT[5] + w * (_AT[7] + w * _AT[9]))))
    k = idn.clamp(min=0).long()
    hi, lo = torch.tensor(_ATANHI)[k], torch.tensor(_ATANLO)[k]
    out = torch.where(idn == -1, t - t * (s1 + s2), hi - ((t * (s1 + s2) - lo) - t))
    out = torch.where(ix < 0x31000000, x, out)
    return torch.where(ix >= 0x4C000000, _ATANHI[3] + _ATANLO[3], out)


def acosf(r):
    """XLA's arccos: glibc's atan2f(sqrt((1 - r) * (r + 1)), r)."""
    y = sqrt((1.0 - r) * (r + 1.0))
    iy, hx = y.view(torch.int32) & 0x7FFFFFFF, r.view(torch.int32)
    ix = hx & 0x7FFFFFFF
    k = (iy - ix) >> 23
    z = _atanf_pos(torch.abs(y / r))
    z = torch.where(k > 60, _PI_O_2 + 0.5 * _PI_LO, torch.where((hx < 0) & (k < -60), 0.0, z))
    out = torch.where(ix == 0, _PI_O_2, torch.where(hx < 0, _PI - (z - _PI_LO), z))
    return torch.where(iy == 0, torch.where(hx < 0, _PI, y), out)


def _cross(a, b):
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([fma(a1, b2, -(a2 * b1)), fma(a2, b0, -(a0 * b2)), fma(a0, b1, -(a1 * b0))], -1)


def _normalize(v):
    return v / torch.clamp(sqrt(sq_norms(v))[..., None], min=1e-30)


def steps(A, count=None):
    """The candidate solver's intermediates and result for ``A [N, 3, 3]``
    (``count``: A holds covariance sums, the matrix is A / count)."""
    cnt = torch.ones_like(A[..., :1, :1]) if count is None else count[..., None, None]
    scale = torch.clamp((A / cnt).abs().amax(dim=(-2, -1), keepdim=True), min=1e-30)
    B = A / (cnt * scale)
    eye = torch.eye(3)
    trace = (B[..., 0, 0] + B[..., 1, 1]) + B[..., 2, 2]
    q = trace * (1.0 / 3.0)
    Bq = B - q[..., None, None] * eye
    sq = Bq.flatten(-2)
    p2 = sq[..., 0] * sq[..., 0]
    for k in range(1, 9):
        p2 = fma(sq[..., k], sq[..., k], p2)
    p2 = p2 * (1.0 / 6.0)
    p = sqrt(torch.clamp(p2, min=1e-30))
    a = Bq / p[..., None, None]
    det = fma(a[..., 0, 0] * a[..., 1, 1], a[..., 2, 2], (a[..., 0, 1] * a[..., 1, 2]) * a[..., 2, 0])
    det = fma(a[..., 0, 2] * a[..., 1, 0], a[..., 2, 1], det)
    det = fma(-(a[..., 0, 2] * a[..., 1, 1]), a[..., 2, 0], det)
    det = fma(-(a[..., 0, 0] * a[..., 1, 2]), a[..., 2, 1], det)
    det = fma(-(a[..., 0, 1] * a[..., 1, 0]), a[..., 2, 2], det)
    r = torch.clamp(det * 0.5, -1.0, 1.0)
    acos = acosf(r)
    third, two_p = torch.full_like(acos, 1.0 / 3.0), 2.0 * p
    cos1 = cosf(acos * (1.0 / 3.0))
    e1 = fma(trace, third, two_p * cos1)
    e3 = fma(trace, third, two_p * cosf(fma(acos, third, torch.full_like(acos, 2.0 * math.pi / 3.0))))
    e2 = (trace - fma(two_p, cos1, q)) - fma(two_p, cosf(acos * (1.0 / 3.0) + 2.0 * math.pi / 3.0), q)

    def eigvec(lmbda, fallback):
        M = B - lmbda[..., None, None] * eye
        c01, c02, c12 = _cross(M[..., 0, :], M[..., 1, :]), _cross(M[..., 0, :], M[..., 2, :]), \
            _cross(M[..., 1, :], M[..., 2, :])
        n01, n02, n12 = (sq_norms(c)[..., None] for c in (c01, c02, c12))
        best = torch.where((n01 >= n02) & (n01 >= n12), c01, torch.where(n02 >= n12, c02, c12))
        return _normalize(torch.where(sqrt(sq_norms(best))[..., None] < 1e-12, fallback, best))

    v_large = eigvec(e1, eye[2].expand(B[..., 0, :].shape))
    alt = torch.where(v_large[..., :1].abs() > 0.9, eye[1].expand(v_large.shape), eye[0].expand(v_large.shape))
    v_small = eigvec(e3, _cross(v_large, alt))
    v_mid = _normalize(_cross(v_large, v_small))
    vecs = torch.stack([_cross(v_mid, v_large), v_mid, v_large], dim=-1)
    return dict(B=B, q=q, p2=p2, p=p, r=r, acos=acos, cos=cos1,
                evals=torch.stack([e3, e2, e1], -1) * scale[..., 0], vecs=vecs)


def port_steps(A, count):
    """The port's eigh3x3 and its intermediates on the same input."""
    A = A / count[..., None, None]
    scale = torch.clamp(A.abs().amax(dim=(-2, -1), keepdim=True), min=1e-30)
    B = A / scale
    q = (B[..., 0, 0] + B[..., 1, 1] + B[..., 2, 2]) / 3.0
    Bq = B - q[..., None, None] * torch.eye(3)
    sq = (Bq * Bq).flatten(-2)
    p2 = sq[..., 0]
    for k in range(1, 9):
        p2 = p2 + sq[..., k]
    p2 = p2 / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-30))
    r = torch.clamp(tnm._det3(Bq / p[..., None, None]) / 2.0, -1.0, 1.0)
    acos = torch.arccos(r)
    evals, vecs = tnm.eigh3x3(A)
    return dict(B=B, q=q, p2=p2, p=p, r=r, acos=acos, cos=torch.cos(acos / 3.0), evals=evals, vecs=vecs)


@jax.jit
def jax_steps(nb, valid):
    """JAX's intermediates in the normals' context (covariance fused)."""
    w = valid.astype(nb.dtype)[..., None]
    cnt = jnp.maximum(jnp.sum(w, axis=-2), 1.0)
    centered = (nb - (jnp.sum(nb * w, axis=-2) / cnt)[:, None, :]) * w
    A = jnp.einsum("nki,nkj->nij", centered, centered) / cnt[..., None]
    scale = jnp.maximum(jnp.max(jnp.abs(A), axis=(-2, -1), keepdims=True), 1e-30)
    B = A / scale
    q = jnp.trace(B, axis1=-2, axis2=-1) / 3.0
    Bq = B - q[..., None, None] * jnp.eye(3, dtype=A.dtype)
    p2 = jnp.sum(Bq * Bq, axis=(-2, -1)) / 6.0
    p = jnp.sqrt(jnp.maximum(p2, 1e-30))
    r = jnp.clip(jnp.linalg.det(Bq / p[..., None, None]) / 2.0, -1.0, 1.0)
    acos = jnp.arccos(r)
    evals, vecs = jnm.eigh3x3(A)
    return dict(B=B, q=q, p2=p2, p=p, r=r, acos=acos, cos=jnp.cos(acos / 3.0), evals=evals, vecs=vecs)


def covariance_sums(nb, valid):
    """The port's covariance sums and counts (``ops/normals.py``)."""
    w = valid.float()[..., None]
    cnt = torch.clamp(w.sum(-2), min=1.0)
    nbw = nb * w
    mean = nbw[:, 0]
    for k in range(1, nb.shape[1]):
        mean = mean + nbw[:, k]
    c = ((nb - (mean / cnt)[:, None, :]) * w).double()
    dot = torch.zeros((nb.shape[0], 3, 3), dtype=torch.float64)
    for k in range(nb.shape[1]):
        dot = (c[:, k, :, None] * c[:, k, None, :] + dot).float().double()
    return dot.float(), cnt[..., 0]


def step_table(seed=2):
    """Share of valid rows bit-equal to JAX's, per step, over the first three
    odometry scans of the pipeline test's data seed."""
    from test_torch_odometry import scene
    from test_torch_pipeline import _config, distorted_scan

    S = scene(np.random.default_rng(seed))
    ocfg = _config().odometry
    rows = {}
    for k in range(3):
        vox = jodo.preprocess(jpc.from_points(distorted_scan(S, k, seed=k)[0], capacity=4096), None, ocfg)
        xyz = vox.padded_xyz()
        res = jknn.knn_bruteforce(xyz, vox.mask, xyz, vox.mask, k=8, max_dist=ocfg.normals_radius)
        nb, valid = jknn.gather_matched(vox.xyz, jnp.maximum(res.ids, 0)), res.valid()
        want = {s: np.asarray(v) for s, v in jax_steps(nb, valid).items()}
        dot, cnt = covariance_sums(torch.tensor(np.asarray(nb)), torch.tensor(np.asarray(valid)))
        m = np.asarray(vox.mask)
        for name, got in (("port", port_steps(dot, cnt)), ("candidate", steps(dot, cnt))):
            for s, v in got.items():
                eq = (v.numpy().view(np.int32) == want[s].view(np.int32)).reshape(len(m), -1).all(1)[m]
                rows.setdefault(s, {}).setdefault(name, []).append(float(eq.mean()))
    print("| step | the port's eigh3x3 | the candidate |\n|---|---|---|")
    for s, v in rows.items():
        print(f"| {s} | {100 * np.mean(v['port']):.1f}% | {100 * np.mean(v['candidate']):.1f}% |")


def normals_with_candidate(batch, nb, valid, orient_towards, return_eigen):
    """``ops/normals.py`` ``_normals_from_neighbors`` with the candidate
    solver and XLA's folded division (normals only)."""
    dot, cnt = covariance_sums(nb, valid)
    normal = steps(dot, cnt)["vecs"][..., :, 0]
    if orient_towards is not None:
        vp = torch.as_tensor(orient_towards, dtype=batch.xyz.dtype)
        normal = torch.where((normal * (vp - batch.xyz)).sum(-1, keepdim=True) < 0, -normal, normal)
    ok = batch.mask & (valid.sum(-1) >= 3)
    return batch.with_extras(normals=torch.where(ok[:, None], normal, 0.0))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, help="run tests/torch_parity_seed.py's 9 steps with the candidate")
    args = ap.parse_args()
    if args.seed is None:
        step_table()
        return
    import torch_parity_seed

    tnm._normals_from_neighbors = normals_with_candidate
    tnm.eigh3x3 = lambda A: (lambda s: (s["evals"], s["vecs"]))(steps(A))
    torch_parity_seed.main(args.seed, 9)


if __name__ == "__main__":
    main()
