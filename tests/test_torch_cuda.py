"""The port's CUDA kernels (K1-K5) and chains on the card (marker ``cuda``;
they skip without a CUDA card): each kernel against its plain version and
its wrapper's input checks, the cached and per-iteration chains and the SLAM
step (``SlamPipeline``) against the CPU, and the voxel segment sums'
determinism. This file imports no JAX, so
it runs where only PyTorch is installed:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

import gather_select_model as gsm
from chip_smoke import near_ties, ulps
from open3d_slam_private_tpu_torch.geometry import se3
from open3d_slam_private_tpu_torch.kernels import gather_select as tgs
from open3d_slam_private_tpu_torch.kernels import pair_gn as tpg
from open3d_slam_private_tpu_torch.models import icp as ticp
from open3d_slam_private_tpu_torch.ops import cell_list as tcl
from open3d_slam_private_tpu_torch.ops import grid_hash as tgh
from open3d_slam_private_tpu_torch.ops import normals as tnm
from open3d_slam_private_tpu_torch.ops import pointcloud as tpc
from open3d_slam_private_tpu_torch.slam.mapper import MapperConfig
from sym_eig_model import families


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (on the H100: python -m pytest -m cuda tests/test_torch_cuda.py)")
    return torch.device("cuda", 0)


def _pairs(rng, B, n, device):
    reading = rng.uniform(-3, 3, size=(B, n, 3)).astype(np.float32)
    q = reading + rng.normal(scale=0.1, size=(B, n, 3)).astype(np.float32)
    nrm = rng.normal(size=(B, n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    valid = rng.uniform(size=(B, n)) > 0.2
    twists = np.array([[0.02, -0.01, 0.05 * (b + 1), 0.1, -0.05, 0.02] for b in range(B)])
    T = se3.exp_se3(torch.tensor(twists, dtype=torch.float32))
    tau = torch.tensor(rng.uniform(0.01, 0.05, B), dtype=torch.float32)
    args = [torch.tensor(x, device=device) for x in (reading, q, nrm, valid)]
    return args + [T.to(device), tau.to(device), 0.25]


def _scene(rng, n=6000):
    """Floor + two perpendicular walls: every direction is constrained, so
    the optimum is well defined (a one-wall scene leaves a translation free
    and two correct runs may part by millimetres along it)."""
    floor = np.c_[rng.uniform(-8, 8, (n // 2, 2)), 0.01 * rng.normal(size=(n // 2, 1))]
    wx = np.c_[np.full((n // 4, 1), 5.0), rng.uniform(-8, 8, (n // 4, 1)), rng.uniform(0, 3, (n // 4, 1))]
    wy = np.c_[rng.uniform(-8, 8, (n // 4, 1)), np.full((n // 4, 1), -4.0), rng.uniform(0, 3, (n // 4, 1))]
    return (np.vstack([floor, wx, wy]) + 0.004 * rng.normal(size=(n, 3))).astype(np.float32)


@pytest.mark.cuda
def test_pair_gn_kernel_matches_plain(rng, cuda_device):
    args = _pairs(rng, B=3, n=20000, device=cuda_device)
    before = tpg.pair_gn.launches
    got = tpg.pair_gn(*args)
    assert tpg.pair_gn.launches == before + 1
    terms = tpg.terms(*args).double()
    want, scale = tpg.unpack(terms.sum(1)), tpg.unpack(terms.abs().sum(1))
    for k, (g, w, s) in enumerate(zip(got, want, scale)):
        if k in (2, 4):  # sum_w, n_ok: exact counts
            assert torch.equal(g.double(), w)
        else:
            assert ((g.double() - w).abs() <= 1e-5 * (s + 1.0)).all()
    for g, a in zip(got, tpg.pair_gn(*args)):
        assert torch.equal(g, a)  # no float atomics: bit-identical reruns


def _fp64_check(got, args):
    """K1's five outputs against the float64 sum of the plain version's
    terms: the counts exact, the sums within 1e-5 of their magnitude."""
    terms = tpg.terms(*args).double()
    want, scale = tpg.unpack(terms.sum(1)), tpg.unpack(terms.abs().sum(1))
    for k, (g, w, s) in enumerate(zip(got, want, scale)):
        if k in (2, 4):  # sum_w, n_ok: exact counts
            assert torch.equal(g.double(), w)
        else:
            assert ((g.double() - w).abs() <= 1e-5 * (s + 1.0)).all()


def _k1_rows(got):
    """K1's five outputs -> its ``[B, 45]`` rows (A row-major, b, sum w,
    sum w r^2, n ok)."""
    B = got[0].shape[0]
    return torch.cat([x.reshape(B, -1) for x in got], 1)


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,case", [(1, 16411, "plain"), (8, 20003, "plain"), (8, 65536, "plain"),
                                      (3, 5001, "all-invalid"), (2, 7777, "unaligned"),
                                      (1, 4096, "plain"), (1, 16384, "plain"), (128, 512, "plain"),
                                      (2, 1, "plain"), (2, 0, "plain"), (1, 16384, "unaligned")])
def test_pair_gn_one_launch_matches_fp64(rng, cuda_device, B, n, case):
    """One call a wrapper launch at the SLAM step's 1 x 4,096 and 1 x
    16,384 (one cluster), the headline's 8 x 65,536 and point counts off
    the 512-point tile and past one cluster (a second kernel), 128 problems,
    1 and 0 points, all points invalid, and inputs 4 bytes off a 16-byte
    boundary: within the fp64 tolerance with exact counts, equal bit for
    bit to the order model (``tests/pair_gn_model.py``), and a second call
    gives the same bits."""
    from pair_gn_model import k1_model

    args = _pairs(rng, B=B, n=n, device=cuda_device)
    if case == "all-invalid":
        args[3] = torch.zeros_like(args[3])
    if case == "unaligned":
        for k in range(3):
            shifted = torch.empty(args[k].numel() + 1, device=cuda_device)[1:].view(args[k].shape)
            shifted.copy_(args[k])
            args[k] = shifted
    before = tpg.pair_gn.launches
    got = tpg.pair_gn(*args)
    assert tpg.pair_gn.launches == before + 1
    _fp64_check(got, args)
    if case == "all-invalid":
        assert all(bool((g == 0).all()) for g in got)
    model = k1_model(*(a.cpu().numpy() if torch.is_tensor(a) else a for a in args))
    assert np.array_equal(_k1_rows(got).cpu().numpy().view(np.int32), model.view(np.int32))
    again = tpg.pair_gn(*args)
    for g, a in zip(got, again):
        assert torch.equal(g.view(torch.int32), a.view(torch.int32))


@pytest.mark.cuda
def test_pair_gn_kernel_refuses_bad_inputs(rng, cuda_device):
    args = _pairs(rng, B=2, n=100, device=cuda_device)
    bad = list(args)
    bad[1] = bad[1].double()
    with pytest.raises(ValueError, match="dtype"):
        tpg.pair_gn(*bad)
    bad = list(args)
    bad[2] = bad[2].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        tpg.pair_gn(*bad)


@pytest.mark.cuda
def test_gather_select_kernel_matches_plain(rng, cuda_device):
    scene = torch.tensor(_scene(rng), device=cuda_device)
    mask = torch.ones(scene.shape[0], dtype=torch.bool, device=cuda_device)
    nrm = torch.nn.functional.normalize(torch.randn(scene.shape, device=cuda_device), dim=-1)
    cl = tcl.build_cell_list(scene, mask, 0.5, table_size=1 << 12, list_cap=24, normals=nrm)
    q = scene[:5000] + 0.05 * torch.randn(5000, 3, device=cuda_device)
    qm = torch.rand(5000, device=cuda_device) > 0.05
    h = tcl.query_hash(cl, q)
    before = tgs.gather_select.launches
    got = tgs.gather_select(cl.table, h, q, qm).view(torch.int32)
    assert tgs.gather_select.launches == before + 1
    assert torch.equal(got, tgs.gather_select_plain(cl.table, h, q, qm).view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("gather_kernel", [False, True])
def test_icp_batch_on_card_matches_cpu(rng, cuda_device, gather_kernel):
    """The chain on the card (kernels) agrees with the chain on the CPU
    (plain versions): transforms within 1e-4 m / 1e-4 rad of each other and
    of the truth. Sums run in another order on the card, so at the
    production checker thresholds (8 mm smoothed) one side can stop an
    iteration earlier (measured: 0.36 mm apart), and within a round the
    frozen pairs bias the optimum by about a millimetre. So this test
    re-matches every iteration and converges to 1e-6 (above the float32
    step quantisation of ~1.2e-7 m): both sides then reach the same fixed
    point."""
    scene = _scene(rng)
    cfg = dataclasses.replace(MapperConfig().icp, grid_table_size=1 << 12, grid_bucket_cap=24,
                              gather_kernel=gather_kernel, candidate_refresh_every=1,
                              min_diff_rot=1e-6, min_diff_trans=1e-6, max_iterations=40)
    T_true = se3.exp_se3(torch.tensor([[0.01, -0.008, 0.012, 0.08, -0.05, 0.03],
                                       [0.012, -0.01, 0.015, 0.1, -0.06, 0.035]]))
    init = T_true @ se3.exp_se3(torch.tensor([0.01, -0.01, 0.015, 0.05, 0.04, -0.05]))
    read_xyz = [se3.apply_transform(se3.transform_inverse(T_true[i]), torch.tensor(scene[i::3][:2048]))
                for i in range(2)]
    results = []
    for dev in (torch.device("cpu"), cuda_device):
        ref_b = tpc.from_points(scene, capacity=8192, device=dev)
        g = tgh.build_grid(ref_b.padded_xyz(), ref_b.mask, 2.0, 1 << 12, 32)
        ref_b = tnm.estimate_normals_moments(ref_b, g, max_dist=1.0,
                                             orient_towards=torch.zeros(3, device=dev))
        ref = ticp.build_reference(ref_b, cfg)
        reads = tpc.stack([tpc.from_points(x, device=dev) for x in read_xyz])
        results.append(ticp.icp_batch(reads, ref, init.to(dev), cfg).transform.cpu().double())
    for T in results[1:] + [T_true.double()]:
        d = torch.linalg.inv(results[0]) @ T
        assert (torch.linalg.vector_norm(d[:, :3, 3], dim=-1) < 1e-4).all()
        angle = se3.rotation_angular_distance(d[:, :3, :3], torch.eye(3, dtype=torch.float64))
        assert (angle < 1e-4).all()


def _adversarial_rows(rng, device, case, padded=False):
    """K2 inputs that stress the grouping: every query in one row (four
    blocks of queries), every query in a distinct row, out-of-range and
    negative row indices, all queries masked, a row without a valid slot
    (its ids -1, or with ``padded`` every slot the padding payload, xyz
    1e9, as K4's contract knows an empty slot)."""
    cl, h, q, qm = _cell_rows(rng, device)
    n = h.shape[0]
    if case == "one-row":
        h = torch.full_like(h, int(h[0]))
    elif case == "distinct-rows":
        n = min(n, cl.table_size)
        h, q, qm = torch.randperm(cl.table_size, device=device)[:n].to(torch.int32), q[:n], qm[:n]
    elif case == "out-of-range":
        h = h.clone()
        h[::7] = -1 - torch.arange(h[::7].numel(), device=device, dtype=torch.int32)
        h[3::7] = cl.table_size + torch.arange(h[3::7].numel(), device=device, dtype=torch.int32)
    elif case == "all-masked":
        qm = torch.zeros_like(qm)
    elif case == "empty-row":
        table = cl.table.clone()
        if padded:
            table[int(h[0])] = tgh.empty_payload(table.shape[1], device)
        else:
            table.view(torch.int32)[int(h[0]), :, 3] = -1
        cl = dataclasses.replace(cl, table=table)
        h = h.clone()
        h[: n // 2] = h[0]
    return cl, h, q, qm


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one-row", "distinct-rows", "out-of-range", "all-masked",
                                  "empty-row"])
def test_gather_select_adversarial_rows(rng, cuda_device, case):
    cl, h, q, qm = _adversarial_rows(rng, cuda_device, case)
    got = tgs.gather_select(cl.table, h, q, qm).view(torch.int32)
    want = tgs.gather_select_plain(cl.table, h, q, qm).view(torch.int32)
    assert torch.equal(got, want)
    if case == "out-of-range":
        assert bool((got[::7, 3] == -1).all()) and bool((got[3::7, 3] == -1).all())
    # The order of queries within a row varies between runs; the bits do not.
    assert torch.equal(tgs.gather_select(cl.table, h, q, qm).view(torch.int32), got)


def _pairs_k(rng, B, n, K, device):
    reading, _, _, _, T, tau, max_d2 = _pairs(rng, B, n, device)
    q = reading[:, :, None, :] + torch.tensor(rng.normal(scale=0.1, size=(B, n, K, 3)).astype(np.float32),
                                              device=device)
    nrm = torch.nn.functional.normalize(torch.tensor(rng.normal(size=(B, n, K, 3)).astype(np.float32),
                                                     device=device), dim=-1)
    valid = torch.tensor(rng.uniform(size=(B, n, K)) > 0.2, device=device)
    return [reading, q, nrm, valid, T, tau, max_d2]


@pytest.mark.cuda
@pytest.mark.parametrize("K", [2, 8])
def test_pair_gn_k_kernel_matches_plain(rng, cuda_device, K):
    args = _pairs_k(rng, B=3, n=20000, K=K, device=cuda_device)
    before = tpg.pair_gn_k.launches
    got = tpg.pair_gn_k(*args)
    assert tpg.pair_gn_k.launches == before + 1
    terms = tpg.terms_k(*args).double()
    want, scale = tpg.unpack(terms.sum(1)), tpg.unpack(terms.abs().sum(1))
    for k, (g, w, s) in enumerate(zip(got, want, scale)):
        if k in (2, 4):  # sum_w, n_ok: exact counts
            assert torch.equal(g.double(), w)
        else:
            assert ((g.double() - w).abs() <= 1e-5 * (s + 1.0)).all()
    for g, a in zip(got, tpg.pair_gn_k(*args)):
        assert torch.equal(g, a)  # no float atomics: bit-identical reruns


@pytest.mark.cuda
def test_pair_gn_k_kernel_refuses_bad_inputs(rng, cuda_device):
    args = _pairs_k(rng, B=2, n=100, K=3, device=cuda_device)
    bad = list(args)
    bad[1] = bad[1].double()
    with pytest.raises(ValueError, match="dtype"):
        tpg.pair_gn_k(*bad)
    bad = list(args)
    bad[2] = bad[2][:, :, :2]
    with pytest.raises(ValueError, match="shape"):
        tpg.pair_gn_k(*bad)
    wide = _pairs_k(rng, B=2, n=100, K=9, device=cuda_device)
    with pytest.raises(ValueError, match="K=9"):
        tpg.pair_gn_k(*wide)


def _cell_rows(rng, device):
    scene = torch.tensor(_scene(rng), device=device)
    mask = torch.ones(scene.shape[0], dtype=torch.bool, device=device)
    nrm = torch.nn.functional.normalize(torch.randn(scene.shape, device=device), dim=-1)
    cl = tcl.build_cell_list(scene, mask, 0.5, table_size=1 << 12, list_cap=24, normals=nrm)
    q = scene[:5000] + 0.05 * torch.randn(5000, 3, device=device)
    q[-500:] = 20.0 * torch.rand(500, 3, device=device)  # mostly empty rows
    qm = torch.rand(5000, device=device) > 0.05
    h = tcl.query_hash(cl, q)
    return cl, h, q, qm


@pytest.mark.cuda
def test_rank_select_kernel_matches_plain(rng, cuda_device):
    from open3d_slam_private_tpu_torch.kernels import select as tsel

    cl, h, q, qm = _cell_rows(rng, cuda_device)
    rows = cl.table.reshape(cl.table_size, -1)[h.long()]
    before = tsel.rank_select_rows.launches
    got = tsel.rank_select_rows(rows, q, qm).view(torch.int32)
    assert tsel.rank_select_rows.launches == before + 1
    assert torch.equal(got, tsel.rank_select_rows_plain(rows, q, qm).view(torch.int32))
    # K2 on the same table and queries equals its plain version too.
    assert torch.equal(tgs.gather_select(cl.table, h, q, qm).view(torch.int32),
                       tgs.gather_select_plain(cl.table, h, q, qm).view(torch.int32))


@pytest.mark.cuda
def test_rank_select_kernel_refuses_bad_inputs(rng, cuda_device):
    from open3d_slam_private_tpu_torch.kernels import select as tsel

    cl, h, q, qm = _cell_rows(rng, cuda_device)
    rows = cl.table.reshape(cl.table_size, -1)[h.long()]
    with pytest.raises(ValueError, match="cap"):
        tsel.rank_select_rows(rows[:, :-1], q, qm)
    with pytest.raises(ValueError, match="contiguous"):
        tsel.rank_select_rows(rows.t().contiguous().t(), q, qm)
    shifted = torch.empty(rows.numel() + 1, device=cuda_device)[1:].view(rows.shape)
    shifted.copy_(rows)  # contiguous, 4 bytes off a 16-byte boundary
    with pytest.raises(ValueError, match="aligned"):
        tsel.rank_select_rows(shifted, q, qm)


def _knn_brute_both(q, ref):
    """K5's kernel (one launch, counted) and its plain version on the same
    inputs, held to ids equal and distances within 1 ulp (the plain version
    rounds each fused multiply-add twice, float64 then float32)."""
    from open3d_slam_private_tpu_torch.kernels import knn_brute as tkb

    before = tkb.knn_brute.launches
    d2, ids = tkb.knn_brute(q, ref)
    torch.cuda.synchronize()
    assert tkb.knn_brute.launches == before + 1
    d2_p, ids_p = tkb.knn_brute_plain(q, ref)
    assert ids.dtype == torch.int32 and torch.equal(ids, ids_p)
    if q.shape[0]:
        assert int(ulps(d2, d2_p).max()) <= 1
    return d2, ids


@pytest.mark.cuda
@pytest.mark.parametrize("nq", [1000, 70000, 300000])
def test_knn_brute_kernel_matches_plain(rng, cuda_device, nq):
    """Query counts from a few blocks split across the reference to many
    query tiles; padded rows never win; exact hits give 0; ids equal the
    plain version's, distances within 1 ulp; the launch counter counts each
    call."""
    ref = torch.tensor(rng.uniform(-10, 10, (5003, 3)).astype(np.float32), device=cuda_device)
    ref[-7:] = tpc.PAD_COORD
    q = torch.tensor(rng.uniform(-11, 11, (nq, 3)).astype(np.float32), device=cuda_device)
    q[:10] = ref[100:110]  # exact hits
    d2, ids = _knn_brute_both(q, ref)
    assert int(ids.max()) < 5003 - 7 and (d2[:10] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("nq,nr", [(100, 70000), (200000, 300), (5000, 1037), (3000, 1), (50, 0),
                                   (0, 500)])
def test_knn_brute_kernel_shapes(rng, cuda_device, nq, nr):
    """Q << M (many splits), Q >> M (one split), M off the tile and the
    split, M = 1, M = 0 ((inf, 0) for every query) and Q = 0."""
    from open3d_slam_private_tpu_torch.kernels import knn_brute as tkb

    q = torch.tensor(rng.uniform(-40, 40, (nq, 3)).astype(np.float32), device=cuda_device)
    ref = torch.tensor(rng.uniform(-40, 40, (nr, 3)).astype(np.float32), device=cuda_device)
    plan = tkb.knn_brute_plan(nq, nr, cuda_device)
    assert plan["packed_rows"] >= nr
    if nq == 100:
        assert plan["splits"] > 1
    d2, ids = _knn_brute_both(q, ref)
    if nr == 0:
        assert torch.isinf(d2).all() and (ids == 0).all()


@pytest.mark.cuda
def test_knn_brute_kernel_ties_take_the_lowest_index(rng, cuda_device):
    """Exact duplicates of one reference block at several offsets, among
    them either side of a chunk (64), a tile (128) and every split boundary
    of the plan: every query's distance ties across the copies, and the
    first copy wins, as in the plain version."""
    from open3d_slam_private_tpu_torch.kernels import knn_brute as tkb

    base = rng.uniform(-40, 40, (16, 3)).astype(np.float32)
    filler = rng.uniform(200, 300, (40000, 3)).astype(np.float32)  # never nearest
    q = torch.tensor(base + rng.normal(scale=0.05, size=(600, 16, 3)).astype(np.float32)
                     .reshape(-1, 16, 3), device=cuda_device).reshape(-1, 3)
    plan = tkb.knn_brute_plan(q.shape[0], filler.shape[0], cuda_device)
    tiles = plan["packed_rows"] // 128
    bounds = sorted({64, 128} | {tiles * s // plan["splits"] * 128 for s in range(1, plan["splits"])})
    assert plan["splits"] > 1
    starts = [0] + [b - 8 for b in bounds]  # each copy straddles its boundary
    for st in starts:
        filler[st:st + 16] = base
    ref = torch.tensor(filler, device=cuda_device)
    d2, ids = _knn_brute_both(q, ref)
    first = torch.tensor(starts[0], device=cuda_device) + torch.arange(16, device=cuda_device).repeat(600)
    assert torch.equal(ids.long(), first)


@pytest.mark.cuda
def test_knn_brute_kernel_negative_and_tiny(rng, cuda_device):
    """Queries 10 um off reference points at ~40 m, where the unclamped
    expansion goes negative; queries and references at 0 and at tiny
    coordinates (products near and below the smallest normal float32)."""
    r = np.c_[rng.uniform(30, 40, (4096, 2)), rng.uniform(-2, 4, (4096, 1))].astype(np.float32)
    u = rng.normal(size=(4096, 3))
    q = (r + 1e-5 * u / np.linalg.norm(u, axis=1, keepdims=True)).astype(np.float32)
    d2, _ = _knn_brute_both(torch.tensor(q, device=cuda_device), torch.tensor(r, device=cuda_device))
    assert int((d2 < 0).sum()) > 100
    for scale in (1e-15, 1e-19, 1e-21, 1e-23):
        q = rng.uniform(-1, 1, (3000, 3)) * scale
        r = rng.uniform(-1, 1, (2000, 3)) * scale
        q[:20], r[:20], q[20:40] = 0.0, 0.0, r[100:120]
        _knn_brute_both(torch.tensor(q.astype(np.float32), device=cuda_device),
                        torch.tensor(r.astype(np.float32), device=cuda_device))


@pytest.mark.cuda
def test_knn_brute_kernel_near_ties(cuda_device):
    """Map-scale near-ties: 8,192 queries at midpoints of reference pairs
    2 cm apart, 8,192 uniform, against 65,536 points in an 80 x 80 x 4 m
    box (the smoke's near-tie set, smaller)."""
    q, r = near_ties(16384, 65536, seed=7)
    _knn_brute_both(torch.tensor(q, device=cuda_device), torch.tensor(r, device=cuda_device))


@pytest.mark.cuda
def test_knn_brute_kernel_refuses_bad_inputs(cuda_device):
    from open3d_slam_private_tpu_torch.kernels import knn_brute as tkb

    q = torch.zeros((10, 3), device=cuda_device)
    with pytest.raises(ValueError, match="dtype"):
        tkb.knn_brute(q.double(), q.double())
    with pytest.raises(ValueError, match="shape"):
        tkb.knn_brute(torch.zeros((10, 4), device=cuda_device), q)
    with pytest.raises(ValueError, match="on cpu"):
        tkb.knn_brute(q, q.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("matcher", ["grid", "brute_pallas"])
def test_per_iteration_chain_on_card_matches_cpu(rng, cuda_device, matcher):
    """``register_pair`` on the reference-exact per-iteration chain (exact
    trimming) agrees between the card and the CPU within 1e-4 m / 1e-4 rad,
    and both find the truth; the brute_pallas run goes through K5."""
    from open3d_slam_private_tpu_torch.kernels import knn_brute as tkb

    scene = _scene(rng)
    cfg = ticp.ICPConfig(knn=1, max_match_dist=0.5, matcher=matcher, grid_table_size=1 << 12,
                         grid_bucket_cap=24, trimmed_ratio=0.9, max_iterations=40,
                         min_diff_rot=1e-6, min_diff_trans=1e-6)
    T_true = se3.exp_se3(torch.tensor([0.01, -0.008, 0.012, 0.08, -0.05, 0.03]))
    init = T_true @ se3.exp_se3(torch.tensor([0.01, -0.01, 0.015, 0.05, 0.04, -0.05]))
    read_xyz = se3.apply_transform(se3.transform_inverse(T_true), torch.tensor(scene[::3][:2048]))
    results = []
    for dev in (torch.device("cpu"), cuda_device):
        ref_b = tpc.from_points(scene, capacity=8192, device=dev)
        g = tgh.build_grid(ref_b.padded_xyz(), ref_b.mask, 2.0, 1 << 12, 32)
        ref_b = tnm.estimate_normals_moments(ref_b, g, max_dist=1.0,
                                             orient_towards=torch.zeros(3, device=dev))
        before = tkb.knn_brute.launches
        res = ticp.register_pair(tpc.from_points(read_xyz, device=dev), ref_b, init.to(dev), cfg)
        if dev.type == "cuda" and matcher == "brute_pallas":
            assert tkb.knn_brute.launches > before
        results.append(res.transform.cpu().double())
    for T in results[1:] + [T_true.double()]:
        d = torch.linalg.inv(results[0]) @ T
        assert float(torch.linalg.vector_norm(d[:3, 3])) < 1e-4
        assert float(se3.rotation_angular_distance(d[:3, :3], torch.eye(3, dtype=torch.float64))) < 1e-4


@pytest.mark.cuda
def test_voxel_downsample_is_deterministic_on_card(rng, cuda_device):
    """Two runs over 400k points give the same bits (the segment sums add
    each voxel's run in a fixed order; no atomics)."""
    from open3d_slam_private_tpu_torch.ops.voxel import voxel_downsample

    pts = torch.tensor(rng.uniform(-40, 40, (400_000, 3)).astype(np.float32), device=cuda_device)
    pts[:, 2] *= 0.05
    nrm = torch.nn.functional.normalize(torch.randn(pts.shape, device=cuda_device), dim=-1)
    batch = tpc.from_points(pts, capacity=512 * 1024, device=cuda_device).with_extras(
        normals=torch.cat([nrm, torch.zeros((512 * 1024 - 400_000, 3), device=cuda_device)]))
    a = voxel_downsample(batch, 0.15, capacity=131072, priority_center=torch.zeros(3, device=cuda_device))
    b = voxel_downsample(batch, 0.15, capacity=131072, priority_center=torch.zeros(3, device=cuda_device))
    assert int(a.count()) > 100_000
    assert torch.equal(a.mask, b.mask)
    assert torch.equal(a.xyz.view(torch.int32), b.xyz.view(torch.int32))
    assert torch.equal(a.normals.view(torch.int32), b.normals.view(torch.int32))
    cpu = voxel_downsample(tpc.PointBatch(batch.xyz.cpu(), batch.mask.cpu(),
                                          {"normals": batch.normals.cpu()}), 0.15, capacity=131072,
                           priority_center=torch.zeros(3))
    assert torch.equal(cpu.mask, a.mask.cpu())
    torch.testing.assert_close(a.xyz.cpu(), cpu.xyz, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_slam_pipeline_on_card_matches_cpu(rng, cuda_device):
    """``SlamPipeline`` (LiDAR odometry with the hash matcher -> mapper ->
    submap collection) over 5 scans on the card (K1 from both stages) and
    on the CPU: the poses within 1e-4 m / 1e-4 rad of each other at every
    scan, the same submap count. Sums run in other orders on the card, so,
    as in the chain's card test above, both sides re-match every iteration
    and converge to their fixed points (thresholds 1e-6): with the pairs
    frozen for a round and the production thresholds, inputs 1e-6 apart
    (relative) ended 2e-4 to 4e-4 m apart on the CPU in two of three
    sequences, and this test's two runs 2.9e-4 m apart on an H100."""
    from open3d_slam_private_tpu_torch.slam import pipeline as tpipe
    from open3d_slam_private_tpu_torch.slam.odometry import OdometryConfig
    from open3d_slam_private_tpu_torch.slam.submap_collection import SubmapCollectionConfig

    scene = _scene(rng, n=20000)
    tight = dict(min_diff_rot=1e-6, min_diff_trans=1e-6, max_iterations=40, candidate_refresh_every=1)
    odo = OdometryConfig(max_points=2048)
    mcfg = dataclasses.replace(MapperConfig(), scan_capacity=2048, ref_capacity=4096,
                               submap_capacity=8192)
    cfg = tpipe.SlamConfig(
        odometry=dataclasses.replace(odo, icp=dataclasses.replace(odo.icp, grid_table_size=1 << 11,
                                                                  **tight)),
        mapper=dataclasses.replace(mcfg, icp=dataclasses.replace(mcfg.icp, grid_table_size=1 << 12,
                                                                 **tight)),
        submaps=SubmapCollectionConfig(submap_capacity=8192, creation_radius=0.5,
                                       min_scans_before_switch=1),
        loop_closure_enabled=False,
    )
    scans = []
    for k in range(5):
        T = se3.exp_se3(torch.tensor([0.0, 0.0, 0.01 * k, 0.2 * k, 0.05 * k, 0.0], dtype=torch.float64))
        pts = torch.tensor(scene[rng.choice(len(scene), 3000, replace=False)], dtype=torch.float64)
        local = se3.apply_transform(se3.transform_inverse(T), pts) + 0.005 * torch.randn(3000, 3,
                                                                                        dtype=torch.float64)
        scans.append(tpc.from_points(local.float(), capacity=4096))
    poses = {}
    for dev in (torch.device("cpu"), cuda_device):
        pipe = tpipe.SlamPipeline(cfg, device=dev)
        before = tpg.pair_gn.launches
        poses[dev.type] = [(pipe.process_scan(s, 0.1 * k), pipe.pose)[1] for k, s in enumerate(scans)]
        if dev.type == "cuda":
            assert tpg.pair_gn.launches > before
            assert len(pipe.submaps) == n_submaps >= 2
        else:
            n_submaps = len(pipe.submaps)
    for a, b in zip(poses["cpu"], poses["cuda"]):
        d = torch.tensor(np.linalg.inv(a) @ b)
        assert float(torch.linalg.vector_norm(d[:3, 3])) < 1e-4
        assert float(se3.rotation_angular_distance(d[:3, :3], torch.eye(3, dtype=torch.float64))) < 1e-4


def _normal_eq_inputs(rng, B, n, K, device):
    src = rng.uniform(-5, 5, size=(B, n, 3)).astype(np.float32)
    q = src[:, :, None, :] + rng.normal(scale=0.05, size=(B, n, K, 3)).astype(np.float32)
    nrm = rng.normal(size=(B, n, K, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    w = (rng.uniform(size=(B, n, K)) > 0.3).astype(np.float32)
    return [torch.tensor(x, device=device) for x in (src, q, nrm, w)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,K", [(3, 5003, 1), (2, 20000, 8), (5, 7, 3), (1, 0, 1), (1, 4096, 1),
                                   (1, 16384, 1), (64, 512, 1), (1, 65536, 8), (1, 65536, 1),
                                   (64, 1024, 1), (3, 6000, 3), (2, 513, 1)])
def test_normal_eq_kernel_matches_plain(rng, cuda_device, B, n, K):
    """normal_eq against the float64 sums of the plain version's function,
    within 1e-5 of each entry's magnitude, and bit for bit against the
    order model (``tests/normal_eq_model.py``) on each route: one warp a
    problem (the burst's 512 pairs), one cluster (the SLAM step's 1 x 4,096
    x 1 and 1 x 16,384 x 1), two passes (the detection's 65,536 x 8, the
    per-iteration chain's 65,536 x 1); a rerun and each problem run alone
    (the first 8) give the same bits; off the chunks, K other than 1 and
    8, and with no pair."""
    from chip_smoke import _normal_eq_fp64
    from normal_eq_model import ne_model
    from open3d_slam_private_tpu_torch.kernels import normal_eq as tne

    args = _normal_eq_inputs(rng, B, n, K, cuda_device)
    before = tne.normal_eq.launches
    A, b = tne.normal_eq(*args)
    assert tne.normal_eq.launches == before + 1
    A64, b64, sA, sb = _normal_eq_fp64(*args)
    assert ((A.double() - A64).abs() <= 1e-5 * (sA + 1.0)).all()
    assert ((b.double() - b64).abs() <= 1e-5 * (sb + 1.0)).all()
    pA, pb = tne.normal_eq_plain(*args)  # the float32 einsum: also within 1e-5 of the magnitude
    assert ((A.double() - pA.double()).abs() <= 2e-5 * (sA + 1.0)).all()
    assert ((b.double() - pb.double()).abs() <= 2e-5 * (sb + 1.0)).all()
    model = ne_model(*(x.cpu().numpy() for x in args))
    got = torch.cat([A.reshape(B, 36), b], 1).cpu().numpy()
    assert np.array_equal(got.view(np.int32), model.view(np.int32))
    A2, b2 = tne.normal_eq(*args)
    assert torch.equal(A.view(torch.int32), A2.view(torch.int32))
    assert torch.equal(b.contiguous().view(torch.int32), b2.contiguous().view(torch.int32))
    for i in range(min(B, 8)):
        Ai, bi = tne.normal_eq(*(x[i:i + 1].contiguous() for x in args))
        assert torch.equal(Ai.view(torch.int32), A[i:i + 1].view(torch.int32))
        assert torch.equal(bi.contiguous().view(torch.int32), b[i:i + 1].contiguous().view(torch.int32))


@pytest.mark.cuda
def test_normal_eq_kernel_refuses_bad_inputs(rng, cuda_device):
    from open3d_slam_private_tpu_torch.kernels import normal_eq as tne

    args = _normal_eq_inputs(rng, 2, 100, 2, cuda_device)
    bad = list(args)
    bad[3] = bad[3].double()
    with pytest.raises(ValueError, match="dtype"):
        tne.normal_eq(*bad)
    bad = list(args)
    bad[1] = bad[1].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        tne.normal_eq(*bad)
    bad = list(args)
    bad[2] = bad[2][:, :, :1].contiguous()
    with pytest.raises(ValueError, match="shape"):
        tne.normal_eq(*bad)
    with pytest.raises(ValueError, match="on cpu"):
        tne.normal_eq(args[0], args[1].cpu(), args[2], args[3])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["rows", "one-row", "distinct-rows", "all-masked", "empty-row"])
def test_rank_select_table_kernel_matches_plain(rng, cuda_device, case):
    """K4's table entry equals its plain version (the rows gathered, then
    K4's plain rank) bit for bit, on the cell rows of a scene and on K2's
    stress cases in K4's contract: every query in one row, every query in a
    distinct row, all masked, half the queries in a row of padding only
    (finite distances, occupancy 0)."""
    from open3d_slam_private_tpu_torch.kernels import select as tsel

    if case == "rows":
        cl, h, q, qm = _cell_rows(rng, cuda_device)
    else:
        cl, h, q, qm = _adversarial_rows(rng, cuda_device, case, padded=True)
    table, n = cl.table, h.shape[0]
    before = tsel.rank_select_table.launches
    got = tsel.rank_select_table(table, h, q, qm)
    assert tsel.rank_select_table.launches == before + 1
    assert torch.equal(got.view(torch.int32), tsel.rank_select_table_plain(table, h, q, qm).view(torch.int32))
    if case == "empty-row":
        assert bool(torch.isfinite(got[: n // 2][qm[: n // 2], 7]).all())
        assert bool((got[: n // 2, 8] == 0).all())
    assert torch.equal(tsel.rank_select_table(table, h, q, qm).view(torch.int32), got.view(torch.int32))


@pytest.mark.cuda
def test_rank_select_table_kernel_refuses_bad_inputs(rng, cuda_device):
    from open3d_slam_private_tpu_torch.kernels import select as tsel

    cl, h, q, qm = _cell_rows(rng, cuda_device)
    with pytest.raises(ValueError, match="dtype"):
        tsel.rank_select_table(cl.table, h.long(), q, qm)
    with pytest.raises(ValueError, match="shape"):
        tsel.rank_select_table(cl.table[:, :, :4].contiguous(), h, q, qm)
    # Rows whose rank block fits in a block's shared memory (437 slots on an
    # H100: two stages of a row and 32 records a warp) are taken; wider ones
    # are refused before any pass runs.
    wide = torch.rand((16, 437, 8), generator=torch.Generator().manual_seed(3)).to(cuda_device)
    hw = (h % 16).contiguous()
    assert torch.equal(tsel.rank_select_table(wide, hw, q, qm).view(torch.int32),
                       tsel.rank_select_table_plain(wide, hw, q, qm).view(torch.int32))
    before = tsel.rank_select_table.launches
    with pytest.raises(RuntimeError, match="wider than"):
        tsel.rank_select_table(torch.zeros((16, 438, 8), device=cuda_device), hw, q, qm)
    assert tsel.rank_select_table.launches == before
    shifted = torch.empty(cl.table.numel() + 1, device=cuda_device)[1:].view(cl.table.shape)
    shifted.copy_(cl.table)  # contiguous, 4 bytes off a 16-byte boundary
    with pytest.raises(ValueError, match="aligned"):
        tsel.rank_select_table(shifted, h, q, qm)


_MOMENT_CHAINS = {  # the cached rounds off the fused kernels, and GICP per iteration
    "cached-knn1-moment-optimized": dict(fused_kernel=False, degeneracy="optimized"),
    "cached-knn1-moment-ternary": dict(fused_kernel=False, degeneracy="equality_constraints"),
    "cached-knn1-moment-gicp": dict(fused_kernel=False, minimizer="gicp"),
    "cached-knn1-direct": dict(fused_kernel=False, fast_trimming=False),
    "iter-gicp": dict(minimizer="gicp"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("chain", ["iter-grid", "iter-brute", "iter-brute_pallas", "cached-knn1",
                                   "cached-knn1-optimized", "cached-knn4", *_MOMENT_CHAINS])
def test_batch_independence_on_card(rng, cuda_device, chain):
    """Problems 0-3 of a batch of 64 (``register_hypotheses``) give the same
    transforms, bit for bit, as the same problems run as a batch of 4: the
    per-iteration chain with the grid, brute and brute_pallas matchers and
    with GICP, the cached rounds on the fused kernels at knn 1 (with and
    without the X-ICP Optimized method) and knn 4, on the moment path (the
    binary and the ternary method, GICP) and on the direct path."""
    from open3d_slam_private_tpu_torch.models.localizability import DegeneracyConfig

    scene = _scene(rng)
    kind, *rest = chain.split("-")
    base = dict(knn=1, max_match_dist=0.5, grid_table_size=1 << 12, grid_bucket_cap=24,
                trimmed_ratio=0.9, fast_trimming=True, max_iterations=12)
    change = dict(_MOMENT_CHAINS.get(chain, {}))
    if "degeneracy" in change:
        change["degeneracy"] = DegeneracyConfig(method=change["degeneracy"])
    if kind == "iter":
        cfg = ticp.ICPConfig(matcher="grid" if chain == "iter-gicp" else rest[0], **{**base, **change})
    else:
        base.update(knn=int(rest[0][3:]), matcher="grid", candidate_refresh_every=4, fused_kernel=True)
        if rest[1:] == ["optimized"]:
            base["degeneracy"] = DegeneracyConfig(method="optimized")
        cfg = ticp.ICPConfig(**{**base, **change})
    ref_b = tpc.from_points(scene, capacity=8192, device=cuda_device)
    g = tgh.build_grid(ref_b.padded_xyz(), ref_b.mask, 2.0, 1 << 12, 32)
    ref_b = tnm.estimate_normals_moments(ref_b, g, max_dist=1.0,
                                         orient_towards=torch.zeros(3, device=cuda_device))
    reading = tpc.from_points(torch.tensor(scene[1::5][:1024], device=cuda_device) + 0.003, device=cuda_device)
    if cfg.minimizer == "gicp":
        rg = tgh.build_grid(reading.padded_xyz(), reading.mask, 0.5, 1 << 12, 32)
        reading = tnm.estimate_normals_grid(reading, rg, knn=8, max_dist=0.5)
    twists = np.c_[rng.uniform(-0.05, 0.05, (64, 3)), rng.uniform(-0.5, 0.5, (64, 3))]
    seeds = se3.exp_se3(torch.tensor(twists, dtype=torch.float32)).to(cuda_device)
    big = ticp.register_hypotheses(reading, ref_b, seeds, cfg).transform[:4]
    small = ticp.register_hypotheses(reading, ref_b, seeds[:4].contiguous(), cfg).transform
    assert bool(torch.isfinite(big).all())
    assert torch.equal(big.contiguous().view(torch.int32), small.contiguous().view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("B,P", [(1, 1), (3, 1000), (2, 1024), (4, 5000), (2, 20011), (0, 7), (1, 4096),
                                 (1, 16383), (2, 16384), (1, 16385)])
def test_moments_kernel_matches_fp64(rng, cuda_device, B, P):
    """The ``moments`` kernel's entries against the float64 sums: each
    within 1e-5 of its terms' magnitudes; a rerun and each problem alone
    give the same bits; sizes off the 4,096-pair chunk and the raw entry's
    512-2,048-pair chunks (``raw_plan``), the SLAM step's 4,096 and 16,384
    pairs, the raw entry's one-launch threshold (16,384) and either side of
    it, one pair, no problem. 520 raw sums take two launches (32 windows of
    16 columns a launch). The raw entry at S = 3, 6, 36 and 520 equals its
    numpy model (``tests/moments_model.py``) bit for bit, and a column's
    bits do not depend on S, its position or its group."""
    from moments_model import raw_model

    from open3d_slam_private_tpu_torch.kernels import moments as tmk
    from open3d_slam_private_tpu_torch.models import minimizers as tmin

    def unit(x):
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    arrays = [rng.normal(0, 4, (B, P, 3)), None, unit(rng.normal(size=(B, P, 3))),
              unit(rng.normal(size=(B, P, 3))),
              (rng.uniform(size=(B, P)) > 0.25) * rng.uniform(0.5, 2, (B, P))]
    arrays[1] = arrays[0] + rng.normal(0, 0.05, (B, P, 3))
    p0, q, n, ns, w = (torch.tensor(a, dtype=torch.float32, device=cuda_device) for a in arrays)
    d = [torch.tensor(a, dtype=torch.float64, device=cuda_device) for a in arrays]
    same = lambda x, y: torch.equal(x.contiguous().view(torch.int32), y.contiguous().view(torch.int32))  # noqa: E731
    cases = (
        (tmin.P2PL_LAYOUT, lambda *a: tmk.point_to_plane_moments(*a), (p0, q, n, w),
         tmin.point_to_plane_moments(d[0], d[1], d[2], d[4]),
         tmin.point_to_plane_moments(d[0].abs(), d[1].abs(), d[2].abs(), d[4])),
        (tmin.GICP_LAYOUT, lambda *a: tmk.gicp_moments(*a, epsilon=1e-3), (p0, ns, q, n, w),
         tmin.gicp_moments(d[0], d[3], d[1], d[2], d[4]),
         tmin.gicp_moments_from_precision(
             d[0].abs(), d[1].abs(), (tmin._gicp_precision(d[3], d[2], 1e-3) * d[4][..., None, None]).abs(),
             d[4])),
    )
    before = tmk.moments.launches
    for layout, kernel, args, want, scale in cases:
        got = tmin.pack_moments(kernel(*args), layout)
        assert same(got, tmin.pack_moments(kernel(*args), layout))
        want, scale = tmin.pack_moments(want, layout), tmin.pack_moments(scale, layout)
        assert ((got.double() - want).abs() <= 1e-5 * scale + 1e-30).all()
        for i in range(B):
            alone = tmin.pack_moments(kernel(*(x[i:i + 1].contiguous() for x in args)), layout)
            assert same(alone, got[i:i + 1])
    terms = torch.tensor(rng.normal(size=(B, P, 520)), dtype=torch.float32, device=cuda_device)
    got = tmk.pair_sums(terms)
    assert got.shape == (B, 520)
    assert ((got.double() - terms.double().sum(1)).abs() <= 1e-5 * terms.double().abs().sum(1) + 1e-30).all()
    assert tmk.moments.launches == before + 2 * (2 + B) + 2  # 520 sums, 33 windows of 16: two launches
    assert same(got, torch.from_numpy(raw_model(terms.cpu().numpy())).to(cuda_device))
    col = terms[..., 7:8].contiguous()
    want = tmk.pair_sums(col)
    for S in (3, 6, 36):
        t = terms[..., 100:100 + S].contiguous()
        got = tmk.pair_sums(t)
        assert same(got, torch.from_numpy(raw_model(t.cpu().numpy())).to(cuda_device))
        assert ((got.double() - t.double().sum(1)).abs() <= 1e-5 * t.double().abs().sum(1) + 1e-30).all()
        for j in (0, S - 1):  # column 7 of ``terms`` at position j of S
            moved = t.clone()
            moved[..., j] = col[..., 0]
            assert same(tmk.pair_sums(moved)[:, j], want[:, 0])
    groups = (terms[..., :3].contiguous(), col, terms[..., 3:39].contiguous())
    for g, alone in zip(tmk.pair_sums_groups(*groups), (tmk.pair_sums(x) for x in groups)):
        assert same(g, alone)


@pytest.mark.cuda
def test_pair_sums_graph_capture_and_streams(rng, cuda_device):
    """``pair_sums_groups`` captured in a CUDA graph (the X-ICP detection's
    shape: four groups of 16,384 x 3): the capture counts no launch, two
    replays give the eager call's bits; two streams summing other data at
    once, on both routes (16,384 and 40,000 pairs), each give their own
    eager bits."""
    from open3d_slam_private_tpu_torch.kernels import moments as tmk

    same = lambda x, y: torch.equal(x.contiguous().view(torch.int32), y.contiguous().view(torch.int32))  # noqa: E731
    groups = [torch.tensor(rng.normal(size=(1, 16384, 3)), dtype=torch.float32, device=cuda_device)
              for _ in range(4)]
    eager = torch.cat(tmk.pair_sums_groups(*groups), -1)
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        tmk.pair_sums_groups(*groups)
    torch.cuda.current_stream(cuda_device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = tmk.moments.launches
    with torch.cuda.graph(graph):
        captured = tmk.pair_sums_groups(*groups)
    assert tmk.moments.launches == before
    graph.replay()
    first = torch.cat(captured, -1).clone()
    graph.replay()
    torch.cuda.synchronize()
    assert same(first, eager) and same(torch.cat(captured, -1), eager)

    streams = [torch.cuda.Stream(cuda_device) for _ in range(2)]
    for P in (16384, 40000):
        data = [torch.tensor(rng.normal(size=(2, P, 6)), dtype=torch.float32, device=cuda_device)
                for _ in streams]
        want = [tmk.pair_sums(x) for x in data]
        torch.cuda.synchronize()
        outs = [[], []]
        for _ in range(20):
            for i, (st, x) in enumerate(zip(streams, data)):
                with torch.cuda.stream(st):
                    outs[i].append(tmk.pair_sums(x))
        torch.cuda.synchronize()
        for i in range(2):
            assert all(same(o, want[i]) for o in outs[i]), (P, i)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3, 6, 12])
def test_batched_eigh_is_batch_independent_on_card(cuda_device, n):
    """``torch.linalg.eigh`` of small matrices (zero and rank-deficient ones
    among them, as the X-ICP solves give) gives each matrix the same bits in
    a batch of 4, 12 or 48 as in a batch of 192 and alone. (The chains call
    it one matrix at a time on CPU tensors all the same, and the ``sym_eig``
    kernel on the card.)"""
    g = torch.Generator().manual_seed(n)
    X = torch.randn(192, n, n + 2, generator=g)
    M = X @ X.transpose(-1, -2)
    M[::3] = 0.0
    M[1::3, -1, :] = 0.0
    M[1::3, :, -1] = 0.0
    M = M.to(cuda_device)
    w, V = torch.linalg.eigh(M)
    for small in (4, 12, 48):
        ws, Vs = torch.linalg.eigh(M[:small])
        assert torch.equal(ws, w[:small]) and torch.equal(Vs, V[:small])
    for i in range(4):
        wi, Vi = torch.linalg.eigh(M[i:i + 1])
        assert torch.equal(wi, w[i:i + 1]) and torch.equal(Vi, V[i:i + 1])


def _sym_mats(rng, B, n, dtype):
    """Symmetric test matrices as the chain hands them: SPD normal
    equations, KKT matrices with inert zero rows (n = 12), rank-deficient
    and zero ones."""
    X = rng.normal(size=(B, n, n))
    M = X @ X.transpose(0, 2, 1) * 100.0
    if n == 12:
        M[::2, 6:, 6:] = 0.0
        M[::2, 9:, :] = 0.0
        M[::2, :, 9:] = 0.0
    M[3::7] = 0.0
    M[5::7, -1, :] = 0.0
    M[5::7, :, -1] = 0.0
    return torch.tensor(M, dtype=dtype)


def _sym_batch(rng, B, n, dtype):
    """``_sym_mats`` followed by ``tests/sym_eig_model.py``'s families at
    size n (SPD with a weak direction, diagonal with a repeated entry, zero,
    repeated eigenvalues, scales 1e-20 and 1e20, KKT with 0/1/3/5 locked
    rows at n = 12)."""
    first = _sym_mats(rng, B, n, dtype)
    return torch.cat([first] + [torch.tensor(v, dtype=dtype) for v in families(rng, n).values()])


# The (n, type) cases this test held before every n in 1..16 was added.
_SYM_EIG_FIRST_CASES = ((12, torch.float64), (6, torch.float64), (6, torch.float32), (3, torch.float64),
                        (5, torch.float64))


def _float32_pseudo_solve_defined(M):
    """Where two float32 eigensolvers' minimum-norm pseudo-solves agree to
    the test's 1e-2: every eigenvalue (float64, of the same values) either
    kept with room (>= 1e-4 of the largest: its reciprocal good to ~1e-3)
    or plainly dropped (<= 1e-9 of it, far under the 1e-7 cutoff). An
    ill-conditioned draw or a float32 KKT matrix (an eigenvalue at the
    cutoff's order; the chain solves KKT in float64) is outside float32's
    reach for any solver."""
    w = torch.linalg.eigvalsh(M.double().cpu()).abs()
    r = w / w.amax(-1, keepdim=True).clamp(min=1e-300)
    return ~((r > 1e-9) & (r < 1e-4)).any(-1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", range(1, 17))
def test_sym_eig_kernel_matches_plain(rng, cuda_device, n, dtype):
    """The Jacobi kernel against ``torch.linalg.eigh`` (its plain version)
    at every n it takes, on ``_sym_batch``'s families: eigenvalues within a
    few ulps of the matrix's scale, orthonormal eigenvectors that rebuild
    the matrix, the same minimum-norm pseudo-solve (float32: on the
    matrices where a float32 pseudo-solve is defined, and on every matrix
    of the cases held before); one launch a call."""
    from open3d_slam_private_tpu_torch.kernels import sym_eig as tse
    from open3d_slam_private_tpu_torch.models import minimizers

    M = _sym_batch(rng, 40, n, dtype).to(cuda_device)
    B = M.shape[0]
    before = tse.sym_eig.launches
    w, V, sweeps = tse.sym_eig(M, sweeps=True)
    assert tse.sym_eig.launches == before + 1
    assert int(sweeps.max()) < tse.MAX_SWEEPS
    eps = torch.finfo(dtype).eps
    scale = M.abs().amax(dim=(-2, -1)).double() + 1e-300
    wp, _ = tse.sym_eig_plain(M.cpu())
    assert ((w.double().cpu() - wp.double()).abs().amax(-1) <= 64 * n * eps * scale.cpu()).all()
    eye = torch.eye(n, dtype=torch.float64, device=cuda_device)
    Vd = V.double()
    assert ((Vd.mT @ Vd - eye).abs().amax(dim=(-2, -1)) <= 64 * n * eps).all()
    rebuilt = Vd @ torch.diag_embed(w.double()) @ Vd.mT
    assert ((rebuilt - M.double()).abs().amax(dim=(-2, -1)) <= 64 * n * eps * scale).all()
    rhs = torch.tensor(rng.normal(size=(B, n)), dtype=dtype, device=cuda_device)
    got = minimizers.solve_normal_equations(M, rhs).double().cpu()
    want = minimizers.solve_normal_equations(M.cpu(), rhs.cpu()).double()
    tol = 1e-6 if dtype == torch.float64 else 1e-2
    held = torch.ones(B, dtype=torch.bool)
    if dtype == torch.float32:
        held = _float32_pseudo_solve_defined(M)
        if (n, dtype) in _SYM_EIG_FIRST_CASES:
            held[:40] = True
    assert ((got - want).abs() <= tol * (want.abs() + 1.0))[held].all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", range(1, 17))
def test_sym_eig_batch_independence_on_card(rng, cuda_device, n, dtype):
    """One matrix alone and inside batches of 4 and 64: the same bits, at
    every n, on ``_sym_batch``'s families."""
    from open3d_slam_private_tpu_torch.kernels.sym_eig import sym_eig

    M = _sym_batch(rng, 64, n, dtype).to(cuda_device)
    w, V = sym_eig(M)
    for i in (0, 3, 5, 17, 63, M.shape[0] - 1):
        wi, Vi = sym_eig(M[i:i + 1])
        assert torch.equal(wi[0], w[i]) and torch.equal(Vi[0], V[i])
    w4, V4 = sym_eig(M[:4])
    assert torch.equal(w4, w[:4]) and torch.equal(V4, V[:4])
    tail = M[-4:].contiguous()  # the families' last four, as a batch of 4
    w4, V4 = sym_eig(tail)
    assert torch.equal(w4, w[-4:]) and torch.equal(V4, V[-4:])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_sym_eig_chain_probe_on_card(cuda_device, dtype):
    """The chain probe (the floor the smoke divides by) runs and reads a
    positive time a step and a test."""
    from open3d_slam_private_tpu_torch.kernels.sym_eig import chain_probe

    out = chain_probe(cuda_device, dtype, iters=2000)
    assert out["step"]["cycles"] > 0 and out["step"]["ns"] > 0
    assert out["test"]["cycles"] > 0 and out["test"]["ns"] > 0


@pytest.mark.cuda
def test_sym_eig_kernel_refuses_bad_inputs(cuda_device):
    from open3d_slam_private_tpu_torch.kernels.sym_eig import sym_eig

    for bad in (torch.zeros(2, 17, 17, device=cuda_device, dtype=torch.float64),
                torch.zeros(2, 6, 5, device=cuda_device),
                torch.zeros(2, 6, 6, device=cuda_device, dtype=torch.int32)):
        with pytest.raises(ValueError):
            sym_eig(bad)
    w, V = sym_eig(torch.zeros(0, 6, 6, device=cuda_device))
    assert w.shape == (0, 6) and V.shape == (0, 6, 6)


@pytest.mark.cuda
def test_scratch_growth_inside_capture_raises(rng, cuda_device):
    """A per-device buffer that would have to be made while a CUDA graph is
    being captured raises (a graph holds a buffer by address): the index
    tensor of ``pair_gn.unpack`` (``kernels/pair_gn.py``), the one such
    buffer left, which K3's output goes through. K1 and K2 keep none."""
    args = _pairs_k(rng, 2, 512, 4, cuda_device)
    want = tpg.pair_gn_k(*args)  # made outside the capture: captures fine
    saved = tpg._SYM_ON.pop(cuda_device, None)
    try:
        graph = torch.cuda.CUDAGraph()
        with pytest.raises(RuntimeError, match="scratch would grow inside a CUDA graph capture"):
            with torch.cuda.graph(graph):
                tpg.pair_gn_k(*args)
    finally:
        if saved is not None:
            tpg._SYM_ON[cuda_device] = saved
    torch.cuda.synchronize()
    got = tpg.pair_gn_k(*args)  # the wrapper still works after the refused capture
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


def _nan_fills():
    """NaN-filled float32 tensors that take every free block of the caching
    allocator's small pool (blocks of up to 1 MB, where a kernel wrapper's
    scratch lives): 64 KB tensors, then 512-byte ones, each until the pool
    has to reserve a new segment. Whatever memory a freed buffer left there,
    one of them now holds."""
    fills = []
    for words in (16384, 128):
        reserved = torch.cuda.memory_reserved()
        while torch.cuda.memory_reserved() == reserved:
            fills.append(torch.full((words,), float("nan"), device="cuda"))
    return fills


def _all_nan(fills) -> bool:
    return bool(torch.cat(fills).isnan().all())


@pytest.mark.cuda
def test_captured_pair_gn_survives_larger_calls(rng, cuda_device):
    """A K1 call captured in a CUDA graph at the SLAM step's 1 x 16,384
    replays to its first replay's bits after eager K1 calls at 200 x 512
    and 10 x 65,536 (more problems and more blocks' rows than any other
    test's), with every free block of the allocator's small pool then taken
    by NaN-filled tensors and the graph's output set to NaN before the
    replay; the replay writes nothing into those tensors. (A scratch kept
    per device and replaced by a larger one would leave the graph pointing
    at freed memory; the warm-up runs on the current stream, so such a
    scratch, freed, would return to the pool the NaN tensors draw from.)"""
    args = _pairs(rng, B=1, n=16384, device=cuda_device)
    tpg.pair_gn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = tpg.pair_gn(*args)
    graph.replay()
    torch.cuda.synchronize()
    first = _k1_rows(got).clone()
    assert bool(torch.isfinite(first).all())
    # Both inputs first, so that no allocation between the large calls and
    # the NaN tensors can take a block the calls free.
    big = [_pairs(rng, B=B, n=n, device=cuda_device) for B, n in ((200, 512), (10, 65536))]
    outs = [_k1_rows(tpg.pair_gn(*a)) for a in big]
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(o).all()) for o in outs)
    del big, outs
    fills = _nan_fills()
    for x in got:
        x.fill_(float("nan"))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(_k1_rows(got).view(torch.int32), first.view(torch.int32))
    assert _all_nan(fills)


@pytest.mark.cuda
def test_captured_gather_select_survives_larger_calls(rng, cuda_device):
    """K2 and K4's table entry captured in one CUDA graph at 5,000 queries
    into a 2^12 x 24 table replay to the eager calls' bits after eager calls
    at 400,000 queries into a 2^16 x 48 table (larger scratch, more row
    counts), with every free block of the allocator's small pool then taken
    by NaN-filled tensors and the graph's outputs set to NaN before the
    replay; the replay writes nothing into those tensors. (Row counts or
    scratch kept per device and replaced by larger ones would leave the
    graph pointing at freed memory, which the NaN tensors now hold.)"""
    from open3d_slam_private_tpu_torch.kernels import select as tsel

    cl, h, q, qm = _cell_rows(rng, cuda_device)
    want = [tgs.gather_select(cl.table, h, q, qm), tsel.rank_select_table(cl.table, h, q, qm)]
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = [tgs.gather_select(cl.table, h, q, qm), tsel.rank_select_table(cl.table, h, q, qm)]
    graph.replay()
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    scene = torch.tensor(_scene(rng, n=60000), device=cuda_device)
    big = tcl.build_cell_list(scene, torch.ones(scene.shape[0], dtype=torch.bool, device=cuda_device), 0.5,
                              table_size=1 << 16, list_cap=48)
    bq = scene[torch.randint(0, scene.shape[0], (400000,), device=cuda_device)]
    bm = torch.ones(400000, dtype=torch.bool, device=cuda_device)
    bh = tcl.query_hash(big, bq)
    outs = [tgs.gather_select(big.table, bh, bq, bm), tsel.rank_select_table(big.table, bh, bq, bm)]
    torch.cuda.synchronize()
    assert all(bool((o.view(torch.int32)[:, 3] >= 0).any()) for o in outs)
    del big, bq, bm, bh, outs, scene
    fills = _nan_fills()
    for g in got:
        g.fill_(float("nan"))
    graph.replay()
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    assert _all_nan(fills)


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [24, 48])
@pytest.mark.parametrize("case,by_coords", gsm.CONTRACTS,
                         ids=[f"{c}-{'k4_table' if k4 else 'k2'}" for c, k4 in gsm.CONTRACTS])
def test_grouped_kernels_match_plain_and_model(cuda_device, case, by_coords, cap):
    """K2 (or K4's table entry) on the CPU model's stress inputs
    (``tests/gather_select_model.py`` ``stress_inputs``: one row, distinct
    rows, all masked, an empty row, out-of-range rows in K2's contract,
    rows of 33 and 65 queries, a table of 3,000 rows, 2,345 queries) equals
    its plain version on the card and the model bit for bit, twice."""
    from open3d_slam_private_tpu_torch.kernels import select as tsel

    table, h, q, m = (x.to(cuda_device) for x in gsm.stress_inputs(cap, by_coords)[case])
    kernel = tsel.rank_select_table if by_coords else tgs.gather_select
    plain = tsel.rank_select_table_plain if by_coords else tgs.gather_select_plain
    got = kernel(table, h, q, m).view(torch.int32)
    assert torch.equal(got, plain(table, h, q, m).view(torch.int32))
    model, _, _ = gsm.grouped(*(x.cpu().numpy() for x in (table, h, q, m)), by_coords=by_coords)
    assert np.array_equal(got.cpu().numpy(), model.view(np.int32))
    # The order of queries within a row varies between runs; the bits do not.
    assert torch.equal(kernel(table, h, q, m).view(torch.int32), got)


@pytest.mark.cuda
def test_gather_select_at_the_widest_row(rng, cuda_device):
    """K2 on rows of 437 slots (the widest whose rank block fits on an H100)
    equals its plain version; 438 slots are refused before any pass."""
    _, h, q, qm = _cell_rows(rng, cuda_device)
    wide = torch.rand((16, 437, 8), generator=torch.Generator().manual_seed(5)).to(cuda_device)
    wide.view(torch.int32)[..., 3] = torch.randint(-1, 1 << 20, (16, 437), device=cuda_device)
    hw = (h % 16).contiguous()
    assert torch.equal(tgs.gather_select(wide, hw, q, qm).view(torch.int32),
                       tgs.gather_select_plain(wide, hw, q, qm).view(torch.int32))
    before = tgs.gather_select.launches
    with pytest.raises(RuntimeError, match="wider than"):
        tgs.gather_select(torch.zeros((16, 438, 8), device=cuda_device), hw, q, qm)
    assert tgs.gather_select.launches == before


@pytest.mark.cuda
def test_gather_select_launcher_refuses(cuda_device):
    """The launcher refuses, before any pass, 2^31 queries or more, rows
    wider than its limit and a plan other than its own (null pointers: a
    pass that ran would fault); the wrapper's plan refuses 2^31 queries."""
    from open3d_slam_private_tpu_torch.kernels import _build

    lib = _build.load("gather_select", tgs._LAUNCH_ARGTYPES)
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    plan = tgs.k2_plan(1000, 4096, 48)

    def launch(N, cap=48, words=plan.words, blocks=plan.rank_blocks, smem=plan.block_smem):
        return lib.gather_select_launch(0, 0, 0, 0, N, 4096, cap, 0, words, blocks, smem, 0, 0, stream)

    assert launch(1 << 31) == -3 and launch(-1) == -3 and launch(1000, cap=0) == -3
    assert launch(1000, cap=438) == -2
    assert launch(1000, words=plan.words - 1) == -1 and launch(1000, blocks=plan.rank_blocks + 1) == -1
    assert launch(0, words=tgs.k2_plan(0, 4096, 48).words) == 0  # nothing to do
    torch.cuda.synchronize()
    with pytest.raises(ValueError, match="outside"):
        tgs.k2_plan(1 << 31, 4096, 48)


@pytest.mark.cuda
def test_captured_call_counts_no_launch(rng, cuda_device):
    """A wrapper called while a CUDA graph is captured records a node and
    launches nothing, so its count stays; the graph's replays compute what
    the eager call computes."""
    from open3d_slam_private_tpu_torch.kernels.sym_eig import sym_eig

    M = _sym_mats(rng, 8, 12, torch.float64).to(cuda_device)
    want, _ = sym_eig(M)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        sym_eig(M)
    torch.cuda.current_stream().wait_stream(side)
    before = sym_eig.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        w, _ = sym_eig(M)
    assert sym_eig.launches == before
    w.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert sym_eig.launches == before and torch.equal(w, want)


def _rt_scene(n=20000, seed=0):
    """``tests/test_realtime.py``'s ``synth_scene`` in numpy (no JAX here)."""
    g = np.random.default_rng(seed)
    half = n // 2
    floor = np.c_[g.uniform(-30, 30, (half, 2)), g.normal(0, 0.02, (half, 1))]
    walls = []
    for i in range(6):
        m = (n - half) // 6
        ang, d = 2 * np.pi * i / 6, g.uniform(8, 20)
        u = np.array([np.cos(ang), np.sin(ang)])
        t, h = g.uniform(-8, 8, (m, 1)), g.uniform(0, 4, (m, 1))
        walls.append(np.c_[d * u[None, :] + t * np.array([[-u[1], u[0]]]), h])
    return np.vstack([floor] + walls).astype(np.float32)


def _rt_scan(scene, pose, n, seed):
    """``tests/test_realtime.py``'s ``sample``: ``n`` visible points seen
    from ``pose`` with 1 cm noise."""
    g = np.random.default_rng(seed)
    local = (np.linalg.inv(pose) @ np.c_[scene, np.ones(len(scene))].T).T[:, :3]
    r = np.linalg.norm(local, axis=1)
    vis = np.flatnonzero((r < 30) & (r > 1))
    sel = g.choice(vis, size=n, replace=len(vis) < n)
    return tpc.from_points((local[sel] + g.normal(size=(n, 3)) * 0.01).astype(np.float32), capacity=n)


def _rt_setup():
    """``tests/test_realtime.py``'s ``small_cfg`` with the mapper on the fused
    path (as in production) and a 1 m creation radius, and an out-and-back
    drive of 16 scans of 1,024 points."""
    from open3d_slam_private_tpu_torch.models import icp as icp_mod
    from open3d_slam_private_tpu_torch.slam import pipeline as tpipe
    from open3d_slam_private_tpu_torch.slam.odometry import OdometryConfig
    from open3d_slam_private_tpu_torch.slam.submap_collection import SubmapCollectionConfig

    icp_map = icp_mod.ICPConfig(knn=1, max_match_dist=1.0, matcher="grid", grid_table_size=1 << 12,
                                grid_bucket_cap=48, trimmed_ratio=0.85, max_iterations=8,
                                coarse_iterations=4, coarse_stride=4, candidate_refresh_every=6,
                                fast_trimming=True, fused_kernel=True)
    odo = OdometryConfig(voxel_size=0.3, max_range=30.0, max_points=2048)
    odo = dataclasses.replace(odo, icp=dataclasses.replace(odo.icp, grid_table_size=1 << 11))
    cfg = tpipe.SlamConfig(
        odometry=odo,
        mapper=dataclasses.replace(MapperConfig(), icp=icp_map, scan_voxel_size=0.2, scan_capacity=2048,
                                   submap_capacity=1 << 13, min_movement_for_insertion=0.05),
        submaps=SubmapCollectionConfig(submap_capacity=1 << 13, creation_radius=1.0,
                                       activation_radius=1.5, min_scans_before_switch=2),
        use_imu_attitude_init=False, loop_closure_enabled=False)
    scene = _rt_scene()
    T = np.eye(4)
    T[:3, 3] = [2.0, 0.0, 1.0]
    step = se3.exp_se3(torch.tensor([0, 0, 0, 0.3, 0, 0], dtype=torch.float64)).numpy()
    scans = []
    for i in range(16):
        scans.append(_rt_scan(scene, T, 1024, 100 + i))
        T = T @ (step if i < 8 else np.linalg.inv(step))
    return cfg, scans


@pytest.mark.cuda
def test_realtime_graph_replay_matches_eager_rt_step(cuda_device):
    """``RealtimePipeline`` on the card replays its captured step graph; each
    replay's stats row equals, bit for bit, the eager (early-exit)
    ``rt_step`` from the same state on the card. An out-and-back drive with
    a 1 m creation radius runs the seeding graph and a re-activation (a
    stored bank copied into the graphs' live bank) between replays. The
    config is ``tests/test_realtime.py``'s ``small_cfg`` with the mapper on
    the fused path, as in production."""
    from open3d_slam_private_tpu_torch.slam import realtime as trt

    cfg, scans = _rt_setup()
    pipe = trt.RealtimePipeline(cfg, poll_every=1, device=cuda_device)
    pipe.process_scan(scans[0], 0.0)
    assert pipe._graphs is not None
    active = [pipe.submaps.active_idx]
    for k in range(1, len(scans)):
        before = trt.tree_map(torch.clone, pipe._state)
        replays = pipe.graph_replays
        pipe.process_scan(scans[k], 0.1 * k)  # replays; polled at once (poll_every=1)
        assert pipe.graph_replays > replays
        _, eager = trt.rt_step(before, scans[k].to(cuda_device), torch.tensor(0.1, device=cuda_device),
                               torch.eye(4, device=cuda_device), pipe.cfg, rebuild_branch=False)
        assert np.array_equal(pipe.frames[k].stats, eager.cpu().numpy()), k
        active.append(pipe.submaps.active_idx)
    pipe.finish()
    assert np.isfinite(pipe.trajectory()).all()
    left = {a for a, b in zip(active, active[1:]) if a != b}
    assert len(pipe.submaps) >= 3
    assert any(i in left and i < active[k - 1] for k, i in enumerate(active) if k), active


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["packed", "chunk"])
def test_realtime_graph_modes_match_eager(cuda_device, mode):
    """The packed upload and the 4-scan chunk on the card: the step graph's
    stats rows equal the eager ``rt_step_packed`` / ``rt_step_chunk`` from
    the same state, bit for bit."""
    from open3d_slam_private_tpu_torch.slam import realtime as trt

    cfg, scans = _rt_setup()
    dev = cuda_device
    eye = torch.eye(4, device=dev)
    if mode == "packed":
        pipe = trt.RealtimePipeline(cfg, poll_every=1, h2d_mode="packed", device=dev)
    else:
        pipe = trt.RealtimePipeline(cfg, poll_every=4, chunk_size=4, device=dev)
    pipe.process_scan(scans[0], 0.0)
    checked = 0
    for k in range(1, len(scans)):
        if mode == "packed" or k % 4 == 1:
            before = trt.tree_map(torch.clone, pipe._state)
        pipe.process_scan(scans[k], 0.1 * k)
        if mode == "packed":
            packed, header = trt.pack_scan_u16(scans[k].xyz.numpy(), scans[k].mask.numpy(), None)
            _, eager = trt.rt_step_packed(before, trt.packed_tensor(packed, dev), torch.from_numpy(header).to(dev),
                                          torch.tensor(0.1, device=dev), eye, pipe.cfg, has_times=False,
                                          rebuild_branch=False)
            assert np.array_equal(pipe.frames[k].stats, eager.cpu().numpy()), k
            checked += 1
        elif k % 4 == 0:
            chunk = tpc.stack([s.to(dev) for s in scans[k - 3:k + 1]])
            _, eager = trt.rt_step_chunk(before, chunk, torch.full((4,), 0.1, device=dev), eye.expand(4, 4, 4),
                                         pipe.cfg, rebuild_branch=False)
            got = np.stack([pipe.frames[j].stats for j in range(k - 3, k + 1)])
            assert np.array_equal(got, eager.cpu().numpy()), k
            checked += 4
    pipe.finish()
    assert checked >= 12 and np.isfinite(pipe.trajectory()).all()


def _large_fused_calls(rng, dev):
    """K1 on the fused path where a shared scratch would have grown: an
    ``icp_batch`` of 8 readings of 65,536 points (more partial rows than
    16,384 words) and a ``register_hypotheses`` of 300 seeds (more problems
    than 64, and than any other test's; ``register_batch`` runs each
    problem alone, so neither shape reaches K1 through it). Returns NaN-filled tensors that hold every free
    block of the allocator's small pool after them (the caller keeps them
    alive)."""
    scene = _scene(rng, n=65536)
    cfg = ticp.ICPConfig(knn=1, max_match_dist=0.5, matcher="grid", grid_table_size=1 << 14,
                         grid_bucket_cap=32, trimmed_ratio=0.9, fast_trimming=True, max_iterations=4,
                         candidate_refresh_every=2, fused_kernel=True)
    ref_b = tpc.from_points(scene, capacity=65536, device=dev)
    g = tgh.build_grid(ref_b.padded_xyz(), ref_b.mask, 2.0, 1 << 12, 32)
    ref_b = tnm.estimate_normals_moments(ref_b, g, max_dist=1.0, orient_towards=torch.zeros(3, device=dev))
    readings = tpc.stack([tpc.from_points(scene + 0.003 * (k + 1), device=dev) for k in range(8)])
    before = tpg.pair_gn.launches
    ticp.icp_batch(readings, ticp.build_reference(ref_b, cfg), torch.eye(4, device=dev).expand(8, 4, 4), cfg)
    reading = tpc.from_points(torch.tensor(scene[1::64][:1024], device=dev) + 0.003, device=dev)
    twists = np.c_[rng.uniform(-0.05, 0.05, (300, 3)), rng.uniform(-0.5, 0.5, (300, 3))]
    seeds = se3.exp_se3(torch.tensor(twists, dtype=torch.float32)).to(dev)
    ticp.register_hypotheses(reading, ref_b, seeds, cfg)
    torch.cuda.synchronize()
    assert tpg.pair_gn.launches > before
    return _nan_fills()


@pytest.mark.cuda
def test_realtime_poses_survive_large_fused_calls(rng, cuda_device):
    """``RealtimePipeline``'s poses and stats rows equal, bit for bit, a run
    of the same scans in which K1 runs eagerly at 8 x 65,536 and at 300
    problems on the fused path between scans, after which NaN-filled
    tensors take every free block of the allocator's small pool and are
    held through the later scans untouched: the step graph holds no buffer
    that such calls replace. (One K1 call on the current stream comes
    first: a scratch kept per device, as an earlier version kept, would be
    allocated there rather than on the capture's warm-up stream, so that,
    freed, it returns to the pool the NaN tensors draw from.)"""
    from open3d_slam_private_tpu_torch.slam import realtime as trt

    cfg, scans = _rt_setup()
    tpg.pair_gn(*_pairs(rng, B=1, n=1024, device=cuda_device))

    def run(interrupt):
        pipe = trt.RealtimePipeline(cfg, poll_every=1, device=cuda_device)
        held = []
        for k, scan in enumerate(scans):
            pipe.process_scan(scan, 0.1 * k)
            if interrupt and k == 5:
                held = _large_fused_calls(rng, cuda_device)
        pipe.finish()
        assert not held or _all_nan(held)
        return np.stack(pipe.trajectory()), [f.stats for f in pipe.frames]

    poses, stats = run(False)
    poses2, stats2 = run(True)
    assert np.isfinite(poses).all() and len(stats) == len(stats2) == len(scans)
    assert np.array_equal(poses.view(np.uint8), poses2.view(np.uint8))
    assert all((a is None and b is None) or np.array_equal(a.view(np.uint8), b.view(np.uint8))
               for a, b in zip(stats, stats2))


@pytest.mark.cuda
def test_threefry_on_the_card_matches_the_cpu(cuda_device):
    """JAX's threefry words and the RANSAC draw: bit-equal on the card and
    on the CPU (chunked over rows on the card)."""
    from open3d_slam_private_tpu_torch.ops import prng

    for seed in (0, 7, 2 ** 32 - 1):
        cpu = prng.bits(seed, (3, 1000, 33))
        assert torch.equal(prng.bits(seed, (3, 1000, 33), device=cuda_device, chunk=4099).cpu(), cpu)
    mask = torch.rand(16384, generator=torch.Generator().manual_seed(0)) < 0.3
    cpu = prng.masked_categorical(0, mask, 1024, 3)
    assert torch.equal(prng.masked_categorical(0, mask.to(cuda_device), 1024, 3, chunk_rows=96).cpu(), cpu)


def _loop_pose_graph(n=128, loops=24, seed=0):
    """A drifting loop of ``n`` nodes with ``loops`` loop closures."""
    from open3d_slam_private_tpu_torch.slam import pose_graph as tpgr

    rng = np.random.default_rng(seed)
    step = se3.exp_se3(torch.tensor([0, 0, 2 * np.pi / n, 0.4, 0, 0], dtype=torch.float32)).double().numpy()
    drift = se3.exp_se3(torch.tensor([0, 0, 0.02, 0.02, 0, 0], dtype=torch.float32)).double().numpy()
    gt = [np.eye(4)]
    for _ in range(1, n):
        gt.append(gt[-1] @ step)
    b = tpgr.PoseGraphBuilder(n, 512)
    est = np.eye(4)
    b.add_node(est)
    for i in range(1, n):
        est = est @ step @ drift
        b.add_node(est)
        b.add_edge(i - 1, i, step @ drift)
    for _ in range(loops):
        i = int(rng.integers(0, n // 2))
        j = (i + n // 2) % n
        b.add_edge(i, j, np.linalg.inv(gt[i]) @ gt[j], info=np.eye(6) * 10.0, is_loop=True)
    return b


@pytest.mark.cuda
def test_pose_graph_on_the_card_is_reproducible(cuda_device):
    """The default config's solver at the production capacity (128 nodes,
    pcg): two solves on the card give the same bits, within 1e-4 m of the
    CPU's."""
    from open3d_slam_private_tpu_torch.slam import pose_graph as tpgr

    b = _loop_pose_graph()
    cfg = tpgr.PoseGraphConfig()
    stats = {}
    runs = [tpgr.optimize(b.build(cuda_device), cfg, stats=stats).poses for _ in range(2)]
    cpu = tpgr.optimize(b.build("cpu"), cfg).poses
    assert stats["cg_iterations"] and torch.equal(runs[0], runs[1])
    assert (runs[0][:, :3, 3].cpu() - cpu[:, :3, 3]).abs().max() < 1e-4
    assert float(tpgr.chi2(tpgr.PoseGraph(**{**b.build("cpu").__dict__, "poses": cpu}))) \
        < float(tpgr.chi2(b.build("cpu")))


@pytest.mark.cuda
def test_default_slam_pipeline_constructs_on_the_card(cuda_device):
    from open3d_slam_private_tpu_torch.slam.pipeline import SlamConfig, SlamPipeline

    pipe = SlamPipeline(SlamConfig(), device=cuda_device)
    assert pipe.cfg.loop_closure_enabled and pipe.submaps.device.type == "cuda"
