"""K4 (rank + select on rows gathered beforehand): the port's plain version
against the Pallas kernel ``rank_select_rows`` in interpret mode, on the
CPU. Ids equal, the selected payload bit-equal, d2 within 1e-6 relative
(the Pallas kernel sums the three squares on the MXU), occupancy exact."""

import jax.numpy as jnp
import numpy as np
import torch

from open3d_slam_private_tpu.kernels import select_pallas as jsel
from open3d_slam_private_tpu.ops import cell_list as jcl
from open3d_slam_private_tpu.ops import grid_hash as jgh
from open3d_slam_private_tpu.ops import pointcloud as jpc
from open3d_slam_private_tpu_torch import interop
from open3d_slam_private_tpu_torch.kernels import gather_select as tgs
from open3d_slam_private_tpu_torch.kernels import select as tsel


def _rows(rng, n_q=1200):
    n = 5000
    floor = np.c_[rng.uniform(-8, 8, (n // 2, 2)), 0.01 * rng.normal(size=(n // 2, 1))]
    wall = np.c_[np.full((n // 2, 1), 5.0), rng.uniform(-8, 8, (n // 2, 1)), rng.uniform(0, 3, (n // 2, 1))]
    scene = (np.vstack([floor, wall]) + 0.004 * rng.normal(size=(n, 3))).astype(np.float32)
    ref = jpc.from_points(scene, capacity=8192)
    nrm = rng.normal(size=(8192, 3)).astype(np.float32)
    cl = jcl.build_cell_list(ref.padded_xyz(), ref.mask, 0.5, table_size=1 << 12, list_cap=24,
                             normals=jnp.asarray(nrm))
    q = (scene[:n_q] + 0.05 * rng.normal(size=(n_q, 3))).astype(np.float32)
    q[-100:] = rng.uniform(-20, 20, size=(100, 3))  # rows that are mostly empty
    mask = rng.uniform(size=n_q) > 0.05
    h = np.asarray(jgh._cell_hash(jnp.floor(jnp.asarray(q) / cl.cell_size).astype(jnp.int32), cl.table_size))
    rows = np.asarray(cl.table).reshape(cl.table.shape[0], -1)[h]
    return cl, rows, q, mask, h


def test_rank_select_plain_matches_pallas(rng):
    _, rows, q, mask, _ = _rows(rng)
    want = np.asarray(jsel.rank_select_rows(jnp.asarray(rows), jnp.asarray(q), jnp.asarray(mask),
                                            interpret=True))
    got = tsel.rank_select_rows(torch.tensor(rows), torch.tensor(q), torch.tensor(mask)).numpy()
    np.testing.assert_array_equal(got[:, 3].view(np.int32), want[:, 3].view(np.int32))
    np.testing.assert_array_equal(got[:, :3].view(np.int32), want[:, :3].view(np.int32))
    np.testing.assert_array_equal(got[:, 4:7].view(np.int32), want[:, 4:7].view(np.int32))
    np.testing.assert_allclose(got[:, 7], want[:, 7], rtol=1e-6)
    np.testing.assert_array_equal(got[:, 8], want[:, 8])  # occupancy
    np.testing.assert_array_equal(got[:, 9:], 0.0)
    empty = got[:, 8] == 0
    assert empty.any() and np.isfinite(got[empty & mask, 7]).all()  # K4: empty rows stay finite
    assert np.isinf(got[~mask, 7]).all()


def test_rank_select_selection_equals_gather_select(rng):
    """Through ``match_result_from_selected`` K4's winners are K2's: the
    same correspondences on the same rows, bit for bit."""
    cl, rows, q, mask, h = _rows(rng)
    table = interop.tensor(cl.table)
    k4 = tsel.rank_select_rows(torch.tensor(rows), torch.tensor(q), torch.tensor(mask))
    k2 = tgs.gather_select(table, torch.tensor(h), torch.tensor(q), torch.tensor(mask))
    a = tsel.match_result_from_selected(k4, torch.tensor(mask), 0.25)
    b = tgs.match_result_from_selected(k2, torch.tensor(mask), 0.25)
    for f in ("ids", "dists", "xyz", "normals"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert torch.equal(k4[:, 8], k2[:, 8])


def test_rank_select_table_plain_matches_pallas(rng):
    """K4's table entry, the rows read in place on the card: its plain
    version against the Pallas kernel on the rows ``table_flat[h]`` that
    JAX's select leg gathers (``open3d_slam_private_tpu/models/icp.py``),
    in interpret mode. The whole output row bit for bit, including the
    queries whose row holds only padding (finite distance, occupancy 0) and
    the masked queries (inf)."""
    cl, rows, q, mask, h = _rows(rng)
    want = np.asarray(jsel.rank_select_rows(jnp.asarray(np.asarray(cl.table).reshape(cl.table.shape[0], -1)[h]),
                                            jnp.asarray(q), jnp.asarray(mask), interpret=True))
    table = interop.tensor(cl.table)
    got = tsel.rank_select_table(table, torch.tensor(h), torch.tensor(q), torch.tensor(mask)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    empty = got[:, 8] == 0
    assert (empty & mask).any() and np.isfinite(got[empty & mask, 7]).all()
    assert (~mask).any() and np.isinf(got[~mask, 7]).all()
    assert np.array_equal(got.view(np.int32), tsel.rank_select_rows(
        torch.tensor(rows), torch.tensor(q), torch.tensor(mask)).numpy().view(np.int32))
