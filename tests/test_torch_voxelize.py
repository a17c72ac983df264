"""Port parity: on-device voxelization and the mean VFE (efg_tpu_torch vs
efg_tpu) on the same numpy point clouds."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from efg_tpu.modeling.readers import voxel_reader as JR
from efg_tpu.ops import voxelize as JV
from efg_tpu_torch.modeling.readers import voxel_reader as TR
from efg_tpu_torch.ops import voxelize as TV

# one intra-op thread: the workers of the parallel test run share the cores,
# which torch's thread pool in each of them would oversubscribe
torch.set_num_threads(1)

PC_RANGE = (-6.4, -6.4, -2.0, 6.4, 6.4, 4.0)
VOXEL = (0.1, 0.1, 0.15)


def _cloud(seed, n=3000, spread=7.0):
    """Points partly outside the range, many sharing voxels."""
    rs = np.random.RandomState(seed)
    xyz = rs.uniform(-spread, spread, (n, 3)).astype(np.float32)
    xyz[: n // 3] = np.round(xyz[: n // 3] * 2) / 2  # dense clumps
    pts = np.concatenate([xyz, rs.uniform(0, 1, (n, 2)).astype(np.float32)], -1)
    mask = rs.uniform(size=n) > 0.1
    return pts, mask


# max_voxels 4096 holds every occupied voxel; 256 exercises first-come truncation
@pytest.mark.parametrize("max_voxels", [4096, 256])
def test_voxelize_matches_jax(max_voxels):
    pts, mask = _cloud(0)
    want = JV.voxelize(jnp.asarray(pts), jnp.asarray(mask), pc_range=PC_RANGE,
                       voxel_size=VOXEL, max_voxels=max_voxels)
    got = TV.voxelize(torch.from_numpy(pts), torch.from_numpy(mask), pc_range=PC_RANGE,
                      voxel_size=VOXEL, max_voxels=max_voxels)
    # integer structures: exact
    for name in ("point_slot", "coords", "valid", "counts", "num_voxels"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    if max_voxels == 256:
        assert int(got.num_voxels) == 256 and (got.point_slot.numpy() == -1).sum() > mask.sum() // 4

    # f32 segment means: sums run in another order, so 1e-6
    fm = TV.voxel_mean(torch.from_numpy(pts), got.point_slot, got.counts, max_voxels)
    fj = JV.voxel_mean(jnp.asarray(pts), want.point_slot, want.counts, max_voxels)
    np.testing.assert_allclose(fm.numpy(), np.asarray(fj), rtol=1e-6, atol=1e-6)


def test_dynamic_mean_vfe_matches_jax():
    clouds = [_cloud(s) for s in (1, 2)]
    pts = np.stack([c[0] for c in clouds])
    mask = np.stack([c[1] for c in clouds])
    kw = dict(pc_range=PC_RANGE, voxel_size=VOXEL, max_voxels=2048, num_input_features=5)
    fj, cj, vj = JR.dynamic_mean_vfe(jnp.asarray(pts), jnp.asarray(mask), **kw)
    ft, ct, vt = TR.dynamic_mean_vfe(torch.from_numpy(pts), torch.from_numpy(mask), **kw)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-6, atol=1e-6)
