"""The port's point-cloud ops (hamer_yolo_tpu_torch/ops/pointnet.py) against
the JAX package's (hamer_yolo_tpu/ops/pointnet.py) on the same numpy-made
clouds: FPS, ball-query and three_nn indices exactly equal, distances and
grouped or interpolated values within 1e-6."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hamer_yolo_tpu.ops import pointnet as J
from hamer_yolo_tpu_torch.ops import pointnet as T

torch.set_num_threads(1)


def cloud(seed, B=2, N=256, dup=16):
    """(B, N, 3) points in [-1, 1]; the last ``dup`` repeat earlier ones, so
    equal distances (ties) occur."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    xyz[:, N - dup:] = xyz[:, :dup]
    return xyz


def test_furthest_point_sampling_exact():
    xyz = cloud(0)
    got = T.furthest_point_sampling(torch.from_numpy(xyz), 64).numpy()
    ref = np.asarray(J.furthest_point_sampling(jnp.asarray(xyz), 64))
    assert got[:, 0].tolist() == [0, 0]
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("radius,nsample", [(0.1, 64), (0.2, 64), (0.4, 64), (0.8, 16)])
def test_ball_query_exact(radius, nsample):
    """DESA's radii with 64 samples, and a ball holding more points than
    slots (the first nsample in index order). Centers: the cloud's first 24
    points (never empty) and 8 far away (empty balls: all zeros)."""
    xyz = cloud(1)
    far = np.full((2, 8, 3), 5.0, np.float32)
    centers = np.concatenate([xyz[:, :24], far], axis=1)
    got = T.ball_query(torch.from_numpy(centers), torch.from_numpy(xyz), radius, nsample).numpy()
    ref = np.asarray(J.ball_query(jnp.asarray(centers), jnp.asarray(xyz), radius, nsample))
    np.testing.assert_array_equal(got, ref)
    assert (got[:, 24:] == 0).all()
    filled = (got[:, :24] != got[:, :24, :1]).any(-1).mean()
    assert filled > 0.5  # most balls hold more than one point


@pytest.mark.parametrize("radius", [0.1, 0.2, 0.4])
def test_ball_query_radius_boundary(radius):
    """Points on a shell within a few ulps of the radius: in or out exactly
    as JAX decides, which squares the radius in f32 and compares strictly."""
    rng = np.random.default_rng(int(radius * 10))
    u = rng.normal(size=(1, 4000, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    xyz = (u * radius * (1 + 1e-6 * rng.uniform(-1, 1, (1, 4000, 1)))).astype(np.float32)
    xyz[0, :8] = np.float32(radius) * np.eye(3, dtype=np.float32)[[0, 1, 2, 0, 1, 2, 0, 1]]
    center = np.zeros((1, 1, 3), np.float32)
    got = T.ball_query(torch.from_numpy(center), torch.from_numpy(xyz), radius, 4000).numpy()
    ref = np.asarray(J.ball_query(jnp.asarray(center), jnp.asarray(xyz), radius, 4000))
    np.testing.assert_array_equal(got, ref)
    inside = len(np.unique(got))
    assert 100 < inside < 3900  # the shell straddles the radius


def test_gather_and_group_points():
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(2, 50, 7)).astype(np.float32)
    idx = rng.integers(0, 50, (2, 9, 5)).astype(np.int32)
    got = T.group_points(torch.from_numpy(pts), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, np.asarray(J.group_points(jnp.asarray(pts),
                                                                 jnp.asarray(idx))))
    got = T.gather_points(torch.from_numpy(pts), torch.from_numpy(idx[:, :, 0])).numpy()
    np.testing.assert_array_equal(got, np.asarray(J.gather_points(jnp.asarray(pts),
                                                                  jnp.asarray(idx[:, :, 0]))))


def test_three_nn_exact_with_ties():
    """Duplicated known points tie exactly: the lower index comes first, as
    in lax.top_k."""
    known = cloud(3, N=128, dup=32)
    unknown = np.concatenate([cloud(4, N=64, dup=0), known[:, :8]], axis=1)
    d, i = T.three_nn(torch.from_numpy(unknown), torch.from_numpy(known))
    rd, ri = J.three_nn(jnp.asarray(unknown), jnp.asarray(known))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_allclose(d.numpy(), np.asarray(rd), rtol=1e-6, atol=1e-6)
    assert (i.numpy()[:, 64:, 0] == np.arange(8)).all()
    d2, i2 = T.three_nn_sq(torch.from_numpy(unknown), torch.from_numpy(known))
    rd2, ri2 = J.three_nn_sq(jnp.asarray(unknown), jnp.asarray(known))
    np.testing.assert_array_equal(i2.numpy(), np.asarray(ri2))
    np.testing.assert_allclose(d2.numpy(), np.asarray(rd2), rtol=1e-6, atol=1e-7)


def test_three_interpolate_and_weights():
    rng = np.random.default_rng(5)
    known, unknown = cloud(5, N=96, dup=0), cloud(6, N=40, dup=0)
    feats = rng.normal(size=(2, 96, 6)).astype(np.float32)
    d, i = T.three_nn(torch.from_numpy(unknown), torch.from_numpy(known))
    w = T.interpolation_weights(d)
    rd, ri = J.three_nn(jnp.asarray(unknown), jnp.asarray(known))
    rw = J.interpolation_weights(rd)
    np.testing.assert_allclose(w.numpy(), np.asarray(rw), rtol=1e-6, atol=1e-6)
    got = T.three_interpolate(torch.from_numpy(feats), i, w).numpy()
    ref = np.asarray(J.three_interpolate(jnp.asarray(feats), ri, rw))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("use_xyz", [True, False])
def test_query_and_group(use_xyz):
    rng = np.random.default_rng(7)
    xyz = cloud(7)
    feats = rng.normal(size=(2, 256, 5)).astype(np.float32)
    centers = xyz[:, ::16] + 0.01
    got = T.query_and_group(torch.from_numpy(xyz), torch.from_numpy(centers),
                            torch.from_numpy(feats), 0.3, 32, use_xyz).numpy()
    ref = np.asarray(J.query_and_group(jnp.asarray(xyz), jnp.asarray(centers),
                                       jnp.asarray(feats), 0.3, 32, use_xyz))
    assert got.shape == (2, 16, 32, 8 if use_xyz else 5)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
