"""The generator: the same seed gives the same inputs, another seed other
ones; the trajectory closes; the motion sizes are the same in every seed;
a LiDAR sweep's points lie on the hall, at the sensor's ray angles."""

import numpy as np
import pytest
import torch

from portbench import scene, spec

CONFIG = {"points": 256, "sampling": "grid",
          "motion": {"rot_max_rad": 0.02, "trans_max_mm": 14.0}}
SEED = 2 ** 31 + 12345  # past 32 signed bits, as the driver's seeds are


def _increments(pool):
    P = len(pool["R"])
    return [scene.pair_truth(pool, i, (i + 1) % P) for i in range(P)]


@pytest.mark.parametrize("sampling", ["grid", "uniform"])
def test_pool_repeats_per_seed_and_differs_across_seeds(sampling):
    config = dict(CONFIG, sampling=sampling)
    a = scene.make_pool(SEED, config, 8, "cpu")
    b = scene.make_pool(SEED, config, 8, "cpu")
    c = scene.make_pool(SEED + 1, config, 8, "cpu")
    assert torch.equal(a["frames"], b["frames"])
    assert not torch.equal(a["frames"], c["frames"])
    assert a["frames"].shape == (8, 256, 8) and a["frames"][0].is_contiguous()


def test_trajectory_closes_and_keeps_sizes_in_range():
    pool = scene.make_pool(SEED, CONFIG, 8, "cpu")
    for R, t in _increments(pool):
        angle = np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1))
        assert angle <= 0.02 + 1e-9 and np.linalg.norm(t) <= 14.0 + 1e-9
    # Frame P would be frame 0: the last pair undoes the first.
    R0, t0 = _increments(pool)[0]
    Rl, tl = _increments(pool)[-1]
    np.testing.assert_allclose(Rl @ R0, np.eye(3), atol=1e-12)


def test_every_seed_draws_the_same_motion_sizes():
    def sizes(seed):
        incs = _increments(scene.make_pool(seed, CONFIG, 8, "cpu"))
        return sorted(round(float(np.linalg.norm(t)), 9) for _, t in incs)

    assert sizes(1) == sizes(2)


def test_frames_lie_on_the_surface_in_their_own_coordinates():
    pool = scene.make_pool(SEED, CONFIG, 4, "cpu")
    R, t = pool["R"][2], pool["t"][2]
    world = pool["frames"][2][:, :3].double().numpy() @ R.T + t
    z = 1500 + 80 * np.sin(world[:, 0] / 90) + 60 * np.cos(world[:, 1] / 70)
    np.testing.assert_allclose(world[:, 2], z, atol=1e-3)


def test_the_runs_seed_picks_the_first_call_of_the_cycle():
    from portbench.drive import call_pairs, first_call

    traffic = {"pool_frames": 64, "batch": 16}
    starts = {first_call(traffic, s) for s in range(SEED, SEED + 40)}
    assert starts == {0, 1, 2, 3}
    assert call_pairs(traffic, 5)[0] == (16, 17) and call_pairs(traffic, 3)[-1] == (63, 0)


def _lidar(beams=16, columns=64):
    config = spec.cell("lidar.stream")["config"]
    config["sensor"].update(beams=beams, columns=columns)
    config["points"] = beams * columns
    return config


def test_lidar_sweep_repeats_per_seed_and_differs_across_seeds():
    a = scene.make_pool(SEED, _lidar(), 4, "cpu")["frames"]
    assert torch.equal(a, scene.make_pool(SEED, _lidar(), 4, "cpu")["frames"])
    assert not torch.equal(a, scene.make_pool(SEED + 1, _lidar(), 4, "cpu")["frames"])
    assert a.shape == (4, 1024, 8) and a[1].is_contiguous()


@pytest.mark.parametrize("noise", [0.0, 10.0])
def test_lidar_points_lie_on_the_hall_at_the_sensors_ray_angles(noise):
    config = _lidar()
    config["sensor"]["range_noise_mm"] = noise
    hall = config["scene"]
    pool = scene.make_pool(SEED, config, 4, "cpu")
    p = pool["frames"][3][:, :3].double().numpy()
    # Elevation angles: the beams', evenly over the field of view.
    el = np.degrees(np.arcsin(p[:, 2] / np.linalg.norm(p, axis=1)))
    beams = np.linspace(22.5, -22.5, 16)
    assert np.abs(el[:, None] - beams[None, :]).min(axis=1).max() < 1e-3
    # Each point, in the hall's frame, lies on a wall, the floor, the
    # ceiling or a pillar.
    w = p @ pool["R"][3].T + pool["t"][3]
    X, Y = hall["half_extent_mm"]
    gap = np.minimum.reduce([np.abs(np.abs(w[:, 0]) - X), np.abs(np.abs(w[:, 1]) - Y),
                             np.abs(w[:, 2] - hall["floor_mm"]),
                             np.abs(w[:, 2] - hall["ceiling_mm"])] + [
        np.abs(np.hypot(w[:, 0] - cx, w[:, 1] - cy) - hall["pillar_radius_mm"])
        for cx, cy in hall["pillars_mm"]])
    if noise:  # off the hall along the ray by the range noise
        config["sensor"]["range_noise_mm"] = 0.0
        clean = scene.make_pool(SEED, config, 4, "cpu")["frames"][3][:, :3].double().numpy()
        dr = np.linalg.norm(p, axis=1) - np.linalg.norm(clean, axis=1)
        assert abs(dr.std() - noise) < 0.1 * noise and abs(dr.mean()) < 0.2 * noise
    else:
        assert gap.max() < 0.05
        assert np.all(np.abs(w[:, :2]) <= [X + 0.05, Y + 0.05])
