"""The traffic generator: the frozen renderer against the program's, and a
lap that closes exactly."""

import numpy as np
import torch

from slambench import spec
from slambench.traffic import drive
from slambench.traffic import world as W


def test_frozen_renderer_equals_the_programs():
    from stereoslam_tpu_torch.utils import world as program_world

    scene = W.make_city_circuit(90.0, 50.0, street_half=5.0, seed=1, corner_radius=14.0)
    ours = program_world.make_city_circuit(90.0, 50.0, street_half=5.0, seed=1, corner_radius=14.0)
    for a, b in zip(scene.quads, ours.quads):
        np.testing.assert_array_equal(a, b)
    T = torch.as_tensor(drive.lap_poses(spec.config("fleet-b8")["world"])[[0, 57]]
                        .astype(np.float32))
    keys = W.prng_keys([5, 6])
    args = (T, scene.quads, 40.0, 40.0, 24.0, 12.0, 24, 48)
    a = W.render_frames(*args, cam_offset_x=0.54, noise_keys=keys)
    b = program_world.render_frames(*args, cam_offset_x=0.54, noise_keys=keys)
    assert torch.equal(a, b)


def test_lap_closes_exactly():
    from stereoslam_tpu_torch.utils.world import frames_per_lap

    for world in (spec.config("fleet-b8")["world"],
                  dict(spec.config("fleet-b8")["world"], step=0.55, corner_slow=0.7)):
        s = drive.lap_arc(world)
        step, n = drive.closing_step(world)
        assert n == len(s) == frames_per_lap(world["step"], world["length"], world["width"],
                                             world["corner_radius"], world["corner_slow"],
                                             world["slow_ramp"])
        assert abs(step - world["step"]) < 0.01 * world["step"]
        end = drive._walk(step, n, world)[-1]
        assert abs(end - drive.perimeter(world)) < 1e-6
        T = drive.lap_poses(world)
        pos, head = W._rounded_rect_pose(np.array([end]), world["length"], world["width"],
                                         world["corner_radius"])
        np.testing.assert_allclose(pos[0], T[0, [0, 2], 3], atol=1e-6)
        np.testing.assert_allclose(head[0], [T[0, 0, 2], T[0, 2, 2]], atol=1e-6)
        assert np.all(np.diff(s) > 0.3 * world["step"])


def test_the_lap_is_a_fixed_recording():
    from stereoslam_tpu_torch.utils.world import generate_world_sequence

    cam = dict(height=24, width=40, fx=32.0, fy=32.0, cx=20.0, cy=12.0, baseline=0.54)
    world = dict(spec.config("fleet-b8")["world"], step=8.0)
    a = drive.render_lap(cam, world, "cpu")
    b = drive.render_lap(cam, world, "cpu")
    c = drive.render_lap(cam, dict(world, noise_seed=2), "cpu")
    assert torch.equal(a.frames, b.frames)
    np.testing.assert_array_equal(a.T_cw, c.T_cw)
    diff = (a.frames.int() - c.frames.int()).abs()
    assert 0 < diff.float().mean() < 4.0  # sensor noise of sigma 1.5 grey levels
    assert a.frames.dtype == torch.uint8 and a.frames.shape[1] == 2
    # The canonical world's noise draw: frame 0 (pose 0 in both) is its frame 0.
    seq = generate_world_sequence(n_frames=1, h=24, w=40, fx=32.0, seed=world["noise_seed"],
                                  step=8.0, device="cpu")
    assert torch.equal(a.frames[0, 0], seq.left[0].to(torch.uint8))
    assert torch.equal(a.frames[0, 1], seq.right[0].to(torch.uint8))
    n = len(a.T_cw)
    assert drive.stream_starts(a, 4) == [(b_ * n) // 4 for b_ in range(4)]
    assert drive.stream_starts(a, 2, 0.5) == [n // 2, (n // 2 + n // 2) % n]
