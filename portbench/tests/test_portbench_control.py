"""On the card: the control (the plain reference with TF32 matrix
products put in the program's place) comes out not correct against each
configuration's limits, at the configuration's own sizes on a pool of 8 frames (every pair
compared), while the program, on the same pairs, comes out correct."""

import pytest

from conftest import tiny
from portbench import calibrate, check, scene, spec
from portbench.drive import System


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["kinect.stream", "lidar.stream"])
def test_control_fails_the_limits_the_program_meets(cuda_device, name):
    import torch

    full = spec.cell(name)
    cell = tiny(full, full["config"]["points"], full["config"]["icp"]["n_r"], pool=8)
    config, traffic = cell["config"], cell["traffic"]
    with torch.no_grad():
        pool = scene.make_pool(2 ** 31 + 5, config, 8, cuda_device)
        window = calibrate.cycle_window(System(config, traffic, pool["frames"]), traffic)
        program = check.compare(pool["frames"], window, config, 5, 8)
        control = calibrate.control(pool["frames"], window, config, 5, 8)
    ok, _ = check.judge(program, cell["limits"])
    assert ok, program
    ok, _ = check.judge(control, cell["limits"])
    assert not ok, control
