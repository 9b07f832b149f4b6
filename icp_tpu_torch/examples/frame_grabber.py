"""Synthetic frame grabber (port of ``examples/frame_grabber.py``): the
reference's ``kinect_frame_grabber`` with the analytic renderer standing in
for libfreenect. Renders RGB-D on the card, optionally guided-filters it
(the reference's ``-f`` flag), back-projects with the f=595 pinhole model,
and writes a reference-format ``<dir>/kg_pc8d_<suffix>.bin`` cloud.

Usage:
    python -m icp_tpu_torch.examples.frame_grabber [-f] [-s SUFFIX]
        [--out-dir DIR] [--pose X Y Z YAW]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def main(argv=None, *, device="cuda") -> str:
    """Render, filter, back-project and write one cloud; returns its path."""
    ap = argparse.ArgumentParser()
    ap.add_argument("-f", "--filter", action="store_true",
                    help="guided-filter the RGB-D frames (reference -f)")
    ap.add_argument("-s", "--suffix", default="1",
                    help="output name suffix (reference -s)")
    ap.add_argument("--out-dir", default="data")
    ap.add_argument("--pose", nargs=4, type=float, default=[0, 0, 0, 0],
                    metavar=("X", "Y", "Z", "YAW"),
                    help="camera pose: translation mm + yaw rad")
    args = ap.parse_args(argv)

    from icp_tpu_torch.runtime.native import validate_cloud, write_cloud
    from icp_tpu_torch.sensors import guided_filter as gf
    from icp_tpu_torch.sensors import pinhole, synthetic

    x, y, z, yaw = args.pose
    q = np.array([0, np.sin(yaw / 2), 0, np.cos(yaw / 2)], np.float32)
    t = np.array([x, y, z], np.float32)
    pose = synthetic.CameraPose(torch.from_numpy(q).to(device), torch.from_numpy(t).to(device))
    scene = synthetic.default_scene(device=device)
    depth, rgb = synthetic.render(scene, pose)

    if args.filter:
        print("Applying guided filter (radius=5, eps=0.005)")
        rgb = gf.filter_rgb(rgb)
        depth = gf.filter_depth(depth)

    cloud = pinhole.backproject(depth, rgb).reshape(-1, 8).cpu().numpy()
    n_valid = validate_cloud(cloud)
    os.makedirs(args.out_dir, exist_ok=True)
    path = os.path.join(args.out_dir, f"kg_pc8d_{args.suffix}.bin")
    write_cloud(path, cloud)
    print(f"Point cloud saved in {path} ({n_valid} valid points)")
    return path


if __name__ == "__main__":
    main()
