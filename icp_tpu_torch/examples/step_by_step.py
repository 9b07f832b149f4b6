"""Step-by-step photogeometric ICP (port of ``examples/step_by_step.py``):
the reference's ``icp_step_by_step`` app without the GLUT window. Each
<Enter> runs one iteration on the card and prints the reference-format
report; results are dumped as PLY/PNG instead of a GL view.

Usage:
    python -m icp_tpu_torch.examples.step_by_step [name] [--data-dir DIR]
        [--synthetic] [--out-dir DIR] [--batch N] [--live]

``name`` selects ``<dir>/<name>_1.bin`` / ``<name>_2.bin`` pairs (the
reference's positional cloud-name argument, default ``kg_pc8d``); with
--synthetic (or when files are missing) a rendered Kinect-like pair with
known ground truth is used instead.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

# Ground truth of the rendered pair load_pair makes: pose B, 0.008 rad
# about y and t = (10, -6, 8) mm, seen from pose A, the identity.
Q_B = np.array([0, np.sin(0.004), 0, np.cos(0.004)], np.float32)
T_B = np.array([10.0, -6.0, 8.0], np.float32)


def load_pair(args, device="cuda"):
    """The (fixed, moving) (n, 8) clouds on ``device``: the ``.bin`` pair
    ``<data_dir>/<name>_1.bin`` / ``_2.bin`` when both exist and
    ``args.synthetic`` is off, else the rendered pair."""
    p1 = os.path.join(args.data_dir, f"{args.name}_1.bin")
    p2 = os.path.join(args.data_dir, f"{args.name}_2.bin")
    if not args.synthetic and os.path.exists(p1) and os.path.exists(p2):
        from icp_tpu_torch.runtime.native import read_cloud

        print(f"Loading {p1} / {p2}")
        return (torch.as_tensor(read_cloud(p1), device=device),
                torch.as_tensor(read_cloud(p2), device=device))

    print("Rendering synthetic Kinect pair (known ground truth)")
    from icp_tpu_torch.sensors import synthetic

    scene = synthetic.default_scene(device=device)
    pose_a = synthetic.CameraPose.identity(device=device)
    pose_b = synthetic.CameraPose(torch.from_numpy(Q_B).to(device),
                                  torch.from_numpy(T_B).to(device))
    fixed = synthetic.render_cloud(scene, pose_a).reshape(-1, 8)
    moving = synthetic.render_cloud(scene, pose_b).reshape(-1, 8)
    return fixed, moving


def main(argv=None, *, device="cuda"):
    """Run the app; returns its :class:`~icp_tpu_torch.icp.pipeline.ICPStepByStep`."""
    ap = argparse.ArgumentParser()
    ap.add_argument("name", nargs="?", default="kg_pc8d")
    ap.add_argument("--data-dir", default="data")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--out-dir", default=os.path.join(tempfile.gettempdir(), "icp_tpu_sbs"))
    ap.add_argument("--batch", type=int, default=0,
                    help="run N steps non-interactively")
    ap.add_argument("--live", action="store_true",
                    help="stream the registration view (GUI window with "
                         "the reference's T/R/Q keys when a display "
                         "exists, PNG frames under --out-dir otherwise)")
    args = ap.parse_args(argv)

    from icp_tpu_torch import ICPConfig, ICPParams
    from icp_tpu_torch.icp.pipeline import ICPStepByStep
    from icp_tpu_torch.sensors.io import write_ply

    fixed, moving = load_pair(args, device)
    app = ICPStepByStep(fixed, moving, ICPParams(alpha=2e2),
                        ICPConfig(estimate_scale=False))
    app.build_rbc()

    os.makedirs(args.out_dir, exist_ok=True)

    def dump(tag):
        write_ply(os.path.join(args.out_dir, f"registered_{tag}.ply"),
                  app.transformed_cloud().cpu().numpy())

    viewer = None
    if args.live:
        from icp_tpu_torch.viz import LiveViewer

        viewer = LiveViewer(out_dir=args.out_dir)
        viewer.attach(app)
        if viewer.interactive and not args.batch:
            print("live view: T/<Enter> step | R reset | Q quit "
                  "(reference key map)")
            viewer.loop()
            dump("final")
            return app

    def one_step():
        viewer.step() if viewer is not None else app.step()

    if args.batch:
        for _ in range(args.batch):
            one_step()
        dump(f"k{int(app.state.k)}")
        print(f"PLY written to {args.out_dir}"
              + (f"; {viewer.frame} live frames" if viewer else ""))
        return app

    print("T=<Enter> step | R reset | Q quit   (reference key map)")
    while True:
        try:
            cmd = input("> ").strip().lower()
        except EOFError:
            break
        if cmd in ("", "t"):
            one_step()
        elif cmd == "r":
            (viewer.reset() if viewer is not None else app.reset())
            print("reset")
        elif cmd == "q":
            break
    dump("final")
    return app


if __name__ == "__main__":
    main()
