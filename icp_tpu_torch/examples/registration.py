"""Full registration (port of ``examples/registration.py``): the
reference's ``icp_registration`` app. Loads (or renders) a cloud pair, runs
ICP to convergence on the card, reports, and exports before/after views.

Usage:
    python -m icp_tpu_torch.examples.registration [name] [--data-dir DIR]
        [--synthetic] [--out-dir DIR] [--plot]
        [--robust {none,huber,tukey,trimmed}] [--robust-delta MM]

The pair is ``<data_dir>/<name>_1.bin`` / ``_2.bin`` (as
``frame_grabber`` writes them) when both exist, else the rendered pair of
``step_by_step.load_pair``.
"""

from __future__ import annotations

import argparse
import os
import tempfile


def main(argv=None, *, device="cuda"):
    """Run the app; returns the registration's ICPState."""
    ap = argparse.ArgumentParser()
    ap.add_argument("name", nargs="?", default="kg_pc8d")
    ap.add_argument("--data-dir", default="data")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--out-dir", default=os.path.join(tempfile.gettempdir(), "icp_tpu_reg"))
    ap.add_argument("--plot", action="store_true")
    ap.add_argument("--robust", default="none",
                    choices=["none", "huber", "tukey", "trimmed"],
                    help="robust M-estimator gating outlier pairs")
    ap.add_argument("--robust-delta", type=float, default=100.0,
                    help="robust kernel scale, blended-distance units (mm)")
    args = ap.parse_args(argv)

    from icp_tpu_torch import ICPConfig, ICPParams, RobustKernel
    from icp_tpu_torch.examples.step_by_step import load_pair
    from icp_tpu_torch.icp.pipeline import ICPRegistration
    from icp_tpu_torch.icp.quaternion import transform_points
    from icp_tpu_torch.sensors.io import write_ply

    fixed, moving = load_pair(args, device)
    app = ICPRegistration(
        ICPParams(alpha=2e2, robust_delta=args.robust_delta),
        ICPConfig(estimate_scale=False, robust=RobustKernel(args.robust)))
    state = app.register_clouds(fixed, moving)

    os.makedirs(args.out_dir, exist_ok=True)
    registered = transform_points(moving.reshape(-1, 8), state.q, state.t, state.s)
    write_ply(os.path.join(args.out_dir, "fixed.ply"), fixed.cpu().numpy())
    write_ply(os.path.join(args.out_dir, "registered.ply"), registered.cpu().numpy())
    print(f"PLY written to {args.out_dir}")

    if args.plot:
        from icp_tpu_torch.viz import plot_registration

        plot_registration(fixed, moving, registered,
                          os.path.join(args.out_dir, "registration.png"))
        print(f"Plot written to {args.out_dir}/registration.png")
    return state


if __name__ == "__main__":
    main()
