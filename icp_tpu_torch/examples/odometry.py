"""RGB-D odometry + SLAM demo (port of ``examples/odometry.py``): render a
synthetic Kinect trajectory, run the SlamEngine on the card (frame-to-frame
ICP, keyframes, loop closure, pose-graph refinement), and report ATE
against ground truth.

Usage:
    python -m icp_tpu_torch.examples.odometry [--frames N] [--plane]
        [--out-dir DIR]
"""

from __future__ import annotations

import argparse
import os
import tempfile


def main(argv=None, *, device="cuda"):
    """Run the demo; returns the SlamEngine."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--plane", action="store_true",
                    help="use the point-to-plane objective (sub-mm mode)")
    ap.add_argument("--out-dir", default=os.path.join(tempfile.gettempdir(),
                                                      "icp_tpu_odometry"))
    args = ap.parse_args(argv)

    from icp_tpu_torch import ICPConfig, ICPParams, Objective
    from icp_tpu_torch.runtime.metrics import MetricsSink
    from icp_tpu_torch.runtime.timing import CPUTimer, block_until_ready
    from icp_tpu_torch.sensors import synthetic
    from icp_tpu_torch.slam import se3
    from icp_tpu_torch.slam.mapping import SlamEngine
    from icp_tpu_torch.slam.odometry import KeyframePolicy, absolute_trajectory_error

    scene = synthetic.default_scene(device=device)
    poses_gt = synthetic.orbit_trajectory(args.frames, radius_mm=60.0, yaw_rad=0.05,
                                          device=device)
    print(f"rendering {args.frames} frames...")
    frames = [block_until_ready(synthetic.render_cloud(scene, p)) for p in poses_gt]

    config = ICPConfig(
        estimate_scale=False,
        objective=Objective.PLANE if args.plane else Objective.POINT,
    )
    eng = SlamEngine(ICPParams(alpha=2e2), config, policy=KeyframePolicy(max_gap=3))
    sink = MetricsSink("odometry-demo")

    for i, cloud in enumerate(frames):
        with CPUTimer() as t:
            pose = eng.process_frame(cloud)
        sink.log("frame_ms", t.span_ms, frame=i)
        print(f"frame {i:3d}: {t.span_ms:7.1f} ms  t = {pose.t.cpu().numpy()}")

    gt = [se3.Pose(p.q, p.t) for p in poses_gt]
    ate_before = absolute_trajectory_error(eng.trajectory, gt)
    print(f"\nATE (odometry only)     : {ate_before:.2f} mm")
    print(f"keyframes               : {len(eng.map.keyframes)}")
    print(f"loop closures           : {len(eng.map.loop_closures)}")

    if len(eng.map.keyframes) >= 2:
        eng.optimize_map()
        kf_poses = [k.pose for k in eng.map.keyframes]
        kf_gt = [gt[k.index] for k in eng.map.keyframes]
        ate_kf = absolute_trajectory_error(kf_poses, kf_gt)
        print(f"keyframe ATE (optimized): {ate_kf:.2f} mm")

    os.makedirs(args.out_dir, exist_ok=True)
    try:
        from icp_tpu_torch.viz import plot_trajectory

        plot_trajectory([p.t for p in eng.trajectory], [p.t for p in gt],
                        os.path.join(args.out_dir, "trajectory.png"))
        print(f"trajectory plot: {args.out_dir}/trajectory.png")
    except ImportError as e:  # matplotlib is optional: say so, plot nothing
        print(f"(no plot: {e})")
    sink.dump_jsonl(os.path.join(args.out_dir, "metrics.jsonl"))
    return eng


if __name__ == "__main__":
    main()
