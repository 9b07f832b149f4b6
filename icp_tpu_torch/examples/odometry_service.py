"""Resilient long-running odometry/mapping service (port of
``examples/odometry_service.py``): a production-shaped loop around the SLAM
engine on the card.

  * frame source: the synthetic Kinect renderer standing in for a sensor
    feed, or recorded ``.bin`` clouds (``--data-dir``) through the native
    prefetching ``icp_tpu_torch.sensors.stream.FrameSource``;
  * every registration dispatch wrapped in ``with_retries`` (the engine's
    ``dispatch_retries``), after a ``device_healthy`` probe at start-up;
  * durable snapshots every ``--checkpoint-every`` frames through
    ``icp_tpu_torch.slam.checkpoint`` (npz) and automatic resume from the
    newest snapshot on start-up: kill the process mid-run and restart it
    to see the trajectory continue where it left off;
  * structured metrics (JSONL) + final ATE/RPE against ground truth.

Usage:
    python -m icp_tpu_torch.examples.odometry_service [--frames N]
        [--checkpoint-every K] [--state-dir DIR] [--backend npz|orbax]
        [--fail-at F] [--data-dir DIR]

``--fail-at F`` injects a crash after frame F (before its checkpoint) to
demonstrate resume: run once with it, then again without. ``--backend
orbax`` raises: orbax is a JAX library, and the port writes npz only.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import tempfile


def latest_snapshot(state_dir: str, backend: str):
    if backend == "orbax":
        cands = sorted(glob.glob(os.path.join(state_dir, "snap_*")))
        cands = [c for c in cands if os.path.isdir(c)]
    else:
        cands = sorted(glob.glob(os.path.join(state_dir, "snap_*.npz")))
    return cands[-1] if cands else None


def main(argv=None, *, device="cuda") -> int:
    """Run the service; returns its exit code (2 after an injected crash)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--checkpoint-every", type=int, default=4)
    ap.add_argument("--state-dir", default=os.path.join(tempfile.gettempdir(),
                                                        "icp_tpu_service"))
    ap.add_argument("--backend", choices=("npz", "orbax"), default="npz")
    ap.add_argument("--fail-at", type=int, default=-1,
                    help="inject a crash after this frame (demo resume)")
    ap.add_argument("--data-dir", default=None,
                    help="stream recorded .bin clouds (via the native "
                         "prefetching FrameSource) instead of rendering; "
                         "no ground truth -> no ATE/RPE report")
    args = ap.parse_args(argv)
    os.makedirs(args.state_dir, exist_ok=True)

    import torch

    from icp_tpu_torch import ICPConfig, ICPParams
    from icp_tpu_torch.parallel.resilience import device_healthy
    from icp_tpu_torch.runtime.metrics import MetricsSink
    from icp_tpu_torch.runtime.timing import CPUTimer, block_until_ready
    from icp_tpu_torch.sensors import synthetic
    from icp_tpu_torch.slam import se3
    from icp_tpu_torch.slam.checkpoint import load_session, save_session
    from icp_tpu_torch.slam.mapping import SlamEngine
    from icp_tpu_torch.slam.odometry import (
        KeyframePolicy,
        absolute_trajectory_error,
        relative_pose_error,
    )

    if args.backend == "orbax":
        # The port writes npz only: the checkpoint module's own refusal,
        # raised before any frame is processed.
        load_session(args.state_dir, backend="orbax", device=device)
    if not device_healthy(device):
        print("FATAL: no healthy device", file=sys.stderr)
        return 1

    scene = synthetic.default_scene(device=device)
    poses_gt = synthetic.orbit_trajectory(args.frames, radius_mm=60.0, yaw_rad=0.05,
                                          device=device)

    config = ICPConfig(estimate_scale=False)
    params = ICPParams(alpha=2e2)
    snap = latest_snapshot(args.state_dir, args.backend)
    if snap is not None:
        eng = load_session(snap, backend=args.backend, device=device)
        eng.dispatch_retries = 3
        start = len(eng.trajectory)
        print(f"resumed from {snap}: {start} frames, "
              f"{len(eng.map.keyframes)} keyframes")
    else:
        eng = SlamEngine(params, config, policy=KeyframePolicy(max_gap=3),
                         dispatch_retries=3)
        start = 0
        print("fresh session")
    if start >= args.frames:
        print("nothing to do (trajectory already complete)")
        start = len(eng.trajectory)

    source = None
    if args.data_dir is not None:
        from icp_tpu_torch.sensors.stream import FrameSource

        source = FrameSource(args.data_dir)
        args.frames = min(args.frames, len(source))
        # Fast-forward the prefetch stream past already-processed frames.
        for _ in range(start):
            source.next_frame()

    sink = MetricsSink("odometry-service")
    for i in range(start, args.frames):
        if source is not None:
            item = source.next_frame()
            if item is None:
                break
            cloud = torch.as_tensor(item[1], device=device)
        else:
            cloud = block_until_ready(synthetic.render_cloud(scene, poses_gt[i]))
        with CPUTimer() as t:
            # Retries live INSIDE the engine (dispatch_retries=3), wrapping
            # only the pure registration dispatches: retrying process_frame
            # itself would duplicate its state mutations (trajectory append,
            # keyframe promotion) on a transient mid-frame failure.
            pose = eng.process_frame(cloud)
        sink.log("frame_ms", t.span_ms, frame=i)
        print(f"frame {i:3d}: {t.span_ms:7.1f} ms  t = {pose.t.cpu().numpy()}")

        if args.fail_at == i:
            print("injected failure — restart to resume", file=sys.stderr)
            return 2

        if (i + 1) % args.checkpoint_every == 0 or i == args.frames - 1:
            path = os.path.join(args.state_dir, f"snap_{i + 1:06d}")
            saved = save_session(eng, path, backend=args.backend)
            sink.log("checkpoint_frames", i + 1)
            print(f"  checkpoint -> {saved}")

    if source is not None:
        source.close()
        print(f"\nframes: {len(eng.trajectory)}"
              f"   keyframes: {len(eng.map.keyframes)}"
              f"   loop closures: {len(eng.map.loop_closures)}"
              f"   (recorded data: no ground truth)")
    else:
        gt = [se3.Pose(p.q, p.t) for p in poses_gt]
        n = min(len(eng.trajectory), len(gt))
        ate = absolute_trajectory_error(eng.trajectory[:n], gt[:n])
        rpe_t, rpe_r = relative_pose_error(eng.trajectory[:n], gt[:n])
        print(f"\nATE: {ate:.2f} mm   RPE: {rpe_t:.2f} mm / {rpe_r:.4f} deg"
              f"   keyframes: {len(eng.map.keyframes)}"
              f"   loop closures: {len(eng.map.loop_closures)}")
    if len(eng.map.keyframes) >= 2:
        eng.optimize_map()
        print("pose graph refined")
    sink.dump_jsonl(os.path.join(args.state_dir, "metrics.jsonl"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
