"""The reference apps and demos on the port (ports of ``examples/``), each
runnable as ``python -m icp_tpu_torch.examples.<name>`` and callable
in-process as ``main(argv)``:

* ``frame_grabber``: render an RGB-D frame, optionally guided-filter it,
  back-project it and write a reference-format ``.bin`` cloud;
* ``step_by_step``: the step-by-step app (``--batch N``, ``--live``);
* ``registration``: the full registration app (``--robust``, ``--plot``);
* ``odometry``: the SLAM engine on a rendered trajectory, with its ATE;
* ``odometry_service``: the resilient service loop with snapshots and resume;
* ``multichip``: the sharded registration, one process per rank.

They run on the card; ``multichip --cpu`` runs on the CPU over gloo. A
caller in the same process may pass ``device="cpu"`` to ``main``.
"""
