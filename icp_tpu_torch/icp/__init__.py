"""Algorithm layer: quaternions, Horn solve, one step, the loop."""
