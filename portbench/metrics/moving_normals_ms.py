"""Host ms of one estimate of the moving set's normals (symmetric PLANE,
GICP): the traced calls' ``icp.moving_normals`` spans over their
``icp.moving_normals`` count. None where the program records neither."""

NAME = "icp.moving_normals"


def read(window):
    n = window.traced_counters.get(NAME, 0)
    spans = [s for s in window.traced_spans if s.name == NAME]
    if not n or not spans:
        return None
    return sum(s.end_ns - s.start_ns for s in spans) * 1e-6 / n
