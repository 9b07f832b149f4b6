"""Device operations (kernels, copies, fills) in the traced window over the
iterations its registrations reported: the launches one iteration costs."""


def read(window):
    if window.trace is None or not window.trace.device:
        return None
    return len(window.trace.device) / window.traced_iterations
