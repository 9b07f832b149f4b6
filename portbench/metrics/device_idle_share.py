"""Share of the traced window in which no operation ran on the device, %:
100 x (1 - the union of the device intervals / the window)."""


def read(window):
    if window.trace is None or not window.trace.device:
        return None
    return 100.0 * (1.0 - window.trace.busy_s / window.trace.window_s)
