"""Seconds from the process's start to the window's first call: imports,
the kernels' load (and build, on a checkout's first run), the frame pool,
the warm-up calls."""


def read(window):
    return window.setup_s
