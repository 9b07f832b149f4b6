"""Registrations completed in the window over the window's seconds."""


def read(window):
    return len(window.rows) / window.seconds
