"""Calls completed per second of the window (each call returns host arrays,
so it ends synchronised)."""


def value(window):
    if window.calls == 0 or window.seconds <= 0:
        return None
    return window.calls / window.seconds
