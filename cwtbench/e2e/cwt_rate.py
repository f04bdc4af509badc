"""Sample-scales transformed per second: the work of every call in the
window (B n0 S each) over the seconds from the window's start to its final
device synchronize, so a stall or the queue's drain counts."""


def value(window):
    if window.units <= 0 or window.seconds <= 0:
        return None
    return window.units / window.seconds
