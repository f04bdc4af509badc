"""Set-up: process start to the window's start (imports, the CUDA library's
build or load, the inputs, the warm-up calls)."""


def value(window):
    return window.setup_s
