"""Seconds from process start to the window's first step: imports, the
kernel library, the case, the host grid build, ``solver.init``, the seeded
state and the warm-up steps (host clock, the device synchronised)."""


def read(rec):
    return rec.setup_s
