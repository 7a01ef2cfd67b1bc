"""Grid cells x steps completed in the window / the window's wall seconds
(host clock; the window closes with a synchronize)."""


def read(rec):
    if not rec.steps:
        return None
    return rec.cells * rec.steps / rec.window_s
