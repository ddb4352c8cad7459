"""Forecast steps whose output reached host memory inside the window, per
second of the window (host clock)."""


def read(run):
    if run.traffic["kind"] != "forecast":
        return None
    return run.steps / run.window_s
