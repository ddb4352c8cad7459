"""Optimizer steps completed inside the window, per second of the window."""


def read(run):
    if run.traffic["kind"] != "finetune":
        return None
    return run.steps / run.window_s
