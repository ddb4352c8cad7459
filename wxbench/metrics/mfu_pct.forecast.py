"""The model FLOPs of a step (the benchmark's count of its plain
reference's products at the configuration's shapes) times the steps
completed, over the window's seconds times the card's bf16 peak."""

from wxbench.harness.counts import PEAK_FLOPS


def read(run):
    if run.traffic["kind"] != "forecast" or not run.steps or run.device == "cpu":
        return None
    return 100.0 * run.family.forward_flops(run.cfg) * run.steps / (run.window_s * PEAK_FLOPS)
