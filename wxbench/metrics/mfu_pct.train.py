"""Forward and backward model FLOPs of an optimizer step (three times the
benchmark's count of a forward of the plain reference; remat's recompute
not counted) times the steps completed, over the window's seconds times
the card's bf16 peak."""

from wxbench.harness.counts import PEAK_FLOPS


def read(run):
    if run.traffic["kind"] != "finetune" or not run.steps or run.device == "cpu":
        return None
    per_step = 3 * run.family.forward_flops(run.cfg) * run.traffic["batch_size"] * run.traffic["rollout_steps"]
    return 100.0 * per_step * run.steps / (run.window_s * PEAK_FLOPS)
