"""Run one cell through the harness on the CPU, with a fault planted in
the timed path underneath: the harness's check for a card is skipped
(``--device cpu``) and everything else runs as in a benchmark run.

    python wxbench/tests/faults.py BENCHMARK.json CELL SECONDS TRACE FAULT

FAULT is ``-`` (none) or one of ``FAULTS``.
"""

import sys
import time

T_PROCESS = time.time()

from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402


def unchanged():
    """A step that returns its state unchanged: each forecast step's output
    is its input frame."""
    from skyrim_tpu_torch.models.base import PrognosticModel
    from skyrim_tpu_torch.models.pangu import PanguModel

    def advance(self, params, state):
        return state.replace(step=state.step + 1, time_days=state.time_days + 0.25), state.x[-1:].clone()

    PanguModel.advance = PrognosticModel.advance = advance


def altered():
    """An answer altered where it is produced: one channel of every step's
    output shifted by a fifth of its spread."""
    from skyrim_tpu_torch.models.pangu import PanguModel

    inner = PanguModel.advance

    def advance(self, params, state):
        state, y = inner(self, params, state)
        y = y.clone()
        y[:, 5] += 0.2 * params["norm"]["std"][5]
        return state, y

    PanguModel.advance = advance


def update_skipped():
    """A training step that returns its state unchanged: the gradients are
    dropped and the optimizer never steps."""
    from skyrim_tpu_torch.finetune.trainer import Trainer

    def update(self):
        norm = self.clip_gradients()
        self.opt.zero_grad(set_to_none=True)
        return norm

    Trainer.update = update


def loss_altered():
    """A training step's answer altered where it is produced: the loss the
    step returns and differentiates is 5 % high."""
    from skyrim_tpu_torch.finetune.trainer import Trainer

    inner = Trainer.loss

    def loss(self, xs, ys):
        return inner(self, xs, ys) * 1.05

    Trainer.loss = loss


def jax_loaded():
    """A module named ``jax`` in the process (a stand-in: the guard reads names)."""
    import types

    sys.modules["jax"] = types.ModuleType("jax")


FAULTS = {f.__name__: f for f in (unchanged, altered, update_skipped, loss_altered, jax_loaded)}


if __name__ == "__main__":
    bench, cell, seconds, trace, fault = sys.argv[1:6]
    torch.manual_seed(0)
    if fault != "-":
        FAULTS[fault]()
    from wxbench.harness.core import main

    sys.exit(main(["--workload", cell, "--seed", "5", "--seconds", seconds, "--trace", trace, "--device", "cpu",
                   "--benchmark", bench], T_PROCESS))
