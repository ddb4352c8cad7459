"""Run a FuXi cell through the harness on the CPU, with a fault planted in the
timed path underneath, as ``faults.py`` runs the Pangu cells.

    python wxbench/tests/fuxi_faults.py BENCHMARK.json CELL SECONDS TRACE FAULT

FAULT is ``-`` (none) or one of ``FAULTS``.
"""

import sys
import time

T_PROCESS = time.time()

from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402


def unnormalised():
    """K15's cosine attention without its normalisation: q and k enter the
    scores as they are (the block's plain version runs on the CPU)."""
    from skyrim_tpu_torch.ops import fused_block

    fused_block._unit_rows = lambda t: t


def altered():
    """An answer altered where it is produced: one channel of every step's
    output shifted by a fifth of its spread."""
    from skyrim_tpu_torch.models.fuxi import FuXiModel

    inner = FuXiModel.advance

    def advance(self, params, state):
        state, y = inner(self, params, state)
        y = y.clone()
        y[:, 5] += 0.2 * params["norm"]["std"][5]
        return state, y

    FuXiModel.advance = advance


FAULTS = {f.__name__: f for f in (unnormalised, altered)}


if __name__ == "__main__":
    bench, cell, seconds, trace, fault = sys.argv[1:6]
    torch.manual_seed(0)
    if fault != "-":
        FAULTS[fault]()
    from wxbench.harness.core import main

    sys.exit(main(["--workload", cell, "--seed", "5", "--seconds", seconds, "--trace", trace, "--device", "cpu",
                   "--benchmark", bench], T_PROCESS))
