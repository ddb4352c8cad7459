"""Run one cell of the port's benchmark once and print one JSON line.

    python3 wxbench/run.py --workload pangu.forecast_10d --seed 7 --seconds 30 --trace 0

The cell, its configuration, traffic mix and metrics are read from
``BENCHMARK.json`` at the root of the checkout (``harness/core.py``).
Caches of kernel builds stay inside the checkout: the port builds its CUDA
libraries into ``build/skyrim_tpu_torch/``, and any PyTorch extension or
Triton cache goes under ``build/wxbench/``.
"""

import time

T_PROCESS = time.time()  # set-up is timed from here, before the imports

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "wxbench" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "wxbench" / "triton")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))

from wxbench.harness.core import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_PROCESS))
