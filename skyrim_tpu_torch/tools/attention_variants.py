"""Time variants of the window-attention kernel against each other on one card.

    python -m skyrim_tpu_torch.tools.attention_variants [CSRC_DIR ...]

Each CSRC_DIR is a copy of ``skyrim_tpu_torch/csrc`` (edited or not); with
none given, the package's own.  The tool builds ``window_attention.cu`` from
every directory with the package's nvcc flags (``-Xptxas -v`` added: the
register and stack report of the 4-D kernel is printed), then times
``skt_attention_4d`` (K5) at Pangu stage 1 — qkv (8, 186, 360, 576), 6 heads,
124 bias types, shifted mask — with CUDA events, 20 launches a round, four
rounds in turn over the variants, so that clock drift shows as spread between
rounds and not as a difference between variants.  Prints one line per build
and per (round, variant); needs a CUDA device and nvcc.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROUNDS, LAUNCHES = 4, 20


def main(dirs: list[str]) -> int:
    import torch

    from skyrim_tpu_torch.ops import _build
    from skyrim_tpu_torch.ops.windows import shift_attention_mask

    if not torch.cuda.is_available():
        print("attention_variants: no CUDA device", file=sys.stderr)
        return 1
    variants = [Path(d) for d in dirs] or [_build.CSRC]
    dev = torch.device("cuda")
    Z, H, W, C, heads, window = 8, 186, 360, 192, 6, (2, 6, 12)
    g = torch.Generator(device=dev).manual_seed(0)
    qkv = torch.randn(Z, H, W, 3 * C, device=dev, generator=g).to(torch.bfloat16)
    bias = torch.randn(4 * 31, heads, 144, 144, device=dev, generator=g) * 0.5
    mask = torch.from_numpy(shift_attention_mask((Z, H, W), window, (1, 3, 6), (Z, 181, W))).to(dev)
    out = torch.empty(Z, H, W, C, device=dev, dtype=torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

    with tempfile.TemporaryDirectory() as tmp:
        jobs = []
        for n, src in enumerate(variants):
            lib = Path(tmp) / f"variant{n}.so"
            cmd = [_build._nvcc(), *_build.FLAGS, "-Xptxas", "-v", "-I", str(src), "-o", str(lib),
                   str(src / "window_attention.cu")]  # fmt: skip
            jobs.append((src, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        calls = {}
        for src, lib, proc in jobs:
            log, _ = proc.communicate()
            if proc.returncode:
                print(f"{src}: nvcc failed\n{log}", file=sys.stderr)
                return 1
            lines = log.splitlines()
            for i, line in enumerate(lines):
                if "window_attention_kernel" in line and "Packed4D" in line and "Function properties" in line:
                    print(f"{src}: {lines[i + 1].strip()}; {lines[i + 2].strip()}")
            fn = ctypes.CDLL(str(lib)).skt_attention_4d
            fn.argtypes, fn.restype = [P] * 4 + [I] * 10 + [F, P], I

            def call(fn=fn):
                return fn(qkv.data_ptr(), bias.data_ptr(), mask.data_ptr(), out.data_ptr(), Z, H, W, C, heads,
                          *window, bias.shape[0], 1, (C // heads) ** -0.5, stream)  # fmt: skip

            if call() != 0:
                print(f"{src}: the launch was refused", file=sys.stderr)
                return 1
            calls[src] = call
        torch.cuda.synchronize()
        for rnd in range(ROUNDS):
            for src, call in calls.items():
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(LAUNCHES):
                    call()
                end.record()
                torch.cuda.synchronize()
                print(f"round {rnd} {src}: {start.elapsed_time(end) / LAUNCHES:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
