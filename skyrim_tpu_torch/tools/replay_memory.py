"""The device memory of GraphCast's full-width train step, with the kernels'
backward replays in chunks (``ops.vjp.CHUNK_ROWS``) and whole.

    python -m skyrim_tpu_torch.tools.replay_memory

On the card only: one ``Trainer(TrainConfig(batch_size=1, remat=True))``
step of ``GraphCastModel(GraphCastConfig())`` (721x1440, 83 channels,
latent 512, mesh 6, 16 rounds, seed-0 parameters) on a seeded normal pair,
run chunked, whole (``CHUNK_ROWS`` above any call's rows: JAX's backward,
which replays each composition at once), and chunked again.  For each run
it prints one JSON line: whether the step fitted (or the allocator's
message), the forward's and backward's seconds on the host clock after a
synchronise, the peak of ``torch.cuda.max_memory_allocated``, and each
replay's own peak beside the memory allocated when it started (the
tensors the remat forward saved and the gradients so far), the largest
first.  Each replay is read by wrapping ``ops.vjp._PlainVJP.backward`` for
the run.
"""

from __future__ import annotations

import gc
import json
import sys
import time

import torch

from skyrim_tpu_torch.ops import vjp

GB = 1e9


def _instrument(record: list):
    """Wrap ``_PlainVJP.backward``: each replay appends (its peak, allocated at
    its start, its plain version's name, its chunks' (blocks, rows a block))
    to ``record``, and the peak before it as ("before", peak).  Returns the
    original, to put back."""
    original = vjp._PlainVJP.backward

    def backward(ctx, *grads):
        record.append(("before", torch.cuda.max_memory_allocated() / GB))
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated() / GB
        try:
            return original(ctx, *grads)
        finally:
            cut = (ctx.chunks.units, ctx.chunks.rows) if ctx.chunks is not None else None
            record.append((torch.cuda.max_memory_allocated() / GB, start, ctx.plain.__name__, cut))
            torch.cuda.reset_peak_memory_stats()

    vjp._PlainVJP.backward = staticmethod(backward)
    return original


def step(model, params, x, y, rows: int) -> dict:
    """One remat train step with ``CHUNK_ROWS = rows``; its memory and times."""
    from skyrim_tpu_torch.finetune import TrainConfig, Trainer

    saved, vjp.CHUNK_ROWS = vjp.CHUNK_ROWS, rows
    record: list = []
    original = _instrument(record)
    tr = Trainer(model, params, TrainConfig(batch_size=1, remat=True))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = {"chunk_rows": rows, "resident_gb": torch.cuda.memory_allocated() / GB}
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = tr.loss(x, y)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        out.update(fitted=True, forward_s=t1 - t0, backward_s=time.perf_counter() - t1)
    except torch.cuda.OutOfMemoryError as e:
        out.update(fitted=False, error=str(e)[:160])
    finally:
        vjp._PlainVJP.backward = original
        vjp.CHUNK_ROWS = saved
    loss = None
    replays = [r for r in record if r[0] != "before"]
    out["peak_gb"] = max([r[0] for r in replays] + [r[1] for r in record if r[0] == "before"]
                         + [torch.cuda.max_memory_allocated() / GB])
    out["replays_by_peak"] = [{"peak_gb": p, "start_gb": s, "plain": n, "chunks_of": c}
                              for p, s, n, c in sorted(replays, key=lambda r: -r[0])[:8]]
    del tr, loss, record
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("replay_memory: needs a CUDA device", file=sys.stderr)
        return 1
    from skyrim_tpu_torch.models.graphcast import GraphCastConfig, GraphCastModel
    from skyrim_tpu_torch.ops import _build

    _build.build()
    model = GraphCastModel(GraphCastConfig(), device="cuda")
    params = model.init_params(torch.Generator().manual_seed(0))
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((1, model.n_history, *model.state_shape[1:]), generator=g, device="cuda")
    y = torch.randn((1, 1, *model.state_shape[1:]), generator=g, device="cuda")
    print(torch.cuda.get_device_name(0), flush=True)
    for rows in (vjp.CHUNK_ROWS, 1 << 62, vjp.CHUNK_ROWS):
        print(json.dumps(step(model, params, x, y, rows)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
