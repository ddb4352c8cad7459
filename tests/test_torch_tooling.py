"""The port's tooling against the JAX package's, on the CPU.

- ``utils/timing.py``, ``utils/env.py``, ``utils/profiling.py`` and
  ``utils/op_stats.py`` on CPU steps: the JAX modules' log lines and
  results.
- ``ops/cost.py``: each of the 14 kernels' declared cost, counted around one
  call of the port's public wrapper, equals the ``pl.CostEstimate`` the JAX
  kernel hands ``pallas_call`` on the same shapes, integer for integer
  (captured by a spy put in place of ``jax.experimental.pallas.pallas_call``,
  which records the estimate and calls the original; the JAX ops run in
  interpret mode after ``jax.clear_caches()``).
- ``utils/op_bytes.py``: a step charges each kernel its declared bytes once,
  and nothing of the plain versions it runs on the CPU.
- ``utils/roofline.py``: ``roofline()`` key for key against JAX's on the same
  numbers; ``floor_bytes`` against JAX's where both packages hold the leaves
  in the same dtypes.

JAX is imported inside the tests: the card's machine has no JAX.
"""

import contextlib
import json
import logging

import numpy as np
import pytest
import torch

from skyrim_tpu_torch.ops import cost

# --- ops/cost.py against the JAX kernels' CostEstimates ---------------------------

WINDOW = (2, 6, 12)


def _kernel_cases():
    """(name, JAX op path, args, kwargs) for every kernel at a small shape: numpy
    inputs, integer index tables in range, the same for both packages."""
    rng = np.random.default_rng(0)

    def n(*shape, s=0.5):
        return (rng.normal(size=shape) * s).astype(np.float32)

    def ln(c):
        return (1 + n(c, s=0.1), n(c, s=0.1))

    def dense(a, b):
        return (n(a, b, s=a**-0.5), n(b, s=0.1))

    C, heads, wlen = 16, 2, int(np.prod(WINDOW))
    L = 16
    blk = (n(2, 6, 24, C), ln(C), dense(C, 3 * C), n(1, heads, wlen, wlen), None, dense(C, C), ln(C),
           dense(C, 4 * C) + dense(4 * C, C), WINDOW, heads)
    msg = (ln(L), dense(L, L))
    return [
        ("K1", "fused_block.fused_swin_block_4d", blk, {}),
        ("K2", "roll.roll3d", (n(2, 6, 24, C), (1, 3, 6)), {}),
        ("K3", "resample.fused_downsample", (n(2, 6, 8, 8), ln(32), dense(32, 16)), {}),
        ("K4", "resample.fused_upsample", (n(2, 3, 4, 16), dense(16, 32), ln(8)), {}),
        ("K5", "flash_window_attention.fused_window_attention_4d",
         (n(2, 6, 24, 3 * C), n(1, heads, wlen, wlen), None, WINDOW, heads), {}),
        ("K6", "fused_mlp.fused_mlp", (n(40, 8), dense(14, 16), dense(16, 8), ln(8), n(40, 6), n(40, 8)), {}),
        ("K6", "fused_mlp.fused_mlp", (n(8, 40), dense(8, 16), dense(16, 12)), {"x_transposed": True}),
        ("K7", "graph_kernels.fused_round_messages",
         (n(2, 8, L), n(2, 8, L), n(2, 4, L), rng.integers(0, 5, (2, 8)).astype(np.int32), n(L, L, s=0.25),
          n(L, s=0.1), msg[1], msg[0], 4), {}),
        ("K8", "graph_kernels.fused_m2g_tiled",
         (n(2, 2, 3, 3 * L), rng.integers(0, 3, (4, 4)).astype(np.int32), n(4, 4, 3 * L), n(4, 4, L),
          n(L, s=0.1), msg[1], msg[0], 3, 2, 2), {}),
        ("K9", "graph_kernels.fused_g2m_tiled",
         (n(4, 4, L), n(4, 4, 2 * L), rng.integers(0, 4, (2, 2, 2, 4)).astype(np.int32), n(L, s=0.1), msg[1],
          msg[0], 2, 3, 2, 2), {}),
        ("K10", "flash_window_attention.fused_window_attention",
         (n(4, 16, 3 * C), n(1, heads, 16, 16), None, 4, heads), {}),
        ("K11", "flash_window_attention.flash_window_attention",
         (n(4, heads, 16, 8), n(4, heads, 16, 8), n(4, heads, 16, 8), n(1, heads, 16, 16), None, 4), {}),
        ("K12", "fused_mlp.fused_finish", (n(40, L), n(L, s=0.1), dense(L, L), ln(L)), {}),
        ("K13", "graph_kernels.fused_fixed_degree_messages",
         (n(40, 3 * L), n(40, 3 * L), n(40, L), n(L, s=0.1), msg[1], msg[0], 3), {}),
        ("K14", "graph_kernels.fused_block_messages",
         (n(2, 8, L), n(2, 8, L), rng.integers(0, 5, (2, 8)).astype(np.int32), n(L, s=0.1), msg[1], msg[0], 4),
         {}),
    ]


# the port's public wrapper of each JAX op
PORT = {
    "fused_block.fused_swin_block_4d": "fused_block.fused_swin_block",
    "roll.roll3d": "roll.roll3d",
}


def _resolve(path, package):
    import importlib

    mod, fn = path.rsplit(".", 1)
    return getattr(importlib.import_module(f"{package}.ops.{mod}"), fn)


def _map(a, fn):
    if isinstance(a, tuple):
        return tuple(_map(v, fn) for v in a)
    return fn(a) if isinstance(a, np.ndarray) else a


@contextlib.contextmanager
def _spy_pallas(record):
    """``jax.experimental.pallas.pallas_call`` replaced by a spy that records
    each call's ``cost_estimate`` and calls the original."""
    import jax
    from jax.experimental import pallas as pl

    original = pl.pallas_call

    def spy(*args, **kwargs):
        record.append(kwargs.get("cost_estimate"))
        return original(*args, **kwargs)

    jax.clear_caches()
    pl.pallas_call = spy
    try:
        yield
    finally:
        pl.pallas_call = original
        jax.clear_caches()


@pytest.mark.parametrize("case", range(15), ids=lambda i: f"case{i}")
def test_kernel_cost_equals_jax_cost_estimate(case):
    """The declared cost counted around one port wrapper call equals the JAX
    kernel's CostEstimate at the same shapes, integer for integer."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    name, path, args, kwargs = _kernel_cases()[case]
    record = []
    with _spy_pallas(record):
        _resolve(path, "skyrim_tpu")(*_map(args, jnp.asarray), **kwargs, interpret=True)
    assert len(record) == 1 and record[0] is not None, record
    want = record[0]
    port = _resolve(PORT.get(path, path), "skyrim_tpu_torch")
    with cost.count_costs() as count:
        port(*_map(args, torch.from_numpy), **kwargs)
    assert list(count.by_kernel) == [name] and count.by_kernel[name][0] == 1
    got = (count.flops, count.bytes_accessed, count.transcendentals)
    assert got == (int(want.flops), int(want.bytes_accessed), int(want.transcendentals)), (name, got, want)


def test_costs_counted_once_and_only_when_active():
    """A wrapper inside another's region is not charged again; outside
    ``count_costs`` nothing is counted; an odd H counts JAX's padded row."""
    x = torch.zeros(2, 6, 24, 16)
    with cost.count_costs() as outer:
        with cost.kernel("K1", cost.roll, x):
            from skyrim_tpu_torch.ops.roll import roll3d

            roll3d(x, (0, 1, 2))
    assert outer.by_kernel == {"K1": [1, 0, 2 * x.numel() * 4, 0]}
    assert not cost._ACTIVE and cost._DEPTH == [0]
    wb = (torch.zeros(32, 16), torch.zeros(16))
    assert cost.downsample(torch.zeros(2, 5, 8, 8), wb) == cost.downsample(torch.zeros(2, 6, 8, 8), wb)


# --- utils/timing.py, utils/env.py, utils/profiling.py ---------------------------------


@contextlib.contextmanager
def _records(lg, level=logging.DEBUG):
    """The records a package logger emits inside the block, at ``level``."""
    got = []
    handler = logging.Handler()
    handler.emit = lambda r: got.append(r.getMessage())
    old = lg.level
    lg.setLevel(level)
    lg.addHandler(handler)
    try:
        yield got
    finally:
        lg.removeHandler(handler)
        lg.setLevel(old)


def test_timing_log_lines_match_jax():
    pytest.importorskip("jax")
    import re

    from skyrim_tpu.utils import timing as JT
    from skyrim_tpu.utils.logging import logger as jlogger

    from skyrim_tpu_torch.utils import timing as T
    from skyrim_tpu_torch.utils.logging import logger

    def work(n):
        return torch.arange(n).sum()

    lines = {}
    for name, mod, lg in (("port", T, logger), ("jax", JT, jlogger)):
        with _records(lg._logger) as got:
            assert int(mod.timeit(work)(10)) == 45
            with mod.log_time("label"):
                work(5)
            t = mod.Timer()
            for _ in range(2):
                with t:
                    work(3)
        assert t.count == 2 and t.mean == t.elapsed / 2
        lines[name] = [re.sub(r"\d+\.\d{3}s", "<s>", m) for m in got]
    assert lines["port"] == lines["jax"] == ["test_timing_log_lines_match_jax.<locals>.work took <s>", "label: <s>"]
    assert T.synchronize((torch.ones(2), {"a": [torch.zeros(1)]}))[0].sum() == 2


def test_env_files_match_jax(tmp_path, monkeypatch):
    pytest.importorskip("jax")
    from skyrim_tpu.utils import env as JE

    from skyrim_tpu_torch.utils import env as E

    (tmp_path / ".env").write_text("# creds\nCDSAPI_KEY='k-1'\nECMWF_API_KEY=e\nECMWF_API_EMAIL=\"a@b\"\nbad line\n")
    out = {}
    for name, mod in (("port", E), ("jax", JE)):
        home = tmp_path / name
        home.mkdir()
        monkeypatch.setenv("HOME", str(home))
        for k in ("CDSAPI_KEY", "CDSAPI_URL", "ECMWF_API_KEY", "ECMWF_API_EMAIL", "ECMWF_API_URL"):
            monkeypatch.delenv(k, raising=False)
        assert mod.load_dotenv(tmp_path / ".env") == {"CDSAPI_KEY": "k-1", "ECMWF_API_KEY": "e",
                                                     "ECMWF_API_EMAIL": "a@b"}
        assert mod.ensure_cds_loaded(tmp_path / ".env") and mod.ensure_ecmwf_loaded(tmp_path / ".env")
        out[name] = [(home / f).read_text() for f in (".cdsapirc", ".ecmwfapirc")]
    assert out["port"] == out["jax"]
    monkeypatch.delenv("CDSAPI_KEY")
    assert not E.ensure_cds_loaded(tmp_path / "missing.env")


def test_profiling_trace_annotate_and_step_timer(tmp_path):
    """``trace`` writes the Chrome trace, and an ``annotate`` span inside it
    is a range of the trace and of the op table."""
    from skyrim_tpu_torch.utils.profiling import annotate, trace

    with trace(str(tmp_path / "tr")) as prof:
        with annotate("skyrim_region"):
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    trace_json = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert any(e.get("name") == "skyrim_region" for e in trace_json["traceEvents"])
    assert any(e.key == "skyrim_region" for e in prof.key_averages())


# --- utils/op_stats.py -------------------------------------------------------------------


def test_collect_op_stats_on_cpu_steps():
    from skyrim_tpu_torch.utils.op_stats import collect_op_stats

    a = torch.randn(128, 128)

    def step(x):
        return torch.relu(x @ x).sum()

    stats = collect_op_stats(step, (a,), n_steps=3, device="cpu")
    names = [r[3] for r in stats.rows]
    assert "aten::mm" in names and len(set(names)) == len(names)
    assert [r[0] for r in stats.rows] == sorted((r[0] for r in stats.rows), reverse=True)
    assert sum(r[1] for r in stats.rows) == pytest.approx(1.0)
    assert stats.total_us == pytest.approx(sum(r[0] for r in stats.rows))
    # self time, not the sum over nested events: matmul's time is its mm's
    mm = dict((r[3], r) for r in stats.rows)
    assert mm["aten::matmul"][2] >= mm["aten::mm"][0] > mm["aten::matmul"][0]
    assert 0 < stats.busy_us <= stats.wall_us and 0 <= stats.idle_share < 1


def test_op_stats_main_prints_the_table(monkeypatch, capsys):
    from skyrim_tpu_torch import models
    from skyrim_tpu_torch.models.pangu import PanguConfig, PanguModel
    from skyrim_tpu_torch.utils import op_stats

    cfg = PanguConfig(lat=49, lon=96, embed_dim=16, depths=(1, 1, 1, 1), num_heads=(2, 2, 2, 2))
    monkeypatch.setitem(models.MODELS, "pangu", lambda device: PanguModel("pangu", cfg=cfg, device=device))
    op_stats.main(["pangu", "1", "5", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("pangu: ") and "idle share" in out[0] and len(out) == 6


# --- utils/op_bytes.py, utils/roofline.py ---------------------------------------------


def _tiny_pangu():
    from skyrim_tpu_torch.models.pangu import PanguConfig, PanguModel

    cfg = PanguConfig(lat=49, lon=96, embed_dim=16, depths=(2, 2, 2, 2), num_heads=(2, 2, 2, 2))
    model = PanguModel("pangu", cfg=cfg, device="cpu")
    params = model.init_params()
    return model, params, model.init_state(params, torch.zeros(model.state_shape[1:]))


def test_op_bytes_charges_each_kernel_once():
    """A kernel call is charged its declared cost and none of its plain
    version's ops; a Pangu step charges 8 K1, 8 K2, 1 K3 and 1 K4."""
    from skyrim_tpu_torch.ops.roll import roll3d
    from skyrim_tpu_torch.utils.op_bytes import count_step, step_counts, tensor_bytes

    x = torch.randn(2, 6, 24, 16)
    with count_step() as res:
        roll3d(x, (1, 2, 3))
    assert (res["op_bytes"], res["op_flops"], res["kernel_bytes"]) == (0, 0, 2 * x.numel() * 4)
    with count_step() as res:
        torch.roll(x, (1, 2, 3), (0, 1, 2))
        x.view(-1).expand(3, -1).sum(0)  # a view charges nothing, a broadcast operand its distinct bytes
    assert res["op_bytes"] == 2 * x.numel() * 4 + (x.numel() + x.numel()) * 4 and res["kernel_bytes"] == 0
    assert tensor_bytes(x.view(-1).expand(3, -1)) == x.numel() * 4

    model, params, state = _tiny_pangu()
    res = step_counts(model, params, state)
    assert {k: v["calls"] for k, v in res["kernels"].items()} == {"K1": 8, "K2": 8, "K3": 1, "K4": 1}
    assert res["kernel_bytes"] == sum(v["bytes_accessed"] for v in res["kernels"].values())
    ops = {r[0] for r in res["top_ops"]}
    assert not ops & {"bmm", "_softmax", "native_layer_norm", "roll"}, ops  # K1's and K2's plain versions
    assert res["op_flops"] > 0 and res["bytes"] == res["kernel_bytes"] + res["op_bytes"]
    # the count does not depend on the step (a second advance from the same state)
    assert step_counts(model, params, state)["bytes"] == res["bytes"]


ROOF_CASES = [(0.037, 8.9e12, 4.1e10, 1.2e9), (0.5, 1e12, 1.2e12, 9e11), (0.1, 2e12, 4e11, 1e9),
              (0.02, 3e12, 1e9, None), (0.0, 1e12, 1e9, 1e8)]


@pytest.mark.parametrize("case", ROOF_CASES)
def test_roofline_matches_jax(case, monkeypatch):
    pytest.importorskip("jax")
    from skyrim_tpu.utils.roofline import roofline as jroofline

    from skyrim_tpu_torch.utils.roofline import roofline

    monkeypatch.setenv("SKYRIM_PEAK_TFLOPS", "989")
    monkeypatch.setenv("SKYRIM_PEAK_HBM_GBS", "3350")
    wall, flops, bytes_, floor = case
    got, want = roofline(wall, flops, bytes_, floor), jroofline(wall, flops, bytes_, floor)
    assert got.pop("bytes_basis") == "torch_dispatch_ops_and_kernel_cost_estimates"
    want.pop("bytes_basis")
    assert got == want


def test_device_peaks(monkeypatch):
    from skyrim_tpu_torch.utils.roofline import device_peaks

    for k in ("SKYRIM_PEAK_TFLOPS", "SKYRIM_PEAK_HBM_GBS"):
        monkeypatch.delenv(k, raising=False)
    assert device_peaks("NVIDIA H100 80GB HBM3") == (989e12, 3.35e12)
    with pytest.raises(ValueError, match="SKYRIM_PEAK_TFLOPS and SKYRIM_PEAK_HBM_GBS"):
        device_peaks("TPU v5 lite")
    with pytest.raises(ValueError, match="SKYRIM_PEAK_TFLOPS"):
        device_peaks(torch.device("cpu"))
    monkeypatch.setenv("SKYRIM_PEAK_HBM_GBS", "2000")
    assert device_peaks("NVIDIA H100 PCIe") == (989e12, 2e12)
    monkeypatch.setenv("SKYRIM_PEAK_TFLOPS", "100")
    assert device_peaks("cpu") == (100e12, 2e12)


def test_model_roofline_on_cpu_steps(monkeypatch):
    from skyrim_tpu_torch.utils.op_bytes import step_counts
    from skyrim_tpu_torch.utils.roofline import floor_bytes, model_roofline

    monkeypatch.setenv("SKYRIM_PEAK_TFLOPS", "989")
    monkeypatch.setenv("SKYRIM_PEAK_HBM_GBS", "3350")
    model, params, state = _tiny_pangu()
    res = step_counts(model, params, state)
    r = model_roofline(model, params, state, 0.01)
    assert (r["flops"], r["bytes"]) == (res["flops"], res["bytes"])
    assert r["bytes_floor_gb"] == round(floor_bytes(model, params, state) / 2**30, 2)
    assert r["bound"] in ("compute", "memory", "between-bounds")


@pytest.mark.parametrize("name", ["sfno", "fuxi"])
def test_floor_bytes_matches_jax(name):
    """The same leaves in the same dtypes (SFNO's f32 tree; FuXi's bf16
    stages, of which ``floor_params`` takes one) give JAX's floor.  The
    derived caches differ between the packages (the port's SFNO keeps a bf16
    copy of its position embedding) and stay out of both trees."""
    jax = pytest.importorskip("jax")
    from skyrim_tpu.utils.roofline import floor_bytes as jfloor

    from skyrim_tpu_torch.params import from_jax
    from skyrim_tpu_torch.utils.roofline import floor_bytes

    if name == "sfno":
        from test_torch_finetune import _sfno

        jm, tree, model = _sfno()
    else:
        from test_torch_finetune import _fuxi

        jm, tree, model = _fuxi(True)()
    params = {k: v for k, v in from_jax(tree, model).items() if k != "cache"}
    x0 = np.random.default_rng(0).normal(size=model.state_shape).astype(np.float32)
    jtree = {k: v for k, v in jax.tree.map(jax.numpy.asarray, tree).items() if k != "cache"}
    want = jfloor(jm, jtree, jm.init_state(jtree, x0))
    assert floor_bytes(model, params, model.init_state(params, x0)) == want
