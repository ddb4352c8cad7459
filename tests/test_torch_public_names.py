"""The JAX package's public names, each with a counterpart in the port.

The JAX modules are read with ``ast``, not imported: a module's public
names are its top-level defs, classes and assigned names that do not
start with ``_`` (inside top-level ``if``/``try`` blocks too), the names an
``__init__.py`` re-exports with ``from … import``, and the keys of an
``__init__.py``'s ``_LAZY`` table.  Each must resolve on the port's module
of the same path (``skyrim_tpu.x.y`` → ``skyrim_tpu_torch.x.y``), or stand in
``NOT_PORTED`` with its reason (ROADMAP.md §1, "Not ported, on purpose") or
in ``RENAMED`` with the port's name, which must exist.  Every entry of the
two tables must still name a module or name of the JAX package, so
neither table goes stale.

Then the names this walk found missing once, held to the JAX package's
values: the package root's exports (the lazy ones the same objects as
their module paths; ``import skyrim_tpu_torch`` importing no torch), the
model list and each model's channels, the Earth radius, the ``utils``
re-exports, and the host-side solar functions on the ``datetime``s and
grid of tests/data/test_solar.py, bit for bit (both are the same numpy
arithmetic in the same order).
"""

import ast
import datetime
import importlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")  # the card's machine has no JAX

REPO = Path(__file__).resolve().parents[1]
JAX_ROOT = REPO / "skyrim_tpu"

# module, or "module.name" → why the port has no counterpart (ROADMAP.md §1)
NOT_PORTED = {
    "skyrim_tpu.ops.dft": "a matmul DFT because XLA's FFT is slow on a TPU; the port calls torch.fft (cuFFT)",
    "skyrim_tpu.utils.hlo_bytes": "walks XLA's HLO; the port counts dispatched ops (utils/op_bytes.py)",
    "skyrim_tpu.parallel.collective_analysis.collect_collectives":
        "parses HLO text; the port counts exchanges as they are sent (parallel/mesh.py count_exchanges)",
    "skyrim_tpu.parallel.collective_analysis.collect_collectives_stablehlo":
        "parses StableHLO; the port counts exchanges as they are sent (parallel/mesh.py count_exchanges)",
    "skyrim_tpu.parallel.collective_analysis.V5E_ICI_LINK_BW": "a TPU v5e link rate; no such link on a GPU host",
    "skyrim_tpu.parallel.collective_analysis.V5E_DCN_HOST_BW": "a TPU v5e host network rate; no GPU counterpart",
    "skyrim_tpu.ops.graph.chunk_static": "GraphCast's XLA chunk-scan fallback; the port runs the tiled kernels only",
    "skyrim_tpu.ops.flash_window_attention.use_pallas":
        "the switch between Pallas and XLA; a port wrapper chooses by its tensor's device and ops.vjp.plain_versions",
    "skyrim_tpu.ops.flash_window_attention.xla_fallback":
        "the XLA path beside Pallas; the port's plain versions take CPU tensors and ops.vjp.plain_versions",
    "skyrim_tpu.ops.fused_block.DenseParams": "a NamedTuple of the Pallas wrapper's operands; the port takes (kernel, bias)",
    "skyrim_tpu.ops.fused_block.LNParams": "a NamedTuple of the Pallas wrapper's operands; the port takes (scale, bias)",
    "skyrim_tpu.models.fuxi.SwinPair": "a flax module pairing two blocks for nn.scan; the port loops over the stacked leaves",
    "skyrim_tpu.parallel.mesh.replicated":
        "a jax.sharding.NamedSharding; the port's ranks replicate by parallel.sharding.replicate",
    "skyrim_tpu.parallel.mesh.state_sharding":
        "a jax.sharding.NamedSharding of the state; the port's ranks hold lon chunks (parallel/sharding.py)",
    "skyrim_tpu.parallel.halo.shard_map": "jax.shard_map; the port's ranks are processes over torch.distributed",
}
# "module.name" → the port's name in the counterpart module
RENAMED = {
    "skyrim_tpu.ops.fused_block.fused_swin_block_4d": "fused_swin_block",
    "skyrim_tpu.quantize.QuantizedArray": "QuantizedTensor",
    "skyrim_tpu.data.solar.toa_incident_solar_radiation_jax": "toa_incident_solar_radiation_torch",
    "skyrim_tpu.data.solar.clock_features_jax": "clock_features_torch",
}


def _module_name(path: Path) -> str:
    parts = path.relative_to(REPO).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


JAX_MODULES = {_module_name(p): p for p in sorted(JAX_ROOT.rglob("*.py"))}


def _names(stmts, init: bool) -> set[str]:
    out = set()
    for node in stmts:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out |= {n.id for t in node.targets for n in ast.walk(t) if isinstance(n, ast.Name)}
            if init and any(isinstance(t, ast.Name) and t.id == "_LAZY" for t in node.targets):
                out |= {k.value for k in node.value.keys}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out.add(node.target.id)
        elif isinstance(node, ast.ImportFrom) and init and node.module != "__future__":
            out |= {a.asname or a.name for a in node.names}
        elif isinstance(node, (ast.If, ast.Try)):
            handlers = [s for h in getattr(node, "handlers", ()) for s in h.body]
            out |= _names(node.body + node.orelse + getattr(node, "finalbody", []) + handlers, init)
    return {n for n in out if not n.startswith("_")}


def public_names(module: str) -> set[str]:
    path = JAX_MODULES[module]
    return _names(ast.parse(path.read_text()).body, path.name == "__init__.py")


def counterpart(module: str) -> str:
    return "skyrim_tpu_torch" + module[len("skyrim_tpu"):]


@pytest.mark.parametrize("module", sorted(JAX_MODULES))
def test_public_names_have_counterparts(module):
    if module in NOT_PORTED:
        with pytest.raises(ModuleNotFoundError):
            importlib.import_module(counterpart(module))
        return
    port = importlib.import_module(counterpart(module))
    missing = []
    for name in sorted(public_names(module)):
        key = f"{module}.{name}"
        if key in RENAMED:
            assert hasattr(port, RENAMED[key]), f"{key} is renamed to {RENAMED[key]}, which {port.__name__} lacks"
        elif key not in NOT_PORTED and not hasattr(port, name):
            missing.append(name)
    assert not missing, f"{counterpart(module)} lacks {missing}"


@pytest.mark.parametrize("key", sorted(NOT_PORTED) + sorted(RENAMED))
def test_tables_name_what_the_jax_package_has(key):
    """Each entry names a JAX module, or a public name of one, and gives a
    reason or a name the port has."""
    if key in JAX_MODULES:
        assert key in NOT_PORTED
    else:
        module, name = key.rsplit(".", 1)
        assert module in JAX_MODULES and name in public_names(module), f"{key} is gone from the JAX package"
    if key in RENAMED:
        module = key.rsplit(".", 1)[0]
        assert hasattr(importlib.import_module(counterpart(module)), RENAMED[key])
    else:
        assert len(NOT_PORTED[key]) > 20


# --- the root ---------------------------------------------------------------------------

LAZY = {
    "Skyrim": "skyrim_tpu_torch.core", "GlobalModel": "skyrim_tpu_torch.core",
    "GlobalEnsemble": "skyrim_tpu_torch.core", "GlobalPrediction": "skyrim_tpu_torch.core",
    "GlobalPredictionRollout": "skyrim_tpu_torch.core", "MODELS": "skyrim_tpu_torch.models",
    "ic_ensemble_forecast": "skyrim_tpu_torch.core.ic_ensemble", "SaveConfig": "skyrim_tpu_torch.io",
    "save_forecast": "skyrim_tpu_torch.io", "load_forecast": "skyrim_tpu_torch.io",
    "read_forecast": "skyrim_tpu_torch.io",
}  # fmt: skip


@pytest.mark.parametrize("name", sorted(LAZY))
def test_root_lazy_names_are_their_modules_objects(name):
    import skyrim_tpu_torch

    assert name in public_names("skyrim_tpu")
    assert getattr(skyrim_tpu_torch, name) is getattr(importlib.import_module(LAZY[name]), name)


@pytest.mark.parametrize("name", ["CHANNEL_SETS", "parse_channel", "Field"])
def test_root_eager_names(name):
    import skyrim_tpu
    import skyrim_tpu_torch
    from skyrim_tpu_torch import channels, field

    assert getattr(skyrim_tpu_torch, name) is getattr(channels if name != "Field" else field, name)
    if name == "CHANNEL_SETS":
        assert skyrim_tpu_torch.CHANNEL_SETS == skyrim_tpu.CHANNEL_SETS
    if name == "parse_channel":
        for ch in ("t850", "msl", "u10m", "z500"):
            assert vars(skyrim_tpu_torch.parse_channel(ch)) == vars(skyrim_tpu.parse_channel(ch))


def test_root_import_is_light():
    """``import skyrim_tpu_torch`` imports neither torch nor a model module;
    a lazy name then imports what it needs."""
    code = (
        "import sys\n"
        "import skyrim_tpu_torch as s\n"
        "heavy = sorted(m for m in sys.modules if m == 'torch' or m.startswith('skyrim_tpu_torch.models'))\n"
        "assert not heavy, heavy\n"
        "s.MODELS['pangu']\n"
        "assert 'skyrim_tpu_torch.models.pangu' in sys.modules\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr


# --- models, grid, utils ---------------------------------------------------------------


def test_available_models_are_jax_s():
    from skyrim_tpu.models import AVAILABLE_MODELS as JAX_MODELS

    from skyrim_tpu_torch.models import AVAILABLE_MODELS, MODELS

    assert AVAILABLE_MODELS == JAX_MODELS
    assert sorted(MODELS) == sorted(AVAILABLE_MODELS)


@pytest.mark.parametrize("name", ["pangu", "fourcastnet", "fourcastnet_v2", "dlwp", "graphcast", "fuxi", "fengwu"])
def test_model_channels_are_jax_s(name):
    from skyrim_tpu.models.base import model_channels as jax_channels

    from skyrim_tpu_torch.models import MODELS
    from skyrim_tpu_torch.models.base import model_channels

    assert model_channels(name) == jax_channels(name)
    assert tuple(model_channels(name)) == tuple(MODELS[name].channels)


def test_earth_radius_is_jax_s():
    from skyrim_tpu.grid import EARTH_RADIUS_M as JAX_RADIUS

    from skyrim_tpu_torch.grid import EARTH_RADIUS_M

    assert EARTH_RADIUS_M == JAX_RADIUS == 6_371_000.0


@pytest.mark.parametrize("name,module", [("logger", "logging"), ("timeit", "timing"), ("Timer", "timing")])
def test_utils_reexports(name, module):
    import skyrim_tpu_torch.utils as U

    assert getattr(U, name) is getattr(importlib.import_module(f"skyrim_tpu_torch.utils.{module}"), name)


# --- the host-side solar functions -------------------------------------------------------

LAT = np.linspace(90, -90, 19)  # tests/data/test_solar.py's grid
LON = np.arange(0, 360, 10.0)
WHEN = [datetime.datetime(2024, 6, 21, 12), datetime.datetime(2024, 3, 20, 12), datetime.datetime(2024, 5, 1, 0),
        datetime.datetime(2024, 12, 21), datetime.datetime(1999, 7, 14, 17, 30)]
SOLAR = {
    "solar_declination": lambda f, t: f(t),
    "eccentricity_factor": lambda f, t: f(t),
    "toa_incident_solar_radiation": lambda f, t: np.stack([f(t, LAT, LON, integration_hours=h) for h in (0.5, 1, 6)]),
    "clock_features": lambda f, t: f(t, LAT, LON),
}


@pytest.mark.parametrize("when", WHEN, ids=lambda t: t.strftime("%Y%m%d%H%M"))
@pytest.mark.parametrize("name", sorted(SOLAR))
def test_host_solar_functions_equal_jax_s(name, when):
    from skyrim_tpu.data import solar as jax_solar

    from skyrim_tpu_torch.data import solar

    out, ref = SOLAR[name](getattr(solar, name), when), SOLAR[name](getattr(jax_solar, name), when)
    assert np.asarray(out).dtype == np.asarray(ref).dtype
    np.testing.assert_array_equal(out, ref)
