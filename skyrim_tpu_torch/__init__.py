"""skyrim_tpu_torch — the PyTorch/CUDA port of skyrim_tpu.

A second package beside the JAX one, which stays the reference.  Plain
tensor code is PyTorch; every Pallas kernel on a ported path is a CUDA
kernel written by hand for Hopper (``csrc/``, built at first use by
``ops/_build.py``), with a plain PyTorch version beside it that CPU
tensors take.  Entry points run on the card unless the caller passes
``device="cpu"``.  This package imports neither jax nor skyrim_tpu.

Ported end to end: the seven models (``models.MODELS``: Pangu-Weather,
GraphCast, FourCastNet v2, FengWu, FuXi, FourCastNet v1, DLWP) through
``core.Skyrim``/``core.GlobalModel``, multi-model ensembles
(``core.GlobalEnsemble``), initial-condition ensembles
(``core.ic_ensemble``), and the weight readers (``weights``: the port's
checkpoints, torch state dicts, ONNX artifacts, GraphCast's Haiku
parameters), and the data and IO layers (``data``: GRIB decoding and the
GFS, IFS, ENS and CDS initial-condition sources; ``io``: NetCDF, Zarr,
fsspec and ``hf://`` outputs and ``stream_save_forecast``; ``evaluate``:
skill scores).
"""

__version__ = "0.1.0"

_LAZY = {
    "SaveConfig": ("skyrim_tpu_torch.io", "SaveConfig"),
    "save_forecast": ("skyrim_tpu_torch.io", "save_forecast"),
    "load_forecast": ("skyrim_tpu_torch.io", "load_forecast"),
    "read_forecast": ("skyrim_tpu_torch.io", "read_forecast"),
}


def __getattr__(name):
    # lazy, so that ``import skyrim_tpu_torch`` stays light
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'skyrim_tpu_torch' has no attribute {name!r}")
