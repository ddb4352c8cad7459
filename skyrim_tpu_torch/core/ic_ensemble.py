"""Initial-condition ensembles (port of skyrim_tpu/core/ic_ensemble.py).

Perturb the analysis, roll every member out, and return the (number,
time, channel, lat, lon) contract of the ECMWF ENS product, so model
ensembles and that product are interchangeable downstream.

``mesh=None`` runs the members in turn on one device against one
resident parameter set, loaded once: the semantics of the JAX package's
``vmap`` over members.  A ``parallel.mesh.Mesh`` runs them over the mesh,
one process per rank (``parallel/sharding.py`` ``dp_ensemble_rollout``):
members split over ``dp``, each member's state sharded over (lat, lon),
and every rank returns the same Field.  Unlike the JAX package, no mesh is
built here: the ranks are processes the caller started.
"""

from __future__ import annotations

import datetime

import numpy as np

from skyrim_tpu_torch.core.model import GlobalModel
from skyrim_tpu_torch.field import Field
from skyrim_tpu_torch.parallel.mesh import Mesh
from skyrim_tpu_torch.parallel.sharding import dp_ensemble_rollout
from skyrim_tpu_torch.rollout import initial_condition_from_field, rollout_times
from skyrim_tpu_torch.utils.logging import logger


def perturb_members(
    x0: np.ndarray,
    n_members: int,
    scale: float = 0.01,
    seed: int = 0,
) -> np.ndarray:
    """Member ICs: member 0 is the control; others get Gaussian noise
    scaled per channel by that channel's spatial std (the natural unit —
    channels span Pa to kg/kg)."""
    rng = np.random.default_rng(seed)
    stds = x0.std(axis=(-2, -1), keepdims=True)
    members = [x0]
    for _ in range(n_members - 1):
        noise = rng.standard_normal(x0.shape).astype(np.float32)
        members.append(x0 + scale * stds * noise)
    return np.stack(members)


def ic_ensemble_forecast(
    model_name: str,
    start_time: datetime.datetime,
    n_steps: int = 4,
    n_members: int = 4,
    perturb_scale: float = 0.01,
    ic_source: str = "gfs",
    mesh=None,
    seed: int = 0,
    model_kwargs: dict | None = None,
    params=None,
    device="cuda",
) -> Field:
    """Run an IC-perturbation ensemble; returns (number, time, channel,
    lat, lon).  ``seed`` draws the perturbations; ``params`` the port's
    parameters (``weights.load_params`` without them), the same on every
    rank; ``device`` the card unless the caller asks for the CPU (with a
    ``mesh``, the mesh's device); ``mesh`` None or a ``parallel.mesh.Mesh``."""
    if mesh is not None:
        if not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a skyrim_tpu_torch.parallel.mesh.Mesh or None, got {type(mesh).__name__}")
        device = mesh.device
    gm = GlobalModel(model_name, ic_source=ic_source, model_kwargs=model_kwargs, params=params, device=device)
    model = gm.model
    ic_field = gm.data_source.fetch(start_time, model.n_history, model.time_step)
    x0 = initial_condition_from_field(model, ic_field)
    members = perturb_members(x0, n_members, perturb_scale, seed)
    if mesh is None:
        logger.info("IC ensemble: %s × %d members in turn on %s", model_name, n_members, model.device)
    else:
        logger.info("IC ensemble: %s × %d members over mesh %s", model_name, n_members, mesh.shape)
    outputs = dp_ensemble_rollout(model, mesh, n_steps)(gm.params, members, start_time)

    times = rollout_times(start_time, model.time_step, n_steps)
    return Field(
        outputs,
        ("number", "time", "channel", "lat", "lon"),
        coords={
            "number": np.arange(n_members),
            "time": np.asarray([np.datetime64(t.isoformat(), "ns") for t in times]),
            "channel": np.asarray(list(model.channels), dtype=object),
            "lat": model.grid.lat,
            "lon": model.grid.lon,
        },
        attrs={"model": model_name, "perturb_scale": perturb_scale},
    )


def ensemble_mean(members: Field) -> Field:
    return members.mean("number")


def ensemble_spread(members: Field) -> Field:
    """Per-point ensemble standard deviation."""
    ax = members.axis("number")
    data = members.data.std(axis=ax)
    dims = tuple(d for d in members.dims if d != "number")
    coords = {k: v for k, v in members.coords.items() if k != "number"}
    return Field(data, dims, coords, dict(members.attrs))
