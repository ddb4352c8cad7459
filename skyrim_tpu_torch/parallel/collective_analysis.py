"""Per-step collective traffic and a modeled scaling efficiency (port, by
intent, of skyrim_tpu/parallel/collective_analysis.py).

The JAX module compiles a sharded step and walks its HLO for the
collectives XLA inserted.  Here no compiler partitions a step: every
exchange is an explicit call of ``parallel/mesh.py`` (``ring_exchange``,
``all_gather``, ``all_reduce_``, ``broadcast_``), so the traffic is counted
as it happens.  ``analyze_model`` runs one sharded step under
``mesh.count_exchanges`` and sums what this rank sent, by kind, in the
records of the JAX module (``kind``, ``bytes``, ``ici_bytes``,
``group_size``).  ``ici_bytes`` is named as in the JAX package: the bytes
one rank pushes over its links under the ring model, whatever the links
are (NVLink between the cards of a host here).

The projections combine that count with a measured single-device step and
a link bandwidth, which every function takes as an argument.  Where the
H100's figure is used it is NVIDIA's published NVLink 4 rate for the H100
SXM (900 GB/s in both directions together, so 450e9 B/s each way,
``H100_NVLINK_BW``) — a datasheet figure, not a measurement.  The model is
the JAX module's: collective time fully serialized with compute, no
overlap.
"""

from __future__ import annotations

import json

import numpy as np
import torch

#: NVIDIA's published NVLink 4 bandwidth of an H100 SXM, one direction (B/s)
H100_NVLINK_BW = 450e9


def summarize(colls: list[dict]) -> dict:
    by_kind: dict[str, dict] = {}
    for c in colls:
        k = by_kind.setdefault(c["kind"], {"count": 0, "bytes": 0, "ici_bytes": 0})
        k["count"] += 1
        k["bytes"] += c["bytes"]
        k["ici_bytes"] += c["ici_bytes"]
    return {
        "n_collectives": len(colls),
        "total_payload_bytes": sum(c["bytes"] for c in colls),
        "total_ici_bytes": sum(c["ici_bytes"] for c in colls),
        "by_kind": by_kind,
    }


def project_efficiency(
    t_step_1dev_s: float,
    ici_bytes_per_step: int,
    n_devices: int,
    spatial_split: int | None = None,
    link_bw: float = H100_NVLINK_BW,
) -> dict:
    """Conservative scaling projection for one sharded step.

    t_comp = measured single-device wall / spatial_split (the manual lon
    path splits every kernel's token count evenly); t_link = link bytes /
    ``link_bw`` (one link, one direction), fully serialized with compute.
    ``dp`` ranks carry independent members, so the aggregate efficiency
    reduces to the same expression, t_comp / (t_comp + t_link)."""
    spatial = spatial_split or n_devices
    t_comp = t_step_1dev_s / spatial
    t_ici = ici_bytes_per_step / link_bw
    eff = t_comp / (t_comp + t_ici) if (t_comp + t_ici) > 0 else 0.0
    return {
        "devices": n_devices,
        "spatial_split": spatial,
        "t_comp_s": round(t_comp, 5),
        "t_ici_s": round(t_ici, 5),
        "projected_step_s": round(t_comp + t_ici, 5),
        "projected_efficiency": round(eff, 4),
        "binding_term": "compute" if t_comp >= t_ici else "ici",
        "link_bw": link_bw,
        "assumptions": "no compute/comm overlap; ring hops serialized",
    }


def _initial(model, params, x0):
    if x0 is None:
        x0 = np.zeros(model.state_shape, np.float32)
    return model.init_state(params, x0)


def analyze_model(model, mesh, t_step_1dev_s: float | None, params=None, x0=None,
                  link_bw: float = H100_NVLINK_BW) -> dict:
    """Count this rank's exchanges during one ``sharded_advance`` of
    ``model`` on ``mesh`` (every rank of the mesh calls it alike); attach
    the efficiency projection when a measured single-device step wall is
    given.  ``params``: the model's (seed-0 parameters by default); ``x0``:
    the full initial state (zeros by default)."""
    from skyrim_tpu_torch.parallel.mesh import AXES, count_exchanges
    from skyrim_tpu_torch.parallel.sharding import shard_state, sharded_advance

    if params is None:
        params = model.init_params(torch.Generator().manual_seed(0))
    advance = sharded_advance(model, mesh)
    state = shard_state(mesh, _initial(model, params, x0))
    with count_exchanges() as colls:
        advance(params, state)
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    spatial = mesh.shape.get(AXES.lon, 1) * mesh.shape.get(AXES.lat, 1)
    summary = summarize(colls)
    if spatial >= 2 and spatial % 2 == 0:
        # egress if this spatial ring spanned 2 hosts of spatial/2 devices
        summary["dcn_bytes_per_host_2host"] = int(dcn_egress_per_host(colls, spatial, spatial // 2))
    out = {
        "mode": advance.mode,
        "count_source": "mesh.count_exchanges",
        "mesh": dict(mesh.shape),
        "grid": list(model.grid.shape) + [len(model.channels)],
        "collectives": summary,
    }
    if model.device.type == "cuda":
        out["peak_gib"] = round(torch.cuda.max_memory_allocated(model.device) / 2**30, 2)
    if t_step_1dev_s:
        out["projection"] = project_efficiency(
            t_step_1dev_s, summary["total_ici_bytes"], mesh.size, spatial_split=spatial, link_bw=link_bw)
        out["projection"]["t_step_1dev_s"] = t_step_1dev_s
    return out


def analyze_dp_ensemble(model, mesh, t_step_1dev_s: float | None, params=None,
                        link_bw: float = H100_NVLINK_BW) -> dict:
    """Exchanges of the dp-ensemble decomposition: ``dp`` members, one call
    of ``frames_out`` steps each (``sharding.dp_ensemble_rollout``).  Members
    are independent rollouts; the one exchange is the gather of their
    outputs at the end, which this counts rather than asserts."""
    from skyrim_tpu_torch.parallel.mesh import AXES, count_exchanges
    from skyrim_tpu_torch.parallel.sharding import dp_ensemble_rollout

    n = mesh.shape[AXES.dp]
    if params is None:
        params = model.init_params(torch.Generator().manual_seed(0))
    x0 = np.zeros((n, *model.state_shape), np.float32)
    run = dp_ensemble_rollout(model, mesh, n_steps=model.frames_out)
    with count_exchanges() as colls:
        run(params, x0)
    out = {
        "mode": "dp_ensemble",
        "count_source": "mesh.count_exchanges",
        "mesh": dict(mesh.shape),
        "grid": list(model.grid.shape) + [len(model.channels)],
        "collectives": summarize(colls),
    }
    if t_step_1dev_s:
        # dp splits members, not one member's step: ideal aggregate
        # throughput is N× one device; only exchange time detracts
        t_ici = out["collectives"]["total_ici_bytes"] / link_bw
        eff = t_step_1dev_s / (t_step_1dev_s + t_ici)
        out["projection"] = {
            "devices": mesh.size,
            "t_comp_s": round(t_step_1dev_s, 5),
            "t_ici_s": round(t_ici, 6),
            "projected_efficiency": round(eff, 4),
            "binding_term": "compute" if t_step_1dev_s >= t_ici else "ici",
            "t_step_1dev_s": t_step_1dev_s,
            "link_bw": link_bw,
        }
    return out


def measured_step_wall(model_name: str, path: str = "build/chip_smoke_results.json") -> float | None:
    """The median step wall (s) of ``model_name``'s full-width main path as
    ``chip_smoke.py`` measured it on the card (its results line, which the
    script also writes to ``path``), or None without one."""
    try:
        with open(path) as fh:
            res = json.load(fh)
        steps = res["main_path"][model_name]["step_ms"]
        return float(np.median(steps)) / 1e3
    except (OSError, KeyError, TypeError, ValueError):
        return None


def reckon_lon_halo_bytes(model, n_lon: int) -> int:
    """The bytes one rank sends in one lon-sharded step of a window model
    (Pangu), reckoned from its window shapes alone: each block's ring
    extension by ``ww − 1`` tokens left and ``Wc − Wl`` right when its chunk
    or its lon shift is not window-aligned (``fused_shard.manual_swin_block``;
    Pangu's shifts are half a window), nothing otherwise; a halo whose hop
    comes round to the rank itself is not sent."""
    cfg = model.cfg
    wz, wh, ww = cfg.window
    Zt = cfg.z_tokens
    Ht, Wt = cfg.hw_tokens
    isz = torch.tensor([], dtype=model.compute_dtype).element_size()

    def up(a, b):
        return -(-a // b) * b

    def halo(Z, H, C, Wl, tokens) -> int:
        # tokens fetched over hops of Wl each; the last hop the remainder
        sent, hop = 0, 1
        while tokens > 0:
            take = min(Wl, tokens)
            if hop % n_lon:
                sent += Z * H * take * C * isz
            tokens -= take
            hop += 1
        return sent

    total = 0
    stages = ((up(Zt, wz), up(Ht, wh), Wt, cfg.embed_dim),
              (up(Zt, wz), up(-(-Ht // 2), wh), Wt // 2, 2 * cfg.embed_dim))
    for s, depth in enumerate(cfg.depths):
        Z, H, W, C = stages[0 if s in (0, 3) else 1]
        Wl = W // n_lon
        for b in range(depth):
            s2 = ww // 2 if b % 2 else 0
            if Wl % ww == 0 and s2 % ww == 0:
                continue  # the block is local
            Wc = min((-(-Wl // ww) + 1) * ww, W)
            total += halo(Z, H, C, Wl, ww - 1) + halo(Z, H, C, Wl, Wc - Wl)
    return total


# ---------------------------------------------------------------------------
# the cross-host tier
# ---------------------------------------------------------------------------


def dcn_egress_per_host(colls: list[dict], n_devices: int, devices_per_host: int) -> float:
    """Per-step egress bytes of ONE host for a spatial decomposition spanning
    hosts (devices laid out linearly: host = device // C), per collective
    kind on an n-ring with contiguous C-device hosts (the JAX module's
    model): a permute shifted by k sends min(k, C) payloads across each
    boundary; an all-gather ≈ result·(g−1)/g; a reduce-scatter result·(g−1);
    an all-reduce 2·bytes·(g−1)/g; a broadcast its payload once; an
    all-to-all C·bytes·(n−C)/n."""
    C = devices_per_host
    if n_devices <= C:
        return 0.0
    total = 0.0
    for c in colls:
        b, g, kind = c["bytes"], c["group_size"], c["kind"]
        if kind == "collective-permute":
            k = (c["ici_bytes"] // b) if b else 0
            total += min(k, C) * b
        elif kind == "all-gather":
            total += b * (g - 1) / max(g, 1)
        elif kind == "reduce-scatter":
            total += b * (g - 1)
        elif kind == "all-reduce":
            total += 2 * b * (g - 1) / max(g, 1)
        elif kind == "broadcast":
            total += b
        else:  # all-to-all
            total += C * b * (n_devices - C) / max(n_devices, 1)
    return total


def project_multihost(
    t_step_1dev_s: float,
    ici_bytes_N: int,
    dcn_bytes_per_host: float,
    n_devices: int,
    devices_per_host: int,
    ici_bytes_C: int,
    link_bw: float,
    dcn_bw: float,
) -> dict:
    """1 → H hosts scaling efficiency for a spatial decomposition that SPANS
    hosts: eff = (C·t_step(C)) / (N·t_step(N)), with t_step(N) = t_comp/N +
    t_link(N) + t_host(N), no overlap.  ``link_bw``: one intra-host link,
    one direction; ``dcn_bw``: one host's network egress (B/s)."""
    C = devices_per_host
    H = n_devices // C
    t_comp = t_step_1dev_s
    t_C = t_comp / C + ici_bytes_C / link_bw
    t_N = t_comp / n_devices + ici_bytes_N / link_bw + dcn_bytes_per_host / dcn_bw
    eff = (C * t_C) / (n_devices * t_N) if t_N > 0 else 0.0
    terms = {
        "t_comp/N": t_comp / n_devices,
        "t_ici": ici_bytes_N / link_bw,
        "t_dcn": dcn_bytes_per_host / dcn_bw,
    }
    return {
        "hosts": H,
        "devices_per_host": C,
        "devices": n_devices,
        "t_step_1host_s": round(t_C, 5),
        "t_step_multihost_s": round(t_N, 5),
        "dcn_bytes_per_host_per_step": int(dcn_bytes_per_host),
        "t_dcn_s": round(terms["t_dcn"], 5),
        "projected_efficiency_1_to_H_hosts": round(eff, 4),
        "binding_term": max(terms, key=terms.get),
        "assumptions": (
            "linear host layout (host = device // devices_per_host); no "
            "compute/comm overlap; host egress serialized per host at "
            f"{dcn_bw / 1e9:.0f} GB/s"
        ),
    }
