"""GraphCast — icosahedral multimesh GNN (port of skyrim_tpu/models/graphcast.py).

83 channels on 721×1440 with a 2-frame history (Lam et al., Science
2023): the grid input (2 frames, 5 forcings, 3 static features) is
embedded per grid point, encoded onto the refinement-6 multimesh
(grid→mesh), passed through 16 processor rounds on the multimesh, decoded
back to the grid (mesh→grid) and mapped to a residual update of the last
frame.

The port takes the path the JAX package takes on an accelerator
(``use_pallas()`` true): the grid→mesh pass over grid-major tiles (K9),
each processor round as one fused round (K7), the mesh→grid pass over
face tiles (K8), and every node and edge MLP through the row MLP (K6).
Every concat-Dense first layer is factored per part (``SplitDense``), so
the static edge-geometry embeddings are computed once per parameter set
into ``params["cache"]`` (``prepare_params``) and the src/dst transforms
run per node, not per edge; those per-node products (``src_part``,
``dst_part``) stay ``torch.matmul``, as the JAX package leaves them to
XLA.  The static graph tables are built once per model
(``ops/graph.py``) and live on the model's device.

Module and parameter names follow the flax tree
(``net/round_3/MLP_0/Dense_0/kernel`` ↔ ``round_3.MLP_0.Dense_0.kernel``),
Dense kernels are (in, out), so ``params.from_jax`` carries JAX parameters
over leaf by leaf.  Not ported: the JAX package's XLA fallbacks (plan-mode
grid→mesh, chunk-scan mesh→grid, unfused round) and its
``SKYRIM_GC_NO_CACHE`` switch; on the CPU the port runs the plain versions
of the same four kernels instead.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from skyrim_tpu_torch import channels as ch
from skyrim_tpu_torch.data.solar import clock_features_torch, toa_incident_solar_radiation_torch
from skyrim_tpu_torch.grid import LatLonGrid
from skyrim_tpu_torch.models.base import (
    PrognosticModel,
    denormalize,
    init_flax_params_,
    make_norm_params,
    normalize,
)
from skyrim_tpu_torch.models.pangu import Dense, LayerNorm
from skyrim_tpu_torch.ops.fused_mlp import fused_mlp
from skyrim_tpu_torch.ops.graph import (
    build_block_plan,
    build_face_tiles,
    build_g2m_tiles,
    build_graphs,
    g2m_row_plan,
    pad_rows_to_blocks,
)
from skyrim_tpu_torch.ops.graph_kernels import (
    fused_g2m_tiled,
    fused_m2g_tiled,
    fused_round_messages,
)
from skyrim_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class GraphCastConfig:
    lat: int = 721
    lon: int = 1440
    in_channels: int = 83
    latent: int = 512
    processor_rounds: int = 16
    mesh_refinements: int = 6


class MLP(nn.Module):
    """Dense → swish → Dense [→ LayerNorm] over rows, through K6."""

    def __init__(self, din: int, hidden: int, out: int, final_norm: bool = True):
        super().__init__()
        self.Dense_0 = Dense(din, hidden)
        self.Dense_1 = Dense(hidden, out)
        self.LayerNorm_0 = LayerNorm(out) if final_norm else None

    def forward(self, x, x2=None, residual=None, x_transposed=False):
        ln = self.LayerNorm_0.sb() if self.LayerNorm_0 is not None else None
        return fused_mlp(x, self.Dense_0.wb(), self.Dense_1.wb(), ln, x2=x2, residual=residual,
                         x_transposed=x_transposed)


class SplitDense(nn.Module):
    """The parameters of ``nn.Dense(features)`` over a concat of ``in_dim``
    inputs, applied one kernel row block (one concat part) at a time."""

    def __init__(self, features: int, in_dim: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_dim, features))
        self.bias = nn.Parameter(torch.zeros(features))

    def block(self, x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
        """x @ kernel[lo:hi] — one part's contribution, no bias."""
        return x @ self.kernel[lo:hi].to(x.dtype)


class FactoredEdgeMLP(nn.Module):
    """``MLP(L, L)`` over ``concat([e, src, dst])`` with the first layer split
    per part; its finish (swish → Dense₁ → LayerNorm) runs inside K7-K9."""

    def __init__(self, latent: int):
        super().__init__()
        L = latent
        self.latent = L
        self.Dense_0 = SplitDense(L, 3 * L)
        self.Dense_1 = Dense(L, L)
        self.LayerNorm_0 = LayerNorm(L)

    def edge_part(self, e):
        return self.Dense_0.block(e, 0, self.latent)

    def src_part(self, s):
        return self.Dense_0.block(s, self.latent, 2 * self.latent)

    def dst_part(self, d):
        return self.Dense_0.block(d, 2 * self.latent, 3 * self.latent)

    def finish_params(self):
        """(b₀, (Dense₁ kernel, bias), (LN scale, bias)) for K7-K9."""
        return self.Dense_0.bias, self.Dense_1.wb(), self.LayerNorm_0.sb()


class BipartitePass(nn.Module):
    """One src→dst message pass over a static bipartite edge set: the
    static edge embedding (cached), the factored message, the dst update."""

    def __init__(self, latent: int):
        super().__init__()
        L = latent
        self.latent = L
        self.edge_embed = MLP(4, L, L)
        self.message = FactoredEdgeMLP(L)
        self.MLP_0 = MLP(2 * L, L, L)  # dst node update over [dst ‖ agg]

    def edge_bias(self, efeat):
        """Static per-edge first-layer contribution, (E, L)."""
        return self.message.edge_part(self.edge_embed(efeat))

    def encode(self, grid_lat, mesh_lat, bias_hw, t):
        """grid→mesh over grid-major tiles (K9), then the tile combine."""
        L = self.latent
        H, W = t["grid_hw"]
        D, U, th, tw = t["g2m_D"], t["g2m_U"], t["g2m_th"], t["g2m_tw"]
        if tuple(bias_hw.shape) != (H, W, D * L):
            raise ValueError(f"g2m bias cache {tuple(bias_hw.shape)} != ({H}, {W}, {D * L}); rebuild with prepare_params")
        a_src = self.message.src_part(grid_lat)
        b0, wb, lnp = self.message.finish_params()
        partials = fused_g2m_tiled(a_src.view(H, W, L), bias_hw, t["g2m_local"], b0, wb, lnp, D, U, th, tw,
                                   plan=(t["g2m_rows"], t["g2m_csr"]))
        # combine across tiles: a static gather, then a sorted segment sum in
        # f32 (deterministic; empty segments give 0)
        vals = partials.reshape(-1, L)[t["g2m_combine_idx"]].float()
        agg = torch.segment_reduce(vals, "sum", lengths=t["g2m_combine_len"]).to(mesh_lat.dtype)
        return self.MLP_0(mesh_lat, x2=agg, residual=mesh_lat)

    def decode(self, mesh_lat, grid_lat, bias_hw, t):
        """mesh→grid over face tiles (K8)."""
        L = self.latent
        H, W = t["grid_hw"]
        a_src = self.message.src_part(mesh_lat)
        a_dst = self.message.dst_part(grid_lat)
        a_src_faces = a_src[t["faces"]].reshape(-1, 3 * L)
        uniq = a_src_faces[t["tile_faces"]]  # (TH, TW, U, 3L)
        b0, wb, lnp = self.message.finish_params()
        agg = fused_m2g_tiled(uniq, t["tile_local"], bias_hw, a_dst.view(H, W, L), b0, wb, lnp, 3,
                              t["m2g_th"], t["m2g_tw"])
        return self.MLP_0(grid_lat, x2=agg.view(H * W, L), residual=grid_lat)


class ProcessorRound(nn.Module):
    """One residual round of message passing on the multimesh, in the padded
    block layout of ``ops.graph.build_block_plan`` (K7, then K6)."""

    def __init__(self, latent: int):
        super().__init__()
        self.latent = latent
        self.MLP_0 = FactoredEdgeMLP(latent)  # edge update
        self.MLP_1 = MLP(2 * latent, latent, latent)  # node update

    def forward(self, nodes, edges, t):
        L = self.latent
        gsrc = self.MLP_0.src_part(nodes)[t["mesh_src_blocks"]]  # (B, M, L)
        staged = self.MLP_0.dst_part(nodes)[t["mesh_stage_idx"]]  # (B, SB, L)
        we = self.MLP_0.Dense_0.kernel[:L]
        b0, wb, lnp = self.MLP_0.finish_params()
        new_edges, agg_b = fused_round_messages(
            edges, gsrc, staged, t["mesh_local"], we, b0, wb, lnp, t["mesh_SB"]
        )
        agg = agg_b.reshape(-1, L)[t["mesh_unpack"]]
        return self.MLP_1(nodes, x2=agg, residual=nodes), new_edges


class GraphCastNet(nn.Module):
    def __init__(self, cfg: GraphCastConfig, n_grid_in: int):
        super().__init__()
        self.cfg = cfg
        L = cfg.latent
        self.embed_grid = MLP(n_grid_in, L, L)
        self.embed_mesh = MLP(3, L, L)
        self.embed_mm = MLP(4, L, L)
        self.g2m = BipartitePass(L)
        self.m2g = BipartitePass(L)
        for i in range(cfg.processor_rounds):
            self.add_module(f"round_{i}", ProcessorRound(L))
        self.grid_update = MLP(L, L, L)
        self.head = MLP(L, L, cfg.in_channels, final_norm=False)

    def cache_tables(self, t: dict, dtype) -> dict:
        """Step-invariant tensors, functions of the parameters and the static
        geometry only, in the layouts of the tiled path."""
        L = self.cfg.latent
        H, W = t["grid_hw"]
        mesh_embed = self.embed_mesh(t["mesh_nfeat"].to(dtype))
        B, M = t["mesh_src_blocks"].shape
        mm_edge = self.embed_mm(t["mm_efeat"].to(dtype)).view(B, M, L)
        # grid→mesh: per-(point, slot) edge embedding with the dst mesh-embed
        # transform folded in
        g2m_bias = self.g2m.edge_bias(t["g2m_slot_ef"].to(dtype))
        g2m_bias = g2m_bias + self.g2m.message.dst_part(mesh_embed)[t["g2m_slot_dst"]]
        m2g_bias = self.m2g.edge_bias(t["m2g_efeat"].to(dtype))
        return {
            "mesh_embed": mesh_embed,
            "mm_edge": mm_edge,
            "g2m_bias": g2m_bias.view(H, W, -1),
            "m2g_bias": m2g_bias.view(H, W, 3 * L),
        }

    def forward(self, grid_in, cache: dict | None, t: dict):
        """grid_in feature-major (F_in, n_grid) → (n_grid, C_out).  ``cache``:
        ``cache_tables``' output, or None to compute it here, differentiably
        (the JAX net's exact inline path)."""
        grid_lat = self.embed_grid(grid_in, x_transposed=True)
        dt = grid_lat.dtype
        if cache is None:
            cache = self.cache_tables(t, dt)
        mesh_lat = cache["mesh_embed"].to(dt)
        mm_lat = cache["mm_edge"].to(dt)
        mesh_lat = self.g2m.encode(grid_lat, mesh_lat, cache["g2m_bias"], t)
        grid_lat = self.grid_update(grid_lat, residual=grid_lat)
        for i in range(self.cfg.processor_rounds):
            mesh_lat, mm_lat = getattr(self, f"round_{i}")(mesh_lat, mm_lat, t)
        grid_lat = self.m2g.decode(mesh_lat, grid_lat, cache["m2g_bias"], t)
        return self.head(grid_lat)


def build_tables(cfg: GraphCastConfig, device) -> dict:
    """The static graph tables of the tiled path, on ``device``: the
    multimesh block plan, the grid-major g2m tiles, the m2g face tiles and
    the static features."""
    g = build_graphs(cfg.lat, cfg.lon, cfg.mesh_refinements)
    n_mesh = g["n_mesh"]
    plan = build_block_plan(g["mesh_dst"], n_mesh, target_rows=1024)
    SB = plan["SB"]
    stage_idx = np.clip(plan["seg_lo"][:, None] + np.arange(SB)[None, :], 0, n_mesh - 1)
    gt = build_g2m_tiles(g["g2m_src"], g["g2m_dst"], g["g2m_efeat"], cfg.lat, cfg.lon, n_mesh)
    g2m_rows, g2m_csr = g2m_row_plan(gt["local"], gt["U"], gt["th"], gt["tw"])
    ft = build_face_tiles(g["m2g_face"].reshape(cfg.lat, cfg.lon), th=min(8, cfg.lat), tw=min(128, cfg.lon))

    def dev(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    long = torch.long
    return {
        "grid_hw": (cfg.lat, cfg.lon),
        "n_mesh": n_mesh,
        "grid_nfeat": dev(g["grid_nfeat"].T),  # (3, n_grid)
        "mesh_nfeat": dev(g["mesh_nfeat"]),
        "mesh_src_blocks": dev(pad_rows_to_blocks(g["mesh_src"], plan), long),
        "mm_efeat": dev(pad_rows_to_blocks(g["mesh_efeat"], plan).reshape(-1, 4)),
        "mesh_local": dev(plan["local"], torch.int32),
        "mesh_stage_idx": dev(stage_idx, long),
        "mesh_unpack": dev(plan["unpack"], long),
        "mesh_SB": SB,
        "g2m_D": gt["D"], "g2m_U": gt["U"], "g2m_th": gt["th"], "g2m_tw": gt["tw"],
        "g2m_local": dev(gt["local"], torch.int32),
        "g2m_rows": dev(g2m_rows, torch.int32),  # the filled slots, dst-sorted (K9's row plan)
        "g2m_csr": dev(g2m_csr, torch.int32),
        "g2m_slot_ef": dev(gt["slot_ef"].reshape(-1, 4)),
        "g2m_slot_dst": dev(gt["slot_dst"].reshape(-1), long),
        "g2m_combine_idx": dev(gt["combine_idx"], long),
        "g2m_combine_len": dev(np.bincount(gt["combine_seg"], minlength=n_mesh), long),
        "m2g_efeat": dev(g["m2g_efeat"]),
        "faces": dev(g["faces"], long),
        "tile_faces": dev(ft["tile_faces"], long),
        "tile_local": dev(ft["tile_local"], torch.int32),
        "m2g_th": ft["th"], "m2g_tw": ft["tw"],
    }  # fmt: skip


class GraphCastModel(PrognosticModel):
    """83-channel GraphCast with a 2-frame history; runs on ``device`` (the
    card by default)."""

    name = "graphcast"
    channels = ch.GRAPHCAST
    n_history = 2
    #: forcing channels appended to the grid input: TISR + 4 clock features
    N_FORCINGS = 5

    def __init__(self, cfg: GraphCastConfig | None = None, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg or GraphCastConfig()
        self.grid = LatLonGrid(self.cfg.lat, self.cfg.lon)
        if self.cfg.in_channels != len(self.channels):
            self.channels = tuple(f"c{i:02d}" for i in range(self.cfg.in_channels))
        self.tables = build_tables(self.cfg, self.device)

    @property
    def n_grid_in(self) -> int:
        return self.n_history * self.cfg.in_channels + self.N_FORCINGS + 3

    def _forcings(self, time_days: float) -> torch.Tensor:
        """(5, H, W): TISR over the step, scaled to O(1), and the 4 clock
        features.  ``time_days`` rounds to float32 and the epoch seconds are
        a float32 product, as in the JAX model, whose state holds float32
        days."""
        sec = torch.tensor(time_days, dtype=torch.float32, device=self.device) * 86400.0
        tisr = toa_incident_solar_radiation_torch(
            sec, self.grid.lat, self.grid.lon,
            integration_hours=self.time_step.total_seconds() / 3600.0,
        )
        clock = clock_features_torch(sec, self.grid.lat, self.grid.lon)
        tisr = tisr / 1.5e7  # scale to O(1): 6h TOA max ≈ 1361·3600·6
        return torch.cat([tisr[None], clock], dim=0)

    def _grid_input(self, params, x, time_days):
        """(hist, C, H, W) → feature-major (hist·C + 5 forcings + 3 static,
        n_grid); K6 reads it transposed in place."""
        dt = self.compute_dtype
        xn = normalize(params["norm"], x).to(dt)
        forc = self._forcings(time_days).to(dt)
        static = self.tables["grid_nfeat"].to(dt)
        return torch.cat([xn.reshape(self.n_history * self.cfg.in_channels, -1),
                          forc.reshape(self.N_FORCINGS, -1), static])

    def new_net(self) -> GraphCastNet:
        return GraphCastNet(self.cfg, self.n_grid_in)

    def init_params(self, generator: torch.Generator | None = None):
        """Random parameters drawn on the CPU from ``generator`` (seed 0 by
        default), so a seed gives the same parameters on every device."""
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        net = init_flax_params_(self.new_net(), g)
        params = {
            "net": net.to(self.device).eval().requires_grad_(False),
            "norm": make_norm_params(self.cfg.in_channels, device=self.device),
        }
        return self.prepare_params(params)

    @torch.no_grad()
    def prepare_params(self, params):
        """Attach the step-invariant edge-embedding cache (a function of the
        parameters, rebuilt here rather than loaded)."""
        if "cache" in params:
            return params
        params = dict(params)
        params["cache"] = params["net"].cache_tables(self.tables, self.compute_dtype)
        return params

    def _apply_at(self, params, x, time_days: float):
        nc = self.cfg.in_channels
        grid_in = self._grid_input(params, x, time_days)
        delta = params["net"](grid_in, params.get("cache"), self.tables)
        delta = delta.T.reshape(nc, self.cfg.lat, self.cfg.lon).float()
        xn_last = normalize(params["norm"], x[-1])
        return denormalize(params["norm"], xn_last + delta)[None]

    def apply(self, params, x):
        return self._apply_at(params, x, 0.0)

    @torch.no_grad()
    def advance(self, params, state):
        y = self._apply_at(params, state.x, state.time_days)
        new_x = torch.cat([state.x, y], dim=0)[-self.n_history :]
        return state.replace(x=new_x, step=state.step + 1, time_days=state.time_days + self._step_days), y
