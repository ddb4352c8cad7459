"""The declared cost of one call of each kernel at the shapes of the kernel
table in PERF.md §6 (``ops/cost.py``: FLOPs, bytes, transcendentals, equal to
the JAX kernels' ``pl.CostEstimate``s).

    python -m skyrim_tpu_torch.tools.declared_costs

Arithmetic from shapes, on meta tensors: it runs on any machine.  GraphCast's
shapes come from its full-width static tables and graphs, built on the host
(about half a minute).
"""

from __future__ import annotations

import torch

from skyrim_tpu_torch.ops import cost as C

BF16 = torch.bfloat16


def t(*shape, dtype=BF16):
    return torch.empty(shape, dtype=dtype, device="meta")


def dense(a, b):
    return (t(a, b, dtype=torch.float32), t(b, dtype=torch.float32))


def block(Z, H, W, Cc, heads, window):
    return C.swin_block(t(Z, H, W, Cc), dense(Cc, 3 * Cc), dense(Cc, 4 * Cc) + dense(4 * Cc, Cc), window, heads)


def rows() -> list[tuple[str, C.Cost]]:
    from skyrim_tpu_torch.models.graphcast import GraphCastConfig, build_tables
    from skyrim_tpu_torch.ops import graph as G

    pangu, fuxi = (2, 6, 12), (1, 6, 12)
    out = [
        ("K1 (8,186,360,192)", block(8, 186, 360, 192, 6, pangu)),
        ("K1 (8,96,180,384)", block(8, 96, 180, 384, 12, pangu)),
        ("K1 FuXi V1 (1,96,180,1536)", block(1, 96, 180, 1536, 24, fuxi)),
        ("K1 FengWu (1,186,360,1152)", block(1, 186, 360, 1152, 18, fuxi)),
    ]
    for shape in ((8, 186, 360, 192), (8, 96, 180, 384), (1, 186, 360, 1152), (1, 96, 180, 1536)):
        out.append((f"K2 {shape}", C.roll(t(*shape))))
    out += [
        ("K3 (8,181,360,192) -> 384", C.downsample(t(8, 181, 360, 192), dense(768, 384))),
        ("K4 (8,91,180,384) -> 192", C.upsample(t(8, 91, 180, 384), dense(384, 768))),
        ("K5 (8,186,360,576)", C.window_attention_4d(t(8, 186, 360, 576), pangu, 6)),
        ("K5 (8,96,180,1152)", C.window_attention_4d(t(8, 96, 180, 1152), pangu, 12)),
        ("K5 FuXi V1 (1,96,180,4608)", C.window_attention_4d(t(1, 96, 180, 4608), fuxi, 24)),
        ("K10 (3720,144,576)", C.window_attention_rows(t(3720, 144, 576), 6)),
        ("K10 (960,144,1152)", C.window_attention_rows(t(960, 144, 1152), 12)),
        ("K11 (3720,6,144,32)", C.window_attention_split(t(3720, 6, 144, 32))),
        ("K11 (960,12,144,32)", C.window_attention_split(t(960, 12, 144, 32))),
    ]
    cfg = GraphCastConfig()
    tb = build_tables(cfg, torch.device("cpu"))
    L, N, n_mesh = cfg.latent, cfg.lat * cfg.lon, tb["n_mesh"]
    cin = 2 * cfg.in_channels + 5 + 3
    for name, n, c1, c2, cout, xt in (("embed_grid", N, cin, 0, L, True), ("grid_update", N, L, 0, L, False),
                                      ("m2g.MLP_0", N, L, L, L, False), ("head", N, L, 0, cfg.in_channels, False),
                                      ("mesh MLP", n_mesh, L, L, L, False)):
        x = t(c1, n) if xt else t(n, c1)
        out.append((f"K6 {name}", C.mlp(x, dense(c1 + c2, L), dense(L, cout), t(n, c2) if c2 else None, xt)))
    B, M = tb["mesh_src_blocks"].shape
    out.append((f"K7 ({B},{M},{L}) SB {tb['mesh_SB']}", C.round_messages(t(B, M, L), tb["mesh_SB"])))
    tf = tb["tile_faces"]
    TH, TW, U = tf.shape[:3]
    out.append((f"K8 uniq ({TH},{TW},{U},{3 * L})", C.m2g_tiled(t(TH, TW, U, 3 * L), t(cfg.lat, cfg.lon, 3 * L), 3)))
    D, U9, th, tw = tb["g2m_D"], tb["g2m_U"], tb["g2m_th"], tb["g2m_tw"]
    out.append((f"K9 ({cfg.lat},{cfg.lon},{L}) D {D} -> ({cfg.lat // th},{cfg.lon // tw},{U9},{L})",
                C.g2m_tiled(t(cfg.lat, cfg.lon, L), D, U9, th, tw)))
    graphs = G.build_graphs(cfg.lat, cfg.lon, cfg.mesh_refinements)
    for what, n in (("grid rows", N), ("mesh edges", len(graphs["mesh_dst"]))):
        out.append((f"K12 {what} ({n},{L})->{L}", C.finish(t(n, L), dense(L, L))))
    out.append((f"K13 ({N},3x{L})", C.fixed_degree_messages(t(N, 3 * L), 3)))
    plan = G.build_block_plan(graphs["g2m_dst"], graphs["n_mesh"], target_rows=8192)
    B, M = plan["local"].shape
    out.append((f"K14 ({B},{M},{L}) SB {plan['SB']}", C.block_messages(t(B, M, L), plan["SB"])))
    return out


def main() -> None:
    for name, c in rows():
        print(f"{name}: {c.flops} FLOPs, {c.bytes_accessed} bytes, {c.transcendentals} transcendentals")


if __name__ == "__main__":
    main()
