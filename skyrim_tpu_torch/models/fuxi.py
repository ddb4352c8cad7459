"""FuXi's 2D window block, V1 flavour (port of skyrim_tpu/models/fuxi.py
``SwinBlock2D`` with ``v2=False``).

For now this file holds only the block, which FengWu's fuser runs
(models/fengwu.py).  FuXi itself, the Swin-V2 block and the int8 Dense
path wait for their item of ROADMAP.md §1.

Parameter names follow the flax tree (``LayerNorm_0``, ``qkv``,
``proj``, ``LayerNorm_1``, ``Dense_0``, ``Dense_1``, ``rel_bias``).  The
block runs as the port's ``PanguBlock`` does: K2 rolls the activation
into the shifted frame (ops/roll.py), K1 runs the whole pre-norm block
with the bias and the shift mask (ops/fused_block.py), K2 rolls it back.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from skyrim_tpu_torch.models.pangu import Dense, LayerNorm
from skyrim_tpu_torch.ops import windows as W
from skyrim_tpu_torch.ops.fused_block import fused_swin_block
from skyrim_tpu_torch.ops.roll import shift_roll


class SwinBlock2D(nn.Module):
    """2D window-attention block on (H, W, C) with periodic longitude:
    window (wh, ww) as (1, wh, ww) of the 3D tools, a lat-absolute,
    lon-relative bias table shared by every window, MLP ratio 4."""

    def __init__(self, dim: int, heads: int, window: tuple[int, int], shifted: bool):
        super().__init__()
        self.heads = heads
        self.window = (1, *window)
        self.shifted = shifted
        self.LayerNorm_0 = LayerNorm(dim)
        self.qkv = Dense(dim, 3 * dim)
        self.proj = Dense(dim, dim)
        self.LayerNorm_1 = LayerNorm(dim)
        self.Dense_0 = Dense(dim, 4 * dim)
        self.Dense_1 = Dense(4 * dim, dim)
        self.rel_bias = nn.Parameter(torch.empty(W.earth_bias_table_size(self.window), heads))
        index = torch.from_numpy(W.earth_bias_index(self.window).astype(np.int64))
        self.register_buffer("bias_index", index, persistent=False)

    def expanded_bias(self) -> torch.Tensor:
        return self.rel_bias[self.bias_index].permute(2, 0, 1)  # (heads, wlen, wlen)

    def forward(self, x, valid_h: int):
        """x (H, W, C), H padded to a window multiple, rows from ``valid_h``
        on padding (masked as keys) → (H, W, C)."""
        H, Wd, _ = x.shape
        _, wh, ww = self.window
        shift = (0, wh // 2, ww // 2) if self.shifted else (0, 0, 0)
        mask = W.mask_tensor((1, H, Wd), self.window, shift, (1, valid_h, Wd), x.device)
        h = shift_roll(x[None], shift, forward=True)
        h = fused_swin_block(
            h, self.LayerNorm_0.sb(), self.qkv.wb(), self.expanded_bias(), mask, self.proj.wb(),
            self.LayerNorm_1.sb(), (*self.Dense_0.wb(), *self.Dense_1.wb()), self.window, self.heads,
        )
        return shift_roll(h, shift, forward=False)[0]
