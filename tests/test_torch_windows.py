"""The port's window tables equal the JAX package's, bit for bit."""

import numpy as np
import pytest
import torch

from skyrim_tpu_torch.ops import windows as TW

JW = pytest.importorskip("skyrim_tpu.ops.windows")  # the card's machine has no JAX

WINDOW = (2, 6, 12)

MASK_CASES = [
    # (dims, shift, valid): Pangu stage 1/4 and 2/3 geometry, the test
    # block of tests/ops/test_fused_block.py, unshifted with padding, and
    # an unmasked case
    ((8, 186, 360), (1, 3, 6), (8, 181, 360)),
    ((8, 186, 360), (0, 0, 0), (8, 181, 360)),
    ((8, 96, 180), (1, 3, 6), (8, 91, 180)),
    ((4, 12, 24), (1, 3, 6), (3, 11, 24)),
    ((4, 12, 24), (0, 0, 0), (3, 11, 24)),
    ((8, 18, 24), (1, 3, 6), None),
    ((8, 18, 24), (0, 0, 0), None),
]


@pytest.mark.parametrize("dims,shift,valid", MASK_CASES)
def test_shift_attention_mask_matches_jax(dims, shift, valid):
    ref = JW.shift_attention_mask(dims, WINDOW, shift, valid)
    out = TW.shift_attention_mask(dims, WINDOW, shift, valid)
    if ref is None:
        assert out is None
        return
    assert out.dtype == ref.dtype and out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("window", [WINDOW, (1, 4, 8), (2, 2, 2)])
def test_earth_bias_index_matches_jax(window):
    np.testing.assert_array_equal(TW.earth_bias_index(window), JW.earth_bias_index(window))
    assert TW.earth_bias_index(window).dtype == JW.earth_bias_index(window).dtype
    assert TW.earth_bias_table_size(window) == JW.earth_bias_table_size(window)


def test_partition_reverse_pad_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 11, 20, 5)).astype(np.float32)
    xt, pads = TW.pad_to_windows(torch.from_numpy(x), WINDOW)
    xj, pads_j = JW.pad_to_windows(x, WINDOW)
    assert pads == pads_j == (1, 1, 4)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    parts = TW.window_partition(xt, WINDOW)
    np.testing.assert_array_equal(parts.numpy(), np.asarray(JW.window_partition(xj, WINDOW)))
    back = TW.window_reverse(parts, WINDOW, tuple(xt.shape[:3]))
    np.testing.assert_array_equal(back.numpy(), xt.numpy())
