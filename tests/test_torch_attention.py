"""The window-attention ops K5, K10, K11 and ``EarthAttention3D.forward`` of
the port against the JAX package.

CPU: the same numpy inputs go through the JAX Pallas kernel (interpret
mode, as tests/ops/test_flash_attention.py runs it), its XLA ``reference_*``
twin and the port's function, whose CPU path is its plain PyTorch version,
at the shapes of that file (wlen 8, 16, 24; hd 4, 8; 3-D and per-type bias;
mask and no mask; one visible key).  f32 at atol 3e-5, bf16 at atol 3e-2
(tests/ops/test_flash_attention.py:123).  ``EarthAttention3D.forward`` and
the block composed around it are held to the JAX modules at the golden tiny
Pangu configuration (tests/test_golden.py:34-36) in f32 at atol 3e-5, with
the parameters carried by ``params.from_jax``.

JAX is imported inside the CPU tests only: the card's machine has no JAX
and runs the GPU tests of this file alone.

GPU (marker ``gpu``, skipped without a card): each kernel against its plain
version on the card in bf16 at odd shapes (wlen 24 and 72, hd 4 and 64).
Tolerance, as for K1: elementwise |kernel − plain| ≤ 2e-2·std(plain) + 2
bf16 ulps of max|plain|.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from skyrim_tpu_torch.models.pangu import PanguConfig, PanguModel
from skyrim_tpu_torch.ops import flash_window_attention as FA
from skyrim_tpu_torch.ops import fused_block as FB
from skyrim_tpu_torch.ops.roll import shift_roll
from skyrim_tpu_torch.ops.windows import shift_attention_mask, window_partition, window_reverse

CFG = dict(lat=49, lon=96, embed_dim=16, depths=(2, 2, 2, 2), num_heads=(2, 2, 2, 2))
WINDOW = (2, 6, 12)


def _split_case(n_win=8, heads=2, wlen=16, hd=8, mask_zh=(2, 2), n_types=None, nw=2, seed=0):
    """q, k, v, bias, mask as numpy f32 (tests/ops/test_flash_attention.py:14)."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(n_win, heads, wlen, hd)).astype(np.float32) for _ in range(3))
    shape = (heads, wlen, wlen) if n_types is None else (n_types, heads, wlen, wlen)
    bias = (rng.normal(size=shape) * 0.1).astype(np.float32)
    mask = None
    if mask_zh is not None:
        mask = np.zeros((*mask_zh, wlen, wlen), np.float32)
        mask[-1, -1, :, wlen // 2 :] = -1e9  # block some keys in edge windows
    return q, k, v, bias, mask, nw


SPLIT_CASES = {
    "mask": dict(),
    "no_mask": dict(mask_zh=None, nw=8),
    "per_type_bias": dict(n_types=4, seed=3),
    "wlen24_hd4": dict(n_win=4, wlen=24, hd=4, mask_zh=(2, 1), n_types=2, seed=4),
    "wlen8_hd4_one_table": dict(n_win=4, heads=1, wlen=8, hd=4, mask_zh=(1, 1), nw=4, seed=5),
}


def _pack(q, k, v):
    """(nWin, heads, wlen, hd) q, k, v → packed (nWin, wlen, 3C)."""
    n_win, heads, wlen, hd = q.shape
    parts = np.stack([a.transpose(0, 2, 1, 3) for a in (q, k, v)], axis=2)  # (nWin, wlen, 3, heads, hd)
    return np.ascontiguousarray(parts.reshape(n_win, wlen, 3 * heads * hd))


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(a).to(dtype)


def _j(a, dtype=None):
    import jax.numpy as jnp

    return None if a is None else jnp.asarray(a, dtype)


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_flash_window_attention_matches_jax(case):
    pytest.importorskip("jax")
    from skyrim_tpu.ops.flash_window_attention import flash_window_attention as j_fused
    from skyrim_tpu.ops.flash_window_attention import reference_window_attention as j_ref

    q, k, v, bias, mask, nw = _split_case(**SPLIT_CASES[case])
    before = FA.flash_window_attention.launches
    out = FA.flash_window_attention(_t(q), _t(k), _t(v), _t(bias), _t(mask), nw).numpy()
    assert FA.flash_window_attention.launches == before  # the plain path launches nothing
    jin = (_j(q), _j(k), _j(v), _j(bias), _j(mask))
    np.testing.assert_allclose(out, np.asarray(j_fused(*jin, n_lon_windows=nw, interpret=True)), atol=3e-5, rtol=0)
    np.testing.assert_allclose(out, np.asarray(j_ref(*jin, nw)), atol=3e-5, rtol=0)


def test_flash_window_attention_bf16_matches_jax():
    jnp = pytest.importorskip("jax.numpy")
    from skyrim_tpu.ops.flash_window_attention import flash_window_attention as j_fused
    from skyrim_tpu.ops.flash_window_attention import reference_window_attention as j_ref

    q, k, v, bias, mask, nw = _split_case(seed=1)
    bf = torch.bfloat16
    out = FA.flash_window_attention(_t(q, bf), _t(k, bf), _t(v, bf), _t(bias), _t(mask), nw)
    assert out.dtype == bf
    jin = (*(_j(a, jnp.bfloat16) for a in (q, k, v)), _j(bias), _j(mask))
    for ref in (j_fused(*jin, n_lon_windows=nw, interpret=True), j_ref(*jin, nw)):
        np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), atol=3e-2, rtol=0)


def test_masked_keys_have_zero_weight():
    """All keys but one fully blocked: the output is that key's value row
    (tests/ops/test_flash_attention.py:127), in the port as in the JAX kernel."""
    pytest.importorskip("jax")
    from skyrim_tpu.ops.flash_window_attention import flash_window_attention as j_fused

    wlen, hd = 8, 4
    rng = np.random.default_rng(2)
    q, k, v = (rng.normal(size=(1, 1, wlen, hd)).astype(np.float32) for _ in range(3))
    bias = np.zeros((1, wlen, wlen), np.float32)
    mask = np.full((1, 1, wlen, wlen), -1e9, np.float32)
    mask[..., 3] = 0.0  # only key 3 visible
    out = FA.flash_window_attention(_t(q), _t(k), _t(v), _t(bias), _t(mask), 1).numpy()
    expected = np.broadcast_to(v[0, 0, 3], (wlen, hd))
    np.testing.assert_allclose(out[0, 0], expected, atol=1e-5, rtol=0)
    ref = np.asarray(j_fused(_j(q), _j(k), _j(v), _j(bias), _j(mask), n_lon_windows=1, interpret=True))
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_fused_window_attention_matches_jax(case):
    """K10 on the packed rows of the same inputs, and equal to K11 after the
    relayout."""
    pytest.importorskip("jax")
    from skyrim_tpu.ops.flash_window_attention import fused_window_attention as j_fused
    from skyrim_tpu.ops.flash_window_attention import reference_window_attention_qkv as j_ref

    q, k, v, bias, mask, nw = _split_case(**SPLIT_CASES[case])
    n_win, heads, wlen, hd = q.shape
    qkv = _pack(q, k, v)
    out = FA.fused_window_attention(_t(qkv), _t(bias), _t(mask), nw, heads).numpy()
    assert out.shape == (n_win, wlen, heads * hd)
    jin = (_j(qkv), _j(bias), _j(mask), nw, heads)
    np.testing.assert_allclose(out, np.asarray(j_fused(*jin, interpret=True)), atol=3e-5, rtol=0)
    np.testing.assert_allclose(out, np.asarray(j_ref(*jin)), atol=3e-5, rtol=0)
    split = FA.flash_window_attention(_t(q), _t(k), _t(v), _t(bias), _t(mask), nw).numpy()
    np.testing.assert_allclose(out, split.transpose(0, 2, 1, 3).reshape(out.shape), atol=1e-6, rtol=0)


def _case_4d(window, dims, heads, C, per_type, masked, seed=7):
    """Packed 4-D qkv as tests/ops/test_flash_attention.py:94."""
    rng = np.random.default_rng(seed)
    Z, H, Wd = dims
    wlen = int(np.prod(window))
    nz, nh = Z // window[0], H // window[1]
    qkv = rng.normal(size=(Z, H, Wd, 3 * C)).astype(np.float32)
    shape = (nz * nh, heads, wlen, wlen) if per_type else (heads, wlen, wlen)
    bias = (rng.normal(size=shape) * 0.1).astype(np.float32)
    mask = None
    if masked:
        mask = np.zeros((nz, nh, wlen, wlen), np.float32)
        mask[-1, 0, :, : wlen // 3] = -1e9
    return qkv, bias, mask


CASES_4D = {
    "wlen24_types_mask": ((2, 3, 4), (4, 6, 16), 2, 16, True, True),
    "wlen24_one_table_no_mask": ((2, 3, 4), (4, 6, 16), 2, 16, False, False),
    "wlen8_hd4_mask": ((1, 2, 4), (2, 4, 8), 2, 8, True, True),
    "wlen16_one_table_mask": ((2, 2, 4), (2, 4, 8), 1, 8, False, True),
}


@pytest.mark.parametrize("case", sorted(CASES_4D))
def test_fused_window_attention_4d_matches_jax(case):
    pytest.importorskip("jax")
    from skyrim_tpu.ops import windows as JW
    from skyrim_tpu.ops.flash_window_attention import fused_window_attention_4d as j_fused
    from skyrim_tpu.ops.flash_window_attention import reference_window_attention_qkv as j_ref

    window, dims, heads, C, per_type, masked = CASES_4D[case]
    qkv, bias, mask = _case_4d(window, dims, heads, C, per_type, masked)
    out = FA.fused_window_attention_4d(_t(qkv), _t(bias), _t(mask), window, heads).numpy()
    assert out.shape == (*dims, C)
    jq, jb, jm = _j(qkv), _j(bias), _j(mask)
    np.testing.assert_allclose(out, np.asarray(j_fused(jq, jb, jm, window, heads, interpret=True)), atol=3e-5, rtol=0)
    nw = dims[2] // window[2]
    ref = JW.window_reverse(j_ref(JW.window_partition(jq, window), jb, jm, nw, heads), window, dims)
    np.testing.assert_allclose(out, np.asarray(ref), atol=3e-5, rtol=0)
    # K5 is K10 on the partitioned rows
    rows = FA.fused_window_attention(window_partition(_t(qkv), window), _t(bias), _t(mask), nw, heads)
    np.testing.assert_allclose(out, window_reverse(rows, window, dims).numpy(), atol=1e-6, rtol=0)


def test_wrappers_refuse_what_the_reference_asserts():
    q, k, v, bias, mask, nw = _split_case()
    tq, tk, tv, tb, tm = _t(q), _t(k), _t(v), _t(bias), _t(mask)
    with pytest.raises(ValueError, match="windows 8 != 2x2x3"):
        FA.flash_window_attention(tq, tk, tv, tb, tm, 3)
    types = torch.zeros(3, 2, 16, 16)
    with pytest.raises(ValueError, match="3 types"):
        FA.flash_window_attention(tq, tk, tv, types, None, 2)
    with pytest.raises(ValueError, match="bias shape"):
        FA.fused_window_attention(_t(_pack(q, k, v)), torch.zeros(2, 8, 8), None, 2, 2)
    with pytest.raises(ValueError, match="one .* shape"):
        FA.flash_window_attention(tq, tk[:, :, :8], tv, tb, tm, nw)


# --- EarthAttention3D.forward and the block around it --------------------------


@pytest.fixture(scope="module")
def pangu_pair():
    """The golden tiny Pangu in both packages, JAX's parameters carried over."""
    jax = pytest.importorskip("jax")
    from skyrim_tpu.models.pangu import PanguConfig as JConfig
    from skyrim_tpu.models.pangu import PanguModel as JModel

    from skyrim_tpu_torch.params import from_jax

    jmodel = JModel("pangu6", cfg=JConfig(**CFG))
    tree = jax.tree.map(np.asarray, jmodel.init_params(jax.random.key(0)))
    model = PanguModel("pangu6", cfg=PanguConfig(**CFG), device="cpu")
    return tree["net6"], from_jax(tree, model)["net6"]


# block → (padded token dims, unpadded extents, width, shifted)
BLOCKS = {
    "PanguBlock_0": ((8, 18, 24), (8, 13, 24), 16, False),
    "PanguBlock_1": ((8, 18, 24), (8, 13, 24), 16, True),
    "PanguBlock_2": ((8, 12, 12), (8, 7, 12), 32, False),
    "PanguBlock_3": ((8, 12, 12), (8, 7, 12), 32, True),
}


def _block_case(name, seed=0):
    dims, valid, C, shifted = BLOCKS[name]
    shift = tuple(w // 2 for w in WINDOW) if shifted else (0, 0, 0)
    x = np.random.default_rng(seed).normal(size=(*dims, C)).astype(np.float32)
    mask = shift_attention_mask(dims, WINDOW, shift, valid)
    assert mask is not None  # the padded latitudes are masked in every block
    return x, mask, shift, dims, valid, C, shifted


@pytest.mark.parametrize("pallas", [True, False], ids=["pallas_interpret", "xla"])
@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_earth_attention_forward_matches_jax(pangu_pair, monkeypatch, name, pallas):
    from skyrim_tpu.models import pangu as JP

    tree, net = pangu_pair
    x, mask, _, dims, _, C, _ = _block_case(name)
    monkeypatch.setattr(JP, "_use_pallas", lambda: pallas)
    nz, nh, nw = (d // w for d, w in zip(dims, WINDOW))
    jattn = JP.EarthAttention3D(C, 2, WINDOW, n_lon_windows=nw, n_type_windows=nz * nh)
    ref = np.asarray(jattn.apply({"params": tree[name]["EarthAttention3D_0"]}, _j(x), _j(mask)))
    attn = getattr(net, name).EarthAttention3D_0
    before = FA.fused_window_attention_4d.launches
    out = attn(_t(x), _t(mask))
    assert FA.fused_window_attention_4d.launches == before and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=3e-5, rtol=0)


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_composed_around_earth_attention_matches_fused_and_jax(pangu_pair, monkeypatch, name):
    """LN → roll → EarthAttention3D.forward → roll back → residual → LN → MLP
    is the port's K1 path (``PanguBlock.forward``) and the JAX ``PanguBlock``
    on both of its paths."""
    from skyrim_tpu.models import pangu as JP

    tree, net = pangu_pair
    x, mask, shift, _, valid, C, shifted = _block_case(name, seed=1)
    blk = getattr(net, name)
    tx = _t(x)
    h = FB._layernorm_f32(tx, *blk.LayerNorm_0.sb())
    h = shift_roll(h, shift, forward=True)
    h = blk.EarthAttention3D_0(h, _t(mask))
    x1 = tx + shift_roll(h, shift, forward=False)
    h2 = FB._layernorm_f32(x1, *blk.LayerNorm_1.sb())
    m = F.gelu(h2 @ blk.Dense_0.kernel + blk.Dense_0.bias, approximate="tanh")
    out = (x1 + m @ blk.Dense_1.kernel + blk.Dense_1.bias).numpy()
    np.testing.assert_allclose(out, blk(tx, valid).numpy(), atol=3e-5, rtol=0)
    jblk = JP.PanguBlock(C, 2, WINDOW, shifted, 4.0, valid)
    for pallas in (False, True):
        monkeypatch.setattr(JP, "_use_pallas", lambda: pallas)
        ref = np.asarray(jblk.apply({"params": tree[name]}, _j(x)))
        np.testing.assert_allclose(out, ref, atol=3e-5, rtol=0)


# --- which kernel body a shape takes --------------------------------------------


BODY_BY_SHAPE = {
    # (wlen, hd): body
    "pangu_wlen144_hd32": (144, 32, "registers"),
    "fuxi_fengwu_wlen72_hd64": (72, 64, "registers"),
    "wlen130_hd20_pads_to_pangu": (130, 20, "registers"),
    "wlen144_hd64": (144, 64, "shared"),
    "wlen72_hd32": (72, 32, "shared"),
    "wlen24_hd4": (24, 4, "shared"),
    "wlen100_hd20": (100, 20, "shared"),
    "wlen16_hd8": (16, 8, "shared"),
}


@pytest.mark.parametrize("case", sorted(BODY_BY_SHAPE))
def test_attention_body_by_shape(case):
    """The models' geometries take the register body, any other window that
    fits the shared-memory one; the choice reads the shape alone."""
    wlen, hd, body = BODY_BY_SHAPE[case]
    assert FA.attention_body(wlen, hd) == body
    assert body in FA.BODIES


@pytest.mark.parametrize("wlen,hd", [(288, 8), (257, 4), (224, 64)])
def test_attention_body_refuses_a_window_no_body_takes(wlen, hd):
    with pytest.raises(ValueError, match="shared memory"):
        FA.attention_body(wlen, hd)


# --- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def assert_bf16_close(out, ref):
    out, ref = out.float(), ref.float()
    assert out.shape == ref.shape and torch.isfinite(out).all()
    tol = 2e-2 * ref.std() + 2 * 2.0**-8 * ref.abs().max()
    err = (out - ref).abs()
    assert bool((err <= tol).all()), f"max err {err.max().item():.4g} vs std {ref.std().item():.4g}"


GPU_SPLIT_CASES = {
    # wlen, hd and the table layouts the kernel pads or indexes differently
    "wlen24_hd4": dict(n_win=8, heads=3, wlen=24, hd=4, mask_zh=(2, 2), n_types=4),
    "wlen72_hd64": dict(n_win=6, heads=2, wlen=72, hd=64, mask_zh=(1, 3), n_types=None, nw=2),
    "wlen144_hd32": dict(n_win=4, heads=2, wlen=144, hd=32, mask_zh=(2, 1), n_types=2, nw=2),
    "wlen16_hd8_no_mask": dict(n_win=5, heads=2, wlen=16, hd=8, mask_zh=None, nw=1),
    "wlen100_hd20": dict(n_win=4, heads=2, wlen=100, hd=20, mask_zh=(2, 2), n_types=4, nw=1),
}


def _gpu_split(case, dev):
    q, k, v, bias, mask, nw = _split_case(**GPU_SPLIT_CASES[case])
    bias = bias * 5  # a strong bias: a misread table moves the output past the tolerance
    to = lambda a, dt: None if a is None else torch.from_numpy(a).to(dev, dt)  # noqa: E731
    bf = torch.bfloat16
    return to(q, bf), to(k, bf), to(v, bf), to(bias, torch.float32), to(mask, torch.float32), nw


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(GPU_SPLIT_CASES))
def test_split_and_rows_kernels_match_plain(cuda, case):
    q, k, v, bias, mask, nw = _gpu_split(case, cuda)
    n_win, heads, wlen, hd = q.shape
    before = FA.flash_window_attention.launches, FA.fused_window_attention.launches
    out = FA.flash_window_attention(q, k, v, bias, mask, nw)
    qkv = torch.stack([a.transpose(1, 2) for a in (q, k, v)], dim=2).reshape(n_win, wlen, -1).contiguous()
    rows = FA.fused_window_attention(qkv, bias, mask, nw, heads)
    torch.cuda.synchronize()
    assert (FA.flash_window_attention.launches, FA.fused_window_attention.launches) == (before[0] + 1, before[1] + 1)
    ref = FA.reference_window_attention(q, k, v, bias, mask, nw)
    assert_bf16_close(out, ref)
    assert_bf16_close(rows, ref.transpose(1, 2).reshape(n_win, wlen, -1))
    assert torch.equal(rows, out.transpose(1, 2).reshape(n_win, wlen, -1))  # one kernel body


GPU_CASES_4D = {
    "wlen24_hd4": ((2, 3, 4), (4, 6, 16), 2, 8, True, True),
    "wlen72_hd64_one_table": ((1, 6, 12), (2, 12, 36), 2, 128, False, True),
    "wlen72_hd64_types": ((1, 6, 12), (2, 12, 36), 2, 128, True, True),
    "wlen144_hd32_no_mask": ((2, 6, 12), (4, 12, 24), 2, 64, True, False),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(GPU_CASES_4D))
def test_4d_kernel_matches_plain_and_k1s_copy(cuda, case):
    window, dims, heads, C, per_type, masked = GPU_CASES_4D[case]
    qkv, bias, mask = _case_4d(window, dims, heads, C, per_type, masked)
    qkv = torch.from_numpy(qkv).to(cuda, torch.bfloat16)
    bias = torch.from_numpy(bias * 5).to(cuda)
    mask = None if mask is None else torch.from_numpy(mask).to(cuda)
    before = FA.fused_window_attention_4d.launches
    out = FA.fused_window_attention_4d(qkv, bias, mask, window, heads)
    k1 = FB.window_attention(qkv, bias, mask, window, heads)
    torch.cuda.synchronize()
    assert FA.fused_window_attention_4d.launches == before + 1
    assert_bf16_close(out, FA.reference_window_attention_4d(qkv, bias, mask, window, heads))
    assert torch.equal(out, k1)


@pytest.mark.gpu
def test_one_visible_key_on_the_card(cuda):
    """Fully masked keys get exactly zero weight in the kernel too."""
    wlen, hd = 24, 8
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(2, 1, wlen, hd, device=cuda, generator=g).to(torch.bfloat16) for _ in range(3))
    mask = torch.full((1, 1, wlen, wlen), -1e9, device=cuda)
    mask[..., 5] = 0.0
    out = FA.flash_window_attention(q, k, v, torch.zeros(1, wlen, wlen, device=cuda), mask, 2)
    torch.cuda.synchronize()
    assert torch.equal(out, v[:, :, 5:6].expand_as(out))


@pytest.mark.gpu
def test_swin_block_kernel_at_window_1_6_12(cuda):
    """K1 at FuXi's and FengWu's window: wlen 72, which the score tile pads to 80."""
    window, dims, C, heads = (1, 6, 12), (2, 12, 24), 128, 2
    rng = np.random.default_rng(0)

    def n(*shape, s=1.0):
        return torch.from_numpy((rng.normal(size=shape) * s).astype(np.float32)).to(cuda)

    mask = torch.from_numpy(shift_attention_mask(dims, window, (0, 3, 6), (2, 11, 24))).to(cuda)
    args = (n(*dims, C).to(torch.bfloat16), (1 + n(C, s=0.1), n(C, s=0.1)), (n(C, 3 * C, s=C**-0.5), n(3 * C, s=0.1)),
            n(heads, 72, 72, s=0.5), mask, (n(C, C, s=C**-0.5), n(C, s=0.1)), (1 + n(C, s=0.1), n(C, s=0.1)),
            (n(C, 4 * C, s=C**-0.5), n(4 * C, s=0.1), n(4 * C, C, s=(4 * C) ** -0.5), n(C, s=0.1)))  # fmt: skip
    out = FB.fused_swin_block(*args, window, heads)
    torch.cuda.synchronize()
    assert_bf16_close(out, FB.reference_swin_block(*args, window, heads))


@pytest.mark.gpu
def test_earth_attention_forward_on_the_card(cuda):
    """The module's own path launches K5 once and no K1."""
    model = PanguModel("pangu6", cfg=PanguConfig(**CFG), device=cuda)
    net = model.init_params(torch.Generator().manual_seed(0))["net6"]
    x, mask, *_ = _block_case("PanguBlock_1")
    x = torch.from_numpy(x).to(cuda, torch.bfloat16)
    mask = torch.from_numpy(mask).to(cuda)
    attn = net.PanguBlock_1.EarthAttention3D_0
    before = FA.fused_window_attention_4d.launches, FB.fused_swin_block.launches
    out = attn(x, mask)
    torch.cuda.synchronize()
    assert (FA.fused_window_attention_4d.launches, FB.fused_swin_block.launches) == (before[0] + 1, before[1])
    qkv = x @ attn.qkv.kernel.to(x.dtype) + attn.qkv.bias.to(x.dtype)
    ref = FA.reference_window_attention_4d(qkv, attn.expanded_bias(), mask, WINDOW, 2)
    assert_bf16_close(out, ref @ attn.proj.kernel.to(x.dtype) + attn.proj.bias.to(x.dtype))


@pytest.mark.gpu
def test_attention_wrappers_raise_on_unsupported_cuda_input(cuda):
    """On a CUDA tensor a wrapper launches its kernel or raises: f32 or
    non-contiguous input, or a window too large for shared memory, is refused,
    never sent to the plain version."""
    q, k, v, bias, mask, nw = _gpu_split("wlen16_hd8_no_mask", cuda)
    with pytest.raises(ValueError, match="bf16"):
        FA.flash_window_attention(q.float(), k.float(), v.float(), bias, mask, nw)
    with pytest.raises(ValueError, match="contiguous"):
        FA.flash_window_attention(q.transpose(0, 1).contiguous().transpose(0, 1), k, v, bias, mask, nw)
    qkv = torch.zeros(5, 16, 48, device=cuda)
    with pytest.raises(ValueError, match="bf16"):
        FA.fused_window_attention(qkv, bias, None, 1, 2)
    with pytest.raises(ValueError, match="bf16"):
        FA.fused_window_attention_4d(torch.zeros(2, 2, 8, 48, device=cuda), bias, None, (2, 2, 4), 2)
    big = torch.zeros(1, 1, 288, 8, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="shared memory"):
        FA.flash_window_attention(big, big, big, torch.zeros(1, 288, 288, device=cuda), None, 1)
    with pytest.raises(ValueError, match="bias on cpu"):
        FA.flash_window_attention(q, k, v, bias.cpu(), mask, nw)
