"""K3 and K4 of the port on the CPU: the DownSample path on odd H and on
strided views, and the algebra K3's kernel runs.

- Odd H: Pangu's DownSample pads H to even (``skyrim_tpu/models/pangu.py``
  DownSample); the port's module hands the stage's cropped view to
  ``fused_downsample`` as it stands, whose CPU path pads and runs
  ``reference_downsample``.  Held to the JAX path (pad, then the Pallas
  kernel in interpret mode, and its XLA ``reference_downsample``) in f32 at
  atol 3e-5, the tolerance of tests/ops/test_fused_block.py:49.
- K3's split (``prepare_downsample``, and ``_split_downsample`` below): out =
  inv·(v @ W′ − μ·sw) + ct.  Where s∘W is exact in bf16 (W rounded to bf16,
  s powers of two) the split is the reference's algebra, held in f64 and
  f32 at atol 3e-5, rows offset to |μ| = 4σ included; with general
  parameters W′'s bf16 rounding is the only difference, held at the
  kernels' bf16 tolerance (2e-2·std + 2 bf16 ulps of max|ref|).

JAX is imported inside the tests: the card's machine has no JAX and runs
only the ``gpu`` tests of the port's files.
"""

import numpy as np
import pytest
import torch

from skyrim_tpu_torch.models.pangu import DownSample, UpSample
from skyrim_tpu_torch.ops import resample as RS


def _params(rng, C, N, s_pow2=False):
    """LayerNorm over 4C and Dense 4C -> N, f32 numpy."""
    if s_pow2:  # s o W exact in bf16: W on the bf16 grid, s powers of two
        s = 2.0 ** rng.integers(-1, 2, size=4 * C).astype(np.float32)
        w = torch.from_numpy((rng.normal(size=(4 * C, N)) * (4 * C) ** -0.5).astype(np.float32))
        w = w.to(torch.bfloat16).float().numpy()
    else:
        s = (1 + 0.1 * rng.normal(size=4 * C)).astype(np.float32)
        w = (rng.normal(size=(4 * C, N)) * (4 * C) ** -0.5).astype(np.float32)
    ln = (s, (0.3 * rng.normal(size=4 * C)).astype(np.float32))
    return ln, (w, (0.1 * rng.normal(size=N)).astype(np.float32))


def _split_downsample(x, prepared, eps=1e-6):
    """K3's arithmetic in plain PyTorch, in x's float type (f32 or f64):
    the merge of an even-H x, its rows' statistics over the 4C raw values,
    ``inv·(v @ W′ − μ·sw) + ct``."""
    wt, sw, ct = prepared
    Z, H, Wd, C = x.shape
    N, cp = wt.shape[0], wt.shape[1] // 4
    dt = x.dtype
    v = x.reshape(Z, H // 2, 2, Wd // 2, 2, C).permute(0, 1, 3, 2, 4, 5).reshape(-1, 4, C)
    mu = v.mean((1, 2))[:, None]
    var = ((v * v).mean((1, 2))[:, None] - mu * mu).clamp_min(0)
    inv = torch.rsqrt(var + eps)
    w = wt.to(dt).reshape(N, cp // 64, 4, 64).transpose(1, 2).reshape(N, 4, cp)[:, :, :C].reshape(N, 4 * C)
    out = inv * (v.reshape(-1, 4 * C) @ w.T - mu * sw.to(dt)) + ct.to(dt)
    return out.reshape(Z, H // 2, Wd // 2, N)


def _t(tree):
    return tuple(torch.from_numpy(a) for a in tree)


def _input(rng, Z, H, W, C, pad, offset):
    """x (Z, H, W, C) f32 and its view in a buffer of H + pad rows; rows
    (pixels) drawn each with its own scale, and offset by `offset` stds."""
    buf = rng.normal(size=(Z, H + pad, W, C)) * rng.uniform(0.5, 2.0, size=(Z, H + pad, W, 1))
    buf = (buf + offset * buf.std()).astype(np.float32)
    return buf[:, :H], torch.from_numpy(buf)[:, :H]


@pytest.mark.parametrize("H,pad", [(7, 0), (7, 5), (13, 5), (8, 4)], ids=["odd", "odd view", "odd view 13", "even view"])
def test_downsample_module_matches_jax(H, pad):
    """The port's DownSample on (a view of) an odd or even H against the
    JAX DownSample's Pallas path (pad, fused_downsample in interpret mode)
    and its XLA reference."""
    import jax.numpy as jnp

    from skyrim_tpu.ops.resample import fused_downsample as j_fused_downsample
    from skyrim_tpu.ops.resample import reference_downsample as j_reference_downsample

    rng = np.random.default_rng(H + pad)
    Z, W, C, N = 3, 24, 16, 32
    x, xt = _input(rng, Z, H, W, C, pad, 0.0)
    ln, wb = _params(rng, C, N)
    mod = DownSample(C, N)
    with torch.no_grad():
        for p, a in zip((mod.LayerNorm_0.scale, mod.LayerNorm_0.bias, mod.Dense_0.kernel, mod.Dense_0.bias), (*ln, *wb)):
            p.copy_(torch.from_numpy(a))
        out = mod(xt, mod.prepare()).numpy()
    assert out.shape == (Z, -(-H // 2), W // 2, N)
    xp = jnp.pad(jnp.asarray(x), ((0, 0), (0, H % 2), (0, 0), (0, 0)))
    jln, jwb = tuple(map(jnp.asarray, ln)), tuple(map(jnp.asarray, wb))
    np.testing.assert_allclose(out, np.asarray(j_fused_downsample(xp, jln, jwb, interpret=True)), atol=3e-5, rtol=0)
    np.testing.assert_allclose(out, np.asarray(j_reference_downsample(xp, jln, jwb)), atol=3e-5, rtol=0)


@pytest.mark.parametrize("H,pad", [(7, 5), (4, 0)], ids=["view", "contiguous"])
def test_upsample_module_on_view_matches_jax(H, pad):
    """The port's UpSample on the stage's cropped view (read in place on
    the card) against the JAX UpSample's Pallas path, row crop included."""
    import jax.numpy as jnp

    from skyrim_tpu.ops.resample import fused_upsample as j_fused_upsample

    rng = np.random.default_rng(H)
    Z, W, C, Co = 3, 12, 32, 16
    x, xt = _input(rng, Z, H, W, C, pad, 0.0)
    w = (rng.normal(size=(C, 4 * Co)) * C**-0.5).astype(np.float32)
    b = (0.1 * rng.normal(size=4 * Co)).astype(np.float32)
    s, t = rng.normal(size=(2, Co)).astype(np.float32)
    mod = UpSample(C, Co)
    with torch.no_grad():
        for p, a in zip((mod.Dense_0.kernel, mod.Dense_0.bias, mod.LayerNorm_0.scale, mod.LayerNorm_0.bias), (w, b, s, t)):
            p.copy_(torch.from_numpy(a))
        out = mod(xt, 2 * H - 1, mod.prepare()).numpy()
    ref = np.asarray(j_fused_upsample(jnp.asarray(x), (jnp.asarray(w), jnp.asarray(b)), (jnp.asarray(s), jnp.asarray(t)),
                                      interpret=True))[:, : 2 * H - 1]  # fmt: skip
    np.testing.assert_allclose(out, ref, atol=3e-5, rtol=0)


@pytest.mark.parametrize("C,N", [(16, 32), (192, 384), (40, 96)])
def test_prepare_downsample_terms(C, N):
    """W′ᵀ = bf16(s∘W)ᵀ in the kernel's K order (64-channel slices, the four
    parity slabs' slices of the same channels in turn, zeros past C); sw the
    column sums of W′ as rounded; ct = b_ln @ W + b."""
    rng = np.random.default_rng(C)
    ln, wb = _params(rng, C, N)
    wt, sw, ct = RS.prepare_downsample(_t(ln), _t(wb))
    cp = -(-C // 64) * 64
    assert wt.dtype == torch.bfloat16 and tuple(wt.shape) == (N, 4 * cp)
    assert sw.dtype == ct.dtype == torch.float32 and tuple(sw.shape) == tuple(ct.shape) == (N,)
    wq = (torch.from_numpy(ln[0])[:, None] * torch.from_numpy(wb[0])).to(torch.bfloat16)
    slabs = wt.reshape(N, cp // 64, 4, 64).transpose(1, 2).reshape(N, 4, cp)  # (N, slab, channel)
    assert torch.equal(slabs[:, :, :C], wq.T.reshape(N, 4, C))
    assert not slabs[:, :, C:].any()
    # slice k: channels 64 (k // 4) .. of slab k % 4
    assert torch.equal(wt[:, 64:64 + min(C, 64)], wq.T[:, C:C + min(C, 64)])
    np.testing.assert_allclose(sw.numpy(), wq.double().sum(0).numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ct.numpy(), ln[1].astype(np.float64) @ wb[0] + wb[1], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("offset", [0.0, 4.0], ids=["centred", "mean 4 std"])
@pytest.mark.parametrize("C,N", [(16, 32), (192, 384)])
def test_split_downsample_matches_reference(dtype, offset, C, N):
    """K3's split with s∘W exact in bf16 is the reference's LayerNorm +
    Dense, rows offset to |μ| = 4σ included."""
    rng = np.random.default_rng(C + int(offset))
    x, _ = _input(rng, 2, 6, 8, C, 0, offset)
    mu = x.reshape(2, 3, 2, 4, 2, C).transpose(0, 1, 3, 2, 4, 5).reshape(-1, 4 * C)
    if offset:  # the merged rows' |mean| / std, which the split's cancellation must survive
        assert np.median(np.abs(mu.mean(-1)) / mu.std(-1)) > 3
    ln, wb = _params(rng, C, N, s_pow2=True)
    ref = RS.reference_downsample(torch.from_numpy(x).to(dtype), _t(ln), _t(wb))
    out = _split_downsample(torch.from_numpy(x).to(dtype), RS.prepare_downsample(_t(ln), _t(wb)))
    assert out.dtype == dtype
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=3e-5, rtol=0)


@pytest.mark.parametrize("offset", [0.0, 4.0], ids=["centred", "mean 4 std"])
def test_split_downsample_within_bf16_of_reference(offset):
    """With general parameters the split differs from the reference by W′'s
    bf16 rounding alone: within the kernels' tolerance, rows at |μ| = 4σ
    included (the mean cancels on W′'s own column sums)."""
    rng = np.random.default_rng(7)
    C, N = 192, 384
    x, _ = _input(rng, 2, 6, 8, C, 0, offset)
    ln, wb = _params(rng, C, N)
    ref = RS.reference_downsample(torch.from_numpy(x).double(), _t(ln), _t(wb))
    out = _split_downsample(torch.from_numpy(x).double(), RS.prepare_downsample(_t(ln), _t(wb)))
    tol = 2e-2 * ref.std() + 2 * 2.0**-8 * ref.abs().max()
    assert float((out - ref).abs().max()) <= float(tol)


def test_grand_weights_carry_resample_operands():
    """PanguNet's cached weights hold K3's and K4's operands, computed once
    with the parameters."""
    from skyrim_tpu_torch.models.pangu import PanguConfig, PanguModel

    model = PanguModel("pangu6", cfg=PanguConfig(lat=49, lon=96, embed_dim=16, depths=(2, 2, 2, 2),
                                                 num_heads=(2, 2, 2, 2)), device="cpu")  # fmt: skip
    params = model.init_params()
    gw, net = params["cache"]["gw6"], params["net6"]
    wt, sw, ct = gw["down"]
    assert tuple(wt.shape) == (32, 4 * 64) and wt.dtype == torch.bfloat16
    ref = RS.prepare_downsample(net.DownSample_0.LayerNorm_0.sb(), net.DownSample_0.Dense_0.wb())
    assert all(torch.equal(a, b) for a, b in zip(gw["down"], ref))
    w, b, s, t = gw["up"]
    assert w.dtype == torch.bfloat16 and tuple(w.shape) == (32, 64) and b.dtype == s.dtype == t.dtype == torch.float32
