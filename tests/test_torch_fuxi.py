"""The port's FuXi (both block flavours, the cascade) against the JAX package's.

Both packages get the same parameters (initialised in JAX, bf16 at rest;
the biases, LayerNorm affines, V1 bias tables, ``logit_scale`` and the
normalisation stats then drawn from a numpy seed, each in its leaf's
dtype, so that each of them acts; carried over by
``skyrim_tpu_torch.params.from_jax``) and the same numpy inputs.  The
configurations are the golden one (tests/test_golden.py:43-45: 49 rows →
13 token rows → 7 trunk rows padded to 12 for the window, so the
valid-row mask acts in both blocks of the pair) and FUXI_TINY
(tests/models/test_fuxi_fengwu.py:9-12: stage_steps 2 for the cascade).
On the CPU the JAX package takes its XLA path (``nn.Conv`` /
``nn.ConvTranspose``, jnp attention); the port its GEMMs, the Swin-V2
composition and the plain versions of K1 and K2.

Tolerances:
- f32 (``compute_dtype`` f32 in both): atol 3e-5, as
  tests/ops/test_fused_block.py:49;
- bf16: the golden tolerance tol = 3e-2·std (tests/test_golden.py:74) on
  the mean, the spread and the RMS of the difference, 10·tol elementwise.

JAX is imported inside the fixtures and tests: the card's machine has
no JAX and runs only the ``gpu`` test of this file.
"""

import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from skyrim_tpu_torch.core import GlobalModel, GlobalPrediction, Skyrim
from skyrim_tpu_torch.io import SaveConfig, load_forecast
from skyrim_tpu_torch.models.fuxi import FuXiConfig, FuXiModel, swin_v2_block, swin_v2_terms
from skyrim_tpu_torch.ops import windows as W
from skyrim_tpu_torch.params import as_tensor, flatten, from_jax, to_tree, unflatten
from skyrim_tpu_torch.rollout import scan_rollout
from skyrim_tpu_torch.weights import checkpoint_dir, convert, load_checkpoint, load_params, save_checkpoint
from test_torch_pangu import assert_golden_close
from test_torch_sfno import START, _write_ic

GOLDEN_CFG = dict(lat=49, lon=96, in_channels=5, embed_dim=16, depth=2, num_heads=2)
TINY_CFG = dict(lat=49, lon=96, in_channels=6, embed_dim=32, depth=2, num_heads=2, stage_steps=2, n_stages=3)


def _drawn(tree, seed):
    """The tree with its constant-initialised leaves (and the V1 bias
    tables, at 0.5) drawn from a numpy seed in each leaf's dtype;
    ``logit_scale`` over [1, 5.5], so that the clamp at log 100 acts on
    some heads."""
    rng = np.random.default_rng(seed)
    leaves = flatten(tree)
    for k, v in leaves.items():
        leaf = k.rsplit("/", 1)[-1]
        if leaf in ("bias", "mean", "rel_bias"):
            new = (0.5 if leaf == "rel_bias" else 0.3) * rng.normal(size=v.shape)
        elif leaf in ("scale", "std"):
            new = rng.uniform(0.5, 2.0, size=v.shape)
        elif leaf == "logit_scale":
            new = rng.uniform(1.0, 5.5, size=v.shape)
        else:
            continue
        leaves[k] = new.astype(np.float32).astype(v.dtype)
    return unflatten(leaves)


def _jax_model(cfg: dict):
    pytest.importorskip("jax")
    from skyrim_tpu.models.fuxi import FuXiConfig as JConfig
    from skyrim_tpu.models.fuxi import FuXiModel as JModel

    return JModel(JConfig(**cfg))


def _pair(cfg: dict, seed: int = 0):
    import jax

    jmodel = _jax_model(cfg)
    tree = _drawn(jax.tree.map(np.asarray, jmodel.init_params(jax.random.key(0))), seed)
    model = FuXiModel(FuXiConfig(**cfg), device="cpu")
    return jmodel, tree, model, from_jax(tree, model)


@pytest.fixture(scope="module", params=[True, False], ids=["v2", "v1"])
def pair(request):
    pytest.importorskip("jax")
    return _pair(dict(GOLDEN_CFG, attn_v2=request.param))


@pytest.fixture(scope="module")
def tiny():
    pytest.importorskip("jax")
    return _pair(TINY_CFG, seed=3)


def _x(model, seed=1):
    return np.random.default_rng(seed).normal(size=model.state_shape).astype(np.float32)


# --- the pieces ------------------------------------------------------------------


@pytest.mark.parametrize("window", [(6, 12), (2, 4), (3, 5), (1, 1)])
def test_swin_v2_tables_equal_jax(window):
    pytest.importorskip("jax")
    from skyrim_tpu.ops import windows as JW

    np.testing.assert_array_equal(W.swin_rel_index(window), JW.swin_rel_index(window))
    out, ref = W.swin_v2_log_coords(window), JW.swin_v2_log_coords(window)
    assert out.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("shifted", [False, True])
def test_swin_v2_block_matches_jax(shifted):
    """One Swin-V2 block alone, f32, on an (18, 24, 32) activation whose last
    5 rows are padding (valid_h 13), against the JAX SwinBlock2D(v2=True)."""
    jax = pytest.importorskip("jax")
    from skyrim_tpu.models.fuxi import SwinBlock2D as JBlock

    dim, heads, window, valid_h = 32, 2, (6, 12), 13
    x = np.random.default_rng(5).normal(size=(18, 24, dim)).astype(np.float32)
    jblock = JBlock(dim, heads, window, shifted=shifted, valid_h=valid_h, v2=True)
    tree = _drawn(jax.tree.map(np.asarray, jblock.init(jax.random.key(1), x)["params"]), 2)
    ref = np.asarray(jblock.apply({"params": tree}, x))
    prm = {k: torch.from_numpy(np.array(v)) for k, v in flatten(tree).items()}
    assert prm["logit_scale"].max() > math.log(100.0) > prm["logit_scale"].min()  # the clamp acts
    bias, scale = swin_v2_terms(prm, window)
    assert tuple(bias.shape) == (heads, 72, 72) and tuple(scale.shape) == (heads, 1, 1)
    out = swin_v2_block(torch.from_numpy(x), prm, bias, scale, heads, window, shifted, valid_h).numpy()
    np.testing.assert_allclose(out, ref, atol=3e-5, rtol=0)


def test_bridge_consumes_every_leaf_once(pair):
    """Three stages, bf16 leaves loaded exactly as bf16 parameters."""
    _, tree, model, params = pair
    assert len(params["stages"]) == 3
    port = {f"stages/{s}/" + n.replace(".", "/") for s, net in enumerate(params["stages"])
            for n, _ in net.named_parameters()} | {"norm/mean", "norm/std"}
    leaves = flatten(tree)
    assert port == set(leaves)  # one port parameter per leaf, and no other
    for s, net in enumerate(params["stages"]):
        for n, p in net.named_parameters():
            ref = as_tensor(leaves[f"stages/{s}/" + n.replace(".", "/")])
            assert p.dtype == torch.bfloat16 and torch.equal(p, ref), n
    with pytest.raises(ValueError, match="unconsumed"):
        from_jax(dict(tree, unused={"w": np.zeros(2, np.float32)}), model)
    with pytest.raises(KeyError):
        from_jax(dict(tree, norm={"mean": tree["norm"]["mean"]}), model)


def test_init_params_tree_matches_jax(pair):
    """Shapes and dtypes leaf for leaf; logit_scale log 10 in bf16; a stacked
    kernel's fan-in counts one layer."""
    _, tree, model, _ = pair
    params = model.init_params(torch.Generator().manual_seed(0))
    out = flatten(to_tree(params))
    ref = flatten(tree)
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in out.items()} == \
           {k: (tuple(v.shape), str(v.dtype)) for k, v in ref.items()}
    a = params["stages"][1].pairs["a"]
    if model.cfg.attn_v2:
        assert torch.all(a.logit_scale == torch.tensor(math.log(10.0), dtype=torch.bfloat16))
        assert torch.all(a.norm1.scale == 1) and torch.all(a.cpb_fc1.bias == 0)
    else:
        assert a.rel_bias.float().abs().max() <= 0.04 + 1e-3 and 0.01 < a.rel_bias.float().std() < 0.025
    C = model.cfg.embed_dim
    std = a.Dense_1.kernel.float().std().item()  # lecun_normal over fan-in 4C
    assert 0.7 < std * math.sqrt(4 * C) < 1.3
    assert not torch.equal(params["stages"][0].pairs["a"].qkv.kernel, params["stages"][1].pairs["a"].qkv.kernel)


def test_checkpoint_round_trip(pair, tmp_path, monkeypatch):
    """The port's checkpoint stores the stages' bf16 leaves and the list of
    stages, and reads them back into the same parameters."""
    monkeypatch.setenv("SKYRIM_WEIGHTS_DIR", str(tmp_path))
    _, _, model, params = pair
    save_checkpoint("fuxi", params)
    tree = load_checkpoint("fuxi")
    assert isinstance(tree["stages"], list) and len(tree["stages"]) == 3
    assert tree["stages"][2]["pairs"]["b"]["qkv"]["kernel"].dtype == torch.bfloat16
    back = load_params(model)
    for s in range(3):
        for (n, p), (_, q) in zip(params["stages"][s].named_parameters(), back["stages"][s].named_parameters()):
            assert torch.equal(p, q), n
    torch.testing.assert_close(back["norm"]["std"], params["norm"]["std"], rtol=0, atol=0)


# --- the forward -----------------------------------------------------------------


def test_forward_matches_jax_f32(pair, monkeypatch):
    import jax
    import jax.numpy as jnp

    jmodel, tree, model, params = pair
    monkeypatch.setattr(jmodel, "compute_dtype", jnp.float32)
    monkeypatch.setattr(model, "compute_dtype", torch.float32)
    x = _x(model)
    ref = np.asarray(jax.jit(jmodel.apply)(tree, x))
    out = model.apply(params, torch.from_numpy(x)).numpy()
    assert out.shape == (1, 5, 49, 96)
    np.testing.assert_allclose(out, ref, atol=3e-5, rtol=0)


def test_forward_matches_jax_bf16(pair):
    import jax

    jmodel, tree, model, params = pair
    x = _x(model, 2)
    ref = np.asarray(jax.jit(jmodel.apply)(tree, x))
    out = model.apply(params, torch.from_numpy(x)).numpy()
    assert np.isfinite(out).all()
    assert_golden_close(out, ref)


def test_golden_values():
    """tests/golden_values.json's ``fuxi`` entry from the JAX package's key-7
    parameters and the golden input, through the port."""
    import jax

    golden = json.loads((Path(__file__).parent / "golden_values.json").read_text())["fuxi"]
    jmodel = _jax_model(GOLDEN_CFG)
    model = FuXiModel(FuXiConfig(**GOLDEN_CFG), device="cpu")
    params = from_jax(jax.tree.map(np.asarray, jmodel.init_params(jax.random.key(7))), model)
    x = np.random.default_rng(13).normal(size=model.state_shape).astype(np.float32)
    y = model.apply(params, torch.from_numpy(x)).numpy().astype(np.float64)
    assert list(y.shape) == golden["shape"]
    flat = y.reshape(-1)
    tol = 3e-2 * (abs(golden["std"]) + 1e-6)
    assert abs(flat.mean() - golden["mean"]) < tol and abs(flat.std() - golden["std"]) < tol
    np.testing.assert_allclose(flat[np.asarray(golden["samples_idx"])], golden["samples"], atol=10 * tol)


def test_cascade_matches_jax(tiny, monkeypatch):
    """6 advances with stage_steps 2 cross both stage boundaries (stages 0, 0,
    1, 1, 2, 2), f32, against JAX's advance (lax.switch) step by step; each
    step equals ``_forward`` of its stage; trim_stages keeps what a rollout
    reaches."""
    import jax
    import jax.numpy as jnp

    jmodel, tree, model, params = tiny
    monkeypatch.setattr(jmodel, "compute_dtype", jnp.float32)
    monkeypatch.setattr(model, "compute_dtype", torch.float32)
    x = _x(model, 4)
    jstate, state = jmodel.init_state(tree, x), model.init_state(params, x)
    jstep = jax.jit(jmodel.advance)
    for step in range(6):
        before = state.x
        jstate, jy = jstep(tree, jstate)
        state, y = model.advance(params, state)
        assert state.step == step + 1
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=3e-5, rtol=0, err_msg=f"step {step}")
        direct = model._forward(params["stages"][step // 2], params, before)
        np.testing.assert_array_equal(y[0].numpy(), direct.numpy())
        state = state.replace(x=torch.from_numpy(np.array(jstate.x)))  # the next step from the same state
    for n in (1, 2, 3, 4, 5, 100):
        assert len(model.trim_stages(params, n)["stages"]) == len(jmodel.trim_stages(tree, n)["stages"])
    assert len(model.floor_params(params)["stages"]) == 1


def test_global_model_rollout_matches_jax(pair, tmp_path):
    """4 steps of GlobalModel.forecast from a 2-frame file: IC in both
    packages, f32, atol 3e-5 per step."""
    import jax.numpy as jnp

    from skyrim_tpu.core.model import GlobalModel as JGlobalModel

    jmodel, tree, model, params = pair
    ic = tmp_path / "ic.nc"
    data = _write_ic(ic, model.channels, n_frames=2)
    jgm = JGlobalModel("fuxi", ic_source=f"file:{ic}", model_kwargs={"cfg": jmodel.cfg}, params=tree)
    gm = GlobalModel("fuxi", ic_source=f"file:{ic}", model_kwargs={"cfg": model.cfg}, params=params, device="cpu")
    jgm.model.compute_dtype, gm.model.compute_dtype = jnp.float32, torch.float32
    ref, out = jgm.forecast(START, n_steps=4), gm.forecast(START, n_steps=4)
    assert out.data.shape == ref.data.shape == (5, 5, 49, 96)
    np.testing.assert_array_equal(out.data[0], data[-1])
    np.testing.assert_array_equal(out.coords["time"], ref.coords["time"])
    np.testing.assert_allclose(out.data[1:], ref.data[1:], atol=3e-5, rtol=0)


def test_skyrim_predict_matches_jax(pair, tmp_path, monkeypatch):
    """Skyrim("fuxi", ic_source="file:…").predict in both packages, bf16:
    the same files, fields within the golden tolerance."""
    from skyrim_tpu.core.skyrim import Skyrim as JSkyrim
    from skyrim_tpu.io.save import SaveConfig as JSaveConfig
    from skyrim_tpu.io.save import load_forecast as j_load_forecast

    monkeypatch.setenv("SKYRIM_WEIGHTS_DIR", str(tmp_path / "weights"))
    jmodel, tree, model, params = pair
    ic = tmp_path / "ic.nc"
    _write_ic(ic, model.channels, n_frames=2)
    jsky = JSkyrim("fuxi", ic_source=f"file:{ic}", model_kwargs={"cfg": jmodel.cfg}, params=tree)
    sky = Skyrim("fuxi", ic_source=f"file:{ic}", model_kwargs={"cfg": model.cfg}, params=params, device="cpu")
    _, jpaths = jsky.predict("20240501", "0000", lead_time=13, save=True,
                             save_config=JSaveConfig(forecast_id="fc", output_dir=str(tmp_path / "jax")))
    pred, paths = sky.predict("20240501", "0000", lead_time=13, save=True,
                              save_config=SaveConfig(forecast_id="fc", output_dir=str(tmp_path / "torch")))
    assert [Path(p).name for p in paths] == [Path(p).name for p in jpaths] and len(paths) == 2
    np.testing.assert_array_equal(GlobalPrediction(paths[-1]).prediction.data, pred.prediction.data)
    for p, jp in zip(paths, jpaths):
        out, ref = load_forecast(p), j_load_forecast(jp)
        assert out.dims == ref.dims and out.attrs == ref.attrs and out.data.shape == (1, 5, 49, 96)
        assert_golden_close(out.data, ref.data)
    assert "fuxi" in Skyrim.list_available_models()


# --- the converter -----------------------------------------------------------------


def _assert_converted_equal(out, ref):
    """The port's tree (bf16 leaves as tensors) equals the JAX converter's
    (bf16 leaves as numpy bfloat16) leaf for leaf, bit for bit."""
    fo, fr = flatten(out), flatten(ref)
    assert sorted(fo) == sorted(fr), sorted(set(fo) ^ set(fr))[:8]
    for k in fo:
        a, b = as_tensor(fo[k]), as_tensor(fr[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype, b.dtype, a.shape, b.shape)
        assert torch.equal(a, b), k


@pytest.mark.parametrize("case", ["v1", "v2", "v2 split qkv bias"])
def test_converter_matches_jax(case):
    """On tests/test_weights_convert.py's synthetic FuXi state dicts (V1, V2
    with a fused qkv bias, V2 with the official q_bias/v_bias split) the
    port's convert_fuxi gives the JAX tree leaf for leaf, every tensor
    consumed, and the tree runs."""
    jax = pytest.importorskip("jax")
    import test_weights_convert as twc

    jmodel, sd, _ = twc._make_fuxi_case(attn_v2=case != "v1", split_qkv_bias="split" in case)
    model = FuXiModel(FuXiConfig(**dataclasses.asdict(jmodel.cfg)), device="cpu")
    tracked = convert._TrackedSD(sd)
    out = convert.convert_fuxi(model, tracked)
    assert tracked.consumed == set(sd)
    _assert_converted_equal(out, jax.tree.map(np.asarray, twc.convert.convert_fuxi(jmodel, sd)))
    if "split" in case:
        D = model.cfg.embed_dim
        assert not out["stages"][0]["pairs"]["a"]["qkv"]["bias"][:, D:2 * D].any()
    params = from_jax(out, model)
    assert np.isfinite(model.apply(params, torch.from_numpy(_x(model))).numpy()).all()


def test_converter_conv_updown(tmp_path):
    """k=2/s=2 Conv2d down and ConvTranspose2d up weights map onto the
    patch-merge GEMMs as the JAX converter maps them, from a state dict and
    from three traced ONNX stage files (convert_fuxi_onnx_cascade, the
    strided-conv program of the rename pass); a 3×3 kernel is refused."""
    jax = pytest.importorskip("jax")
    import test_weights_convert as twc

    jmodel, sd, _ = twc._make_fuxi_case(attn_v2=True)
    rng = np.random.default_rng(9)
    D, Dc = jmodel.cfg.embed_dim, jmodel.cfg.cube_dim
    for s in range(jmodel.cfg.n_stages):
        sd[f"stages.{s}.down.weight"] = rng.normal(size=(D, Dc, 2, 2)).astype(np.float32)
        sd[f"stages.{s}.down.bias"] = rng.normal(size=(D,)).astype(np.float32)
        sd[f"stages.{s}.up.weight"] = rng.normal(size=(D, Dc, 2, 2)).astype(np.float32)
    model = FuXiModel(FuXiConfig(**dataclasses.asdict(jmodel.cfg)), device="cpu")
    out = convert.convert_fuxi(model, sd)
    _assert_converted_equal(out, jax.tree.map(np.asarray, twc.convert.convert_fuxi(jmodel, sd)))
    assert tuple(out["stages"][0]["down"]["kernel"].shape) == (4 * Dc, D)
    from skyrim_tpu.weights.onnx_io import build_onnx
    from test_onnx_rename import _Trace, _trace_v2_block

    paths = []
    for s in range(jmodel.cfg.n_stages):  # tests/test_onnx_rename.py's traced stage, conv down/up
        tr, p = _Trace(), f"stages.{s}"
        tr.op("Conv", sd[f"{p}.cube_embed.weight"], sd[f"{p}.cube_embed.bias"])
        tr.ln(sd[f"{p}.down_norm.weight"], sd[f"{p}.down_norm.bias"])
        tr.op("Conv", sd[f"{p}.down.weight"], sd[f"{p}.down.bias"])
        for i in range(jmodel.cfg.depth):
            _trace_v2_block(tr, sd, f"{p}.blocks.{i}")
        tr.op("ConvTranspose", sd[f"{p}.up.weight"])
        tr.ln(sd[f"{p}.up_norm.weight"], sd[f"{p}.up_norm.bias"])
        tr.linear(sd[f"{p}.fuse.weight"], sd[f"{p}.fuse.bias"])
        tr.op("ConvTranspose", sd[f"{p}.head.weight"], sd[f"{p}.head.bias"])
        paths.append(tmp_path / f"stage{s}.onnx")
        paths[-1].write_bytes(build_onnx(tr.tensors, nodes=tr.nodes, graph_inputs=("input",)))
    cascade = convert.convert_fuxi_onnx_cascade(model, paths)
    _assert_converted_equal(cascade, jax.tree.map(np.asarray, twc.convert.convert_fuxi_onnx_cascade(jmodel, paths)))
    assert tuple(cascade["stages"][2]["up"]["kernel"].shape) == (D, 4 * Dc)
    sd["stages.0.down.weight"] = rng.normal(size=(D, Dc, 3, 3)).astype(np.float32)
    with pytest.raises(ValueError, match="k=2/s=2"):
        convert.convert_fuxi(model, sd)


def test_staged_state_dict_reaches_global_model(tmp_path, monkeypatch):
    """A staged fuxi.pt is converted, saved as the port's checkpoint and taken
    by GlobalModel without params."""
    pytest.importorskip("jax")
    import test_weights_convert as twc

    monkeypatch.setenv("SKYRIM_WEIGHTS_DIR", str(tmp_path))
    jmodel, sd, _ = twc._make_fuxi_case(attn_v2=True)
    cfg = FuXiConfig(**dataclasses.asdict(jmodel.cfg))
    model = FuXiModel(cfg, device="cpu")
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, checkpoint_dir("fuxi").with_suffix(".pt"))
    gm = GlobalModel("fuxi", ic_source="synthetic", model_kwargs={"cfg": cfg}, device="cpu")
    assert (checkpoint_dir("fuxi") / "torch_0.pt").exists()
    expect = from_jax(convert.convert_fuxi(model, sd), model)
    x = torch.from_numpy(_x(model, 4))
    np.testing.assert_array_equal(model.apply(gm.params, x).numpy(), model.apply(expect, x).numpy())


@pytest.mark.parametrize("attn_v2", [True, False])
def test_published_widths(attn_v2):
    """The JAX defaults: 70 channels, 2 frames, trunk 1536 with 24 heads of 64
    at window (6, 12), 48 blocks as 24 stacked pairs; the parameter count
    of a stage equals JAX's from jax.eval_shape."""
    jax = pytest.importorskip("jax")
    from skyrim_tpu.models.fuxi import FuXiConfig as JConfig
    from skyrim_tpu.models.fuxi import FuXiModel as JModel

    cfg = FuXiConfig(attn_v2=attn_v2)
    assert cfg.tokens == (181, 360) and cfg.embed_dim // cfg.num_heads == 64
    net = FuXiModel(cfg, device="cpu").new_net()
    assert tuple(net.pairs["a"].qkv.kernel.shape) == (24, 1536, 4608)
    jmodel = JModel(JConfig(attn_v2=attn_v2))
    dummy = jax.ShapeDtypeStruct((140, 721, 1440), np.float32)
    shapes = jax.eval_shape(jmodel.module.init, jax.random.key(0), dummy)["params"]
    ref = {k: tuple(v.shape) for k, v in flatten(jax.tree.map(lambda a: a, shapes)).items()}
    assert {n.replace(".", "/"): tuple(p.shape) for n, p in net.named_parameters()} == ref
    count = sum(p.numel() for p in net.parameters())
    assert count == sum(math.prod(s) for s in ref.values()) and 1.3e9 < count < 1.45e9


# --- the card ----------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("attn_v2", [True, False])
def test_small_config_card_matches_cpu(attn_v2):
    """The same seeded parameters and input on the card (K2, and K1 for V1)
    and the CPU (their plain versions), 4 bf16 steps over the golden
    configuration, golden tolerance per step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from skyrim_tpu_torch.ops import fused_block as FB
    from skyrim_tpu_torch.ops import roll as RL

    outs = {}
    for device in ("cuda", "cpu"):
        model = FuXiModel(FuXiConfig(**GOLDEN_CFG, attn_v2=attn_v2), device=device)
        params = model.init_params(torch.Generator().manual_seed(0))
        FB.fused_swin_block.launches = RL.roll3d.launches = 0
        x = np.random.default_rng(0).normal(size=model.state_shape).astype(np.float32)
        _, ys = scan_rollout(model, params, model.init_state(params, x), 4)
        outs[device] = ys.float().cpu().numpy()
        if device == "cuda":  # a pair a step, the shifted block between two rolls
            assert RL.roll3d.launches == 8 and FB.fused_swin_block.launches == (0 if attn_v2 else 8)
    for step in range(4):
        assert_golden_close(outs["cuda"][step], outs["cpu"][step])
