"""The port's finetuning (skyrim_tpu_torch/finetune) against the JAX package's.

Both packages get the same parameters (initialised in JAX, carried over by
``params.from_jax``) and the same numpy batches.

- The dataset: windows, items, the shuffled batch order for a seed and the
  statistics equal JAX's, on ``tests/test_evaluate_finetune.py``'s layout.
- One trainer step per model at its CPU test size, ``compute_dtype`` f32 in
  both packages (in bf16 a gradient summed over every token rounds
  differently in the two frameworks, by more than its own size for a small
  bias): the loss at rtol 1e-3; the clipped gradients leaf by leaf at atol
  3e-5 (tests/ops/test_fused_block.py:49's f32 tolerance), the norm
  statistics' also at rtol 1e-3 (each is a sum over every point and frame,
  ≈ 10⁴ partly cancelling terms: the residual models' normalize(x[-1])
  against denormalize), FuXi's bf16 leaves and the gradients that pass
  through a bf16 value (``BF16_GRADIENTS``) at atol 5e-4, rtol 5e-3
  (tests/ops/test_fused_block.py:190) plus one bf16 ulp (nearly equal f32
  sums round to neighbouring bf16 values); the
  updated leaves within 2·lr·(1 + wd·|p|): Adam's first step moves a leaf
  by lr times the sign of its gradient, so a near-zero gradient whose sign
  differs between the packages lands inside this bound and nowhere else.
  JAX's side is the loss of skyrim_tpu/finetune/trainer.py:91-106 under
  ``jax.value_and_grad`` and its trainer's own optax chain;
  ``test_jax_replica_is_the_jax_step`` holds that replica to JAX's jitted
  train step.
- ``apply`` without ``params["cache"]`` equals ``apply`` with it, and
  JAX's ``apply`` at the model's own f32 tolerance.

JAX is imported inside the fixtures and tests: the card's machine has no
JAX and runs only the ``gpu`` tests of this file.
"""


import numpy as np
import pytest
import torch

from skyrim_tpu_torch.finetune import FineTuneDataset, TrainConfig, Trainer
from skyrim_tpu_torch.finetune.trainer import named_leaves
from skyrim_tpu_torch.params import flatten, from_jax

LR, WD = 1e-3, 0.1
B = 2


# --- the dataset ------------------------------------------------------------------


def test_dataset_matches_jax(tmp_path):
    pytest.importorskip("jax")
    from skyrim_tpu.finetune import FineTuneDataset as JDataset
    from test_evaluate_finetune import _make_dataset

    _make_dataset(tmp_path, n_slices=3, frames=4, nc=4)
    for hist, out in ((1, 1), (2, 1), (2, 2)):
        ds, ref = FineTuneDataset(tmp_path, hist, out), JDataset(tmp_path, hist, out)
        assert ds._index == ref._index and len(ds) == len(ref) == 3 * (4 - hist - out + 1)
        for i in range(len(ds)):
            for a, b in zip(ds[i], ref[i]):
                assert a.dtype == np.float32 and a.shape == b.shape
                np.testing.assert_array_equal(a, b)
        for bs in (1, 2, 4):
            got = list(ds.batches(bs, np.random.default_rng(7)))
            want = list(ref.batches(bs, np.random.default_rng(7)))
            assert len(got) == len(want) == len(ds) // bs
            for (x, y), (jx, jy) in zip(got, want):
                np.testing.assert_array_equal(x, jx)
                np.testing.assert_array_equal(y, jy)
        for a, b in zip(ds.normalization_stats(), ref.normalization_stats()):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    sub = FineTuneDataset(tmp_path, channels=["c02", "c00"])
    np.testing.assert_array_equal(sub[0][0], ds[0][0][:, [2, 0]][:1])


def test_dataset_needs_metadata(tmp_path):
    with pytest.raises(FileNotFoundError, match="metadata.json"):
        FineTuneDataset(tmp_path)


# --- the models at their CPU test sizes -----------------------------------------------


def _pangu():
    import jax
    from skyrim_tpu.models.pangu import PanguConfig as JConfig
    from skyrim_tpu.models.pangu import PanguModel as JModel
    from test_torch_pangu import CFG

    from skyrim_tpu_torch.models.pangu import PanguConfig, PanguModel

    jm = JModel("pangu", cfg=JConfig(**CFG))
    return jm, jax.tree.map(np.asarray, jm.init_params(jax.random.key(0))), PanguModel(
        "pangu", cfg=PanguConfig(**CFG), device="cpu")


def _graphcast():
    """The JAX net takes its dtype when it is built: an f32 subclass."""
    import jax
    import jax.numpy as jnp
    from skyrim_tpu.models.graphcast import GraphCastConfig as JConfig
    from skyrim_tpu.models.graphcast import GraphCastModel as JModel
    from test_torch_graphcast import CFG

    from skyrim_tpu_torch.models.graphcast import GraphCastConfig, GraphCastModel

    jm = type("GraphCastF32", (JModel,), {"compute_dtype": jnp.float32})(JConfig(**CFG, edge_chunks=2))
    return jm, jax.tree.map(np.asarray, jm.init_params(jax.random.key(0))), GraphCastModel(
        GraphCastConfig(**CFG), device="cpu")


SFNO_CFG = dict(lat=17, lon=32, in_channels=3, embed_dim=8, num_layers=1, scale_factor=4)  # JAX's trainer test


def _sfno():
    from test_torch_sfno import _jax_tree

    from skyrim_tpu_torch.models.sfno import FourCastNetV2Model, SFNOConfig

    jm, tree = _jax_tree(SFNO_CFG)
    return jm, tree, FourCastNetV2Model(SFNOConfig(**SFNO_CFG), device="cpu")


def _fengwu():
    import jax
    from skyrim_tpu.models.fengwu import FengWuConfig as JConfig
    from skyrim_tpu.models.fengwu import FengWuModel as JModel
    from test_torch_fengwu import CFG, _drawn

    from skyrim_tpu_torch.models.fengwu import FengWuConfig, FengWuModel

    jm = JModel(JConfig(**CFG))
    return jm, _drawn(jax.tree.map(np.asarray, jm.init_params(jax.random.key(0))), 0), FengWuModel(
        FengWuConfig(**CFG), device="cpu")


def _afno():
    import jax
    from skyrim_tpu.models.afno import AFNOConfig as JConfig
    from skyrim_tpu.models.afno import FourCastNetModel as JModel
    from test_torch_afno import GOLDEN_CFG, _drawn

    from skyrim_tpu_torch.models.afno import AFNOConfig, FourCastNetModel

    jm = JModel(JConfig(**GOLDEN_CFG))
    return jm, _drawn(jax.tree.map(np.asarray, jm.init_params(jax.random.key(0))), 0), FourCastNetModel(
        AFNOConfig(**GOLDEN_CFG), device="cpu")


def _dlwp():
    import jax
    from test_torch_dlwp import SMALL, _drawn, _jax_class

    from skyrim_tpu_torch.models.dlwp import DLWPModel

    jm = _jax_class()()
    return jm, _drawn(jax.tree.map(np.asarray, jm.init_params(jax.random.key(0))), 0), DLWPModel(
        **SMALL, device="cpu")


def _fuxi(v2):
    def make():
        import jax
        from test_torch_fuxi import GOLDEN_CFG, _drawn, _jax_model

        from skyrim_tpu_torch.models.fuxi import FuXiConfig, FuXiModel

        cfg = dict(GOLDEN_CFG, attn_v2=v2)
        jm = _jax_model(cfg)
        return jm, _drawn(jax.tree.map(np.asarray, jm.init_params(jax.random.key(0))), 0), FuXiModel(
            FuXiConfig(**cfg), device="cpu")

    return make


MODELS = {
    "pangu": _pangu, "graphcast": _graphcast, "sfno": _sfno, "fengwu": _fengwu, "afno": _afno,
    "dlwp": _dlwp, "fuxi_v2": _fuxi(True), "fuxi_v1": _fuxi(False),
}  # fmt: skip
# each model's f32 forward tolerance against JAX, as its own test file holds it
APPLY_ATOL = {"graphcast": 1e-4}  # the parts summed in another order over 2 rounds; the rest 3e-5
# models whose JAX side runs its Pallas path (kernels in interpret mode,
# their custom VJPs backward), the algorithm the port runs: GraphCast's XLA
# path is another composition (tests/test_torch_graphcast.py)
PALLAS = {"graphcast"}
# leaves whose gradient passes through a bf16 value in f32 compute, and so
# takes the bf16 tolerance: Pangu's patch embedding and recovery reach the
# network as bf16 grand weights whatever the compute dtype (pangu.py:366 in
# both packages), so their gradients are bf16 roundings of nearly equal sums
BF16_GRADIENTS = {"pangu": ("/embed_", "/recover_")}


@pytest.fixture(scope="module", params=sorted(MODELS))
def models(request):
    """(name, JAX model, numpy tree, port model), both computing in f32."""
    jnp = pytest.importorskip("jax.numpy")
    jm, tree, model = MODELS[request.param]()
    jm.compute_dtype, model.compute_dtype = jnp.float32, torch.float32
    return request.param, jm, tree, model


@pytest.fixture
def jax_path(models, monkeypatch):
    """JAX's path for the model: its Pallas kernels where ``PALLAS`` says."""
    if models[0] in PALLAS:
        import skyrim_tpu.ops.flash_window_attention as fwa

        monkeypatch.setattr(fwa, "use_pallas", lambda: True)


def _bf16_ulp(a):
    """The spacing of the bf16 grid at each element of ``a`` (0 at 0)."""
    a = np.abs(a.astype(np.float64))
    return np.where(a > 0, 2.0 ** (np.floor(np.log2(np.where(a > 0, a, 1))) - 7), 0.0)


def _batch(model, seed=3):
    rng = np.random.default_rng(seed)
    nc, (H, W) = len(model.channels), model.grid.shape
    xs = rng.normal(size=(B, model.n_history, nc, H, W)).astype(np.float32)
    ys = rng.normal(size=(B, model.frames_out, nc, H, W)).astype(np.float32)
    return xs, ys


def _jax_step(jm, tree, xs, ys, cfg):
    """(loss, clipped gradients, updated leaves) of one JAX step, as flat
    numpy trees: trainer.py:91-106's loss under ``jax.value_and_grad`` and
    the JAX trainer's own optax chain (clip_by_global_norm, adamw)."""
    import jax
    import jax.numpy as jnp
    import optax
    from skyrim_tpu.finetune import TrainConfig as JTC
    from skyrim_tpu.finetune import Trainer as JTrainer

    jt = JTrainer(jm, jax.tree.map(jnp.asarray, tree), JTC(**cfg))
    apply = jax.checkpoint(jm.apply)

    def loss_fn(params):
        def rollout_loss(x, y):
            total, state = 0.0, x
            for k in range(jt.config.rollout_steps):
                pred = apply(params, state)
                tgt = jax.lax.dynamic_slice_in_dim(y, k * jm.frames_out, jm.frames_out, axis=0)
                total = total + jnp.mean((pred - tgt) ** 2)
                state = jnp.concatenate([state, pred], axis=0)[-jm.n_history :]
            return total / jt.config.rollout_steps

        return jnp.mean(jax.vmap(rollout_loss)(xs, ys))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jt.params)
    clip = optax.clip_by_global_norm(jt.config.grad_clip)
    clipped, _ = clip.update(grads, clip.init(grads))
    updates, _ = jt.opt.update(grads, jt.opt_state, jt.params)
    new = optax.apply_updates(jt.params, updates)

    def host(t):
        return {k: np.asarray(v.astype(jnp.float32)) for k, v in flatten(jax.tree.map(lambda a: a, t)).items()}

    return float(loss), host(clipped), host(new)


def _port_step(model, params, xs, ys, cfg):
    """(loss, clipped gradients, updated leaves, trainer) of the port's step."""
    tr = Trainer(model, params, TrainConfig(**cfg))
    loss = tr.loss(torch.from_numpy(xs), torch.from_numpy(ys))
    loss.backward()
    tr.clip_gradients()
    grads = {k: p.grad.float().numpy().copy() for k, p in tr.leaves.items()}
    tr.opt.step()
    new = {k: p.detach().float().numpy() for k, p in tr.leaves.items()}
    return float(loss.detach()), grads, new, tr


def test_trainer_step_matches_jax(models, jax_path):
    name, jm, tree, model = models
    xs, ys = _batch(model)
    cfg = dict(batch_size=B, learning_rate=LR, weight_decay=WD)
    jloss, jgrads, jnew = _jax_step(jm, tree, xs, ys, cfg)
    params = from_jax(tree, model)
    loss, grads, new, tr = _port_step(model, params, xs, ys, cfg)
    assert "cache" not in tr.params
    assert set(grads) == set(jgrads) == {k for k in flatten(tree) if not k.startswith("cache/")}
    np.testing.assert_allclose(loss, jloss, rtol=1e-3)
    before = {k: np.asarray(v, np.float32) for k, v in flatten(tree).items()}
    for k in sorted(grads):
        bf16 = tr.leaves[k].dtype == torch.bfloat16 or any(p in k for p in BF16_GRADIENTS.get(name, ()))
        if bf16:  # a bf16 gradient may also be one ulp off: nearly equal sums round to neighbours
            tol = dict(atol=5e-4 + _bf16_ulp(jgrads[k]), rtol=5e-3)
        else:
            tol = dict(atol=3e-5, rtol=1e-3 if k.startswith("norm/") else 0)
        d = np.abs(grads[k] - jgrads[k])
        bad = d > tol["atol"] + tol["rtol"] * np.abs(jgrads[k])
        assert not bad.any(), f"{name} gradient {k}: {bad.sum()} of {bad.size} off, largest {d.max()}"
        bound = 2 * LR * (1 + WD * np.abs(before[k]))
        assert (np.abs(new[k] - jnew[k]) <= bound).all(), f"{name} update {k}: {np.abs(new[k] - jnew[k]).max()}"
    if name == "pangu":  # apply runs net6 only: net24 moves by the decay alone, as optax moves it
        for k in (k for k in grads if k.startswith("net24/")):
            assert not grads[k].any()
            np.testing.assert_allclose(new[k], before[k] * (1 - LR * WD), rtol=1e-6, atol=1e-12)


def test_apply_without_cache_equals_cached_and_jax(models, jax_path):
    """The fault the trainer depended on: ``apply`` indexed ``params["cache"]``
    and raised ``KeyError`` without it, where JAX builds the derived weights
    inline."""
    name, jm, tree, model = models
    import jax

    params = from_jax(tree, model)
    bare = {k: v for k, v in params.items() if k != "cache"}
    x = torch.from_numpy(_batch(model)[0][0])
    with torch.no_grad():
        cached, inline = model.apply(params, x), model.apply(bare, x)
    torch.testing.assert_close(inline, cached, rtol=0, atol=0)
    jtree = {k: v for k, v in jax.tree.map(jax.numpy.asarray, tree).items() if k != "cache"}
    ref = np.asarray(jm.apply(jtree, x.numpy()))
    np.testing.assert_allclose(inline.numpy(), ref, atol=APPLY_ATOL.get(name, 3e-5), rtol=0)


def test_jax_replica_is_the_jax_step():
    """``_jax_step`` (the loss written out, the trainer's optax chain) gives
    what JAX's jitted, donating train step gives, on JAX's own trainer-test
    model."""
    import jax

    jnp = pytest.importorskip("jax.numpy")
    from skyrim_tpu.finetune import TrainConfig as JTC
    from skyrim_tpu.finetune import Trainer as JTrainer

    jm, tree, model = _sfno()
    jm.compute_dtype = jnp.float32
    xs, ys = _batch(model)
    cfg = dict(batch_size=B, learning_rate=LR, weight_decay=WD)
    loss, _, new = _jax_step(jm, tree, xs, ys, cfg)
    jt = JTrainer(jm, jax.tree.map(jnp.asarray, tree), JTC(**cfg))
    p2, _, jloss = jt._step_fn(jt.params, jt.opt_state, xs, ys)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-6)
    for k, v in flatten(jax.tree.map(np.asarray, p2)).items():
        np.testing.assert_allclose(new[k], v, rtol=0, atol=1e-6, err_msg=k)


def test_rollout_loss_rolls_the_history():
    """rollout_steps 2 on GraphCast's two-frame history: the second
    prediction takes (x[-1], pred₁), the loss is the mean of the two steps'
    errors, as trainer.py:91-106."""
    _, _, model = _graphcast()
    params = model.init_params()
    xs, _ = _batch(model)
    ys = np.random.default_rng(4).normal(size=(B, 2, *model.state_shape[1:])).astype(np.float32)
    tr = Trainer(model, params, TrainConfig(batch_size=B, rollout_steps=2, remat=False))
    with torch.no_grad():
        loss = tr.loss(torch.from_numpy(xs), torch.from_numpy(ys))
        want = 0.0
        for x, y in zip(torch.from_numpy(xs), torch.from_numpy(ys)):
            p1 = model.apply(tr.params, x)
            p2 = model.apply(tr.params, torch.cat([x[-1:], p1]))
            want += (torch.mean((p1 - y[:1]) ** 2) + torch.mean((p2 - y[1:]) ** 2)) / 2
    torch.testing.assert_close(loss, want / B, rtol=1e-6, atol=0)


def test_remat_gives_the_same_gradients():
    _, _, model = _pangu()
    params = model.init_params()
    xs, ys = (torch.from_numpy(a) for a in _batch(model))
    grads = []
    for remat in (True, False):
        tr = Trainer(model, params, TrainConfig(batch_size=B, remat=remat))
        tr.loss(xs, ys).backward()
        grads.append({k: p.grad for k, p in tr.leaves.items() if p.grad is not None})
    assert grads[0].keys() == grads[1].keys() and grads[0]
    for k in grads[0]:
        torch.testing.assert_close(grads[0][k], grads[1][k], rtol=0, atol=0, msg=k)


# --- the trainer's contract -----------------------------------------------------------


def test_trainer_strips_derived_cache():
    """As tests/test_evaluate_finetune.py:127: GraphCast's params carry the
    derived edge-embedding cache; the trainer drops it and steps through
    the inline path."""
    _, _, model = _graphcast()
    params = model.init_params()
    assert "cache" in params
    trainer = Trainer(model, params, TrainConfig(batch_size=1))
    assert "cache" not in trainer.params
    before = trainer.params["net"].head.Dense_0.kernel.detach().clone()
    xs, ys = _batch(model)
    loss = trainer.train_step(xs[:1], ys[:1])
    assert np.isfinite(float(loss)) and trainer.step_count == 1
    assert not torch.equal(before, trainer.params["net"].head.Dense_0.kernel.detach())
    # the caller's tree is not touched
    assert "cache" in params and not params["net"].head.Dense_0.kernel.requires_grad


def test_trainer_reduces_loss_and_checkpoint_reloads(tmp_path, monkeypatch):
    """As tests/test_evaluate_finetune.py:102: SFNO on the small dataset for
    three epochs learns something; the checkpoint reloads through
    ``load_params`` and, rebuilt by ``prepare_params``, forecasts what the
    trained tree forecasts."""
    from test_evaluate_finetune import _make_dataset

    from skyrim_tpu_torch.models.sfno import FourCastNetV2Model, SFNOConfig
    from skyrim_tpu_torch.weights import load_checkpoint, load_params

    monkeypatch.setenv("SKYRIM_WEIGHTS_DIR", str(tmp_path / "ckpt"))
    _make_dataset(tmp_path, n_slices=2, frames=4, nc=3)
    ds = FineTuneDataset(tmp_path, n_history=1, frames_out=1)
    model = FourCastNetV2Model(SFNOConfig(**SFNO_CFG), device="cpu")
    trainer = Trainer(model, model.init_params(), TrainConfig(batch_size=2, n_epochs=3, learning_rate=1e-2))
    out = trainer.fit(ds)
    assert len(out["loss"]) == 3 and out["steps"] == 9
    assert out["loss"][-1] < out["loss"][0]
    assert "net" in load_checkpoint(model.name)
    loaded = load_params(model, allow_init=False)
    assert "cache" in loaded
    x = torch.from_numpy(ds[0][0])
    with torch.no_grad():
        torch.testing.assert_close(model.apply(loaded, x), model.apply(model.prepare_params(trainer.params), x),
                                   rtol=0, atol=0)


def test_fit_refuses_short_targets(tmp_path):
    from test_evaluate_finetune import _make_dataset

    from skyrim_tpu_torch.models.sfno import FourCastNetV2Model, SFNOConfig

    _make_dataset(tmp_path, n_slices=1, frames=4, nc=3)
    model = FourCastNetV2Model(SFNOConfig(**SFNO_CFG), device="cpu")
    trainer = Trainer(model, model.init_params(), TrainConfig(rollout_steps=2))
    with pytest.raises(ValueError, match="rollout loss needs 2"):
        trainer.fit(FineTuneDataset(tmp_path, frames_out=1))


def test_trainer_refuses_a_mesh():
    _, _, model = _sfno()
    with pytest.raises(ValueError, match=r"ROADMAP.md §1 item 10"):
        Trainer(model, model.init_params(), mesh=object())


def test_trainer_refuses_an_int8_tree():
    """The port refuses a quantized FuXi tree.  JAX's trainer builds its
    optimizer state over the int8 leaves and fails when the step
    differentiates them: ``jax.grad`` takes floating inputs only."""
    jax = pytest.importorskip("jax")
    from skyrim_tpu.finetune import TrainConfig as JTC
    from skyrim_tpu.finetune import Trainer as JTrainer
    from test_torch_fuxi import GOLDEN_CFG

    from skyrim_tpu_torch.models.fuxi import FuXiConfig, FuXiModel

    model = FuXiModel(FuXiConfig(**GOLDEN_CFG), device="cpu")
    for serve in (False, True):
        q = model.quantize_params(model.init_params(), min_size=256, serve_int8=serve)
        with pytest.raises(ValueError, match="int8-quantized"):
            Trainer(model, q)
    jm = _fuxi(True)()[0]
    jq = jm.quantize_params(jm.init_params(jax.random.key(0)), min_size=256)
    xs, ys = _batch(model)
    with pytest.raises(TypeError, match="grad requires real- or complex-valued inputs"):
        jt = JTrainer(jm, jq, JTC(batch_size=B))
        jt._step_fn(jt.params, jt.opt_state, xs, ys)


def test_named_leaves_are_the_flax_paths():
    _, _, model = _pangu()
    params = model.init_params()
    leaves = named_leaves({k: v for k, v in params.items() if k != "cache"})
    assert {"net6/PanguBlock_3/EarthAttention3D_0/earth_bias", "norm/mean", "norm/std", "consts"} <= set(leaves)
    assert sum(v.numel() for v in leaves.values()) == model.param_count(params)


# --- on the card ---------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_pangu_step_on_the_card_matches_the_plain_path(cuda):
    """One step of a small Pangu through the kernels on the card and one on
    the CPU's plain path, from the same parameters and batch: the leaf
    gradients within a relative L2 error of 2e-2, or, for a leaf whose two
    bf16 gradients differ by more (the earth-bias tables: two bf16
    computations of one differ by about 2 %), the card's no further from the
    CPU's f32 gradient than 1.25x the CPU's bf16 one is."""
    from test_torch_pangu import CFG

    from skyrim_tpu_torch.models.pangu import PanguConfig, PanguModel

    cfg = PanguConfig(**CFG)
    cpu, card = PanguModel("pangu", cfg=cfg, device="cpu"), PanguModel("pangu", cfg=cfg, device=cuda)
    params = cpu.init_params()
    xs, ys = (torch.from_numpy(a) for a in _batch(cpu))
    grads = []
    for model, dtype in ((card, torch.bfloat16), (cpu, torch.bfloat16), (cpu, torch.float32)):
        model.compute_dtype = dtype
        tr = Trainer(model, params, TrainConfig(batch_size=B))
        tr.loss(xs.to(model.device), ys.to(model.device)).backward()
        grads.append({k: p.grad.float().cpu() for k, p in tr.leaves.items() if p.grad is not None})
    kernel, plain, exact = grads
    assert kernel.keys() == plain.keys() == exact.keys()
    for k, r in exact.items():
        if r.norm() > 0 and (kernel[k] - plain[k]).norm() > 2e-2 * plain[k].norm():
            assert (kernel[k] - r).norm() <= 1.25 * (plain[k] - r).norm(), k
