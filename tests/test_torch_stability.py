"""The port's stability harness (skyrim_tpu_torch/utils/stability.py) against
the JAX package's (skyrim_tpu/utils/stability.py), on the CPU.

Mirrors tests/test_stability_harness.py on the tiny Pangu (pangu6, depths
1-1-1-1) and on DLWP at face 16 on 73×144 (frames_out 2).  Both packages
get the same parameters (JAX's, climatological norm stats, carried over by
``params.from_jax``) and the same IC (JAX's ``synthetic_ic``: the port's
synthetic source seeds differently, ROADMAP.md §3).  Tolerances: each
step's ``rms`` within the golden 3e-2·std and ``amax``, one element's
value, within the golden's 10× for single values (tests/test_golden.py:74),
the std being the normalized output's, which the rms bounds from above (a
bf16 ulp of an amax near 1 is 0.0078); the divergence curves within 5e-2
relative.

JAX is imported inside the fixtures: the card's machine has no JAX.
"""

import numpy as np
import pytest
import torch

from skyrim_tpu_torch.params import from_jax
from skyrim_tpu_torch.utils import stability as S

GOLDEN = 3e-2
PANGU_CFG = dict(lat=49, lon=96, embed_dim=16, depths=(1, 1, 1, 1), num_heads=(2, 2, 2, 2))


@pytest.fixture(scope="module")
def tiny_pangu():
    jax = pytest.importorskip("jax")
    from skyrim_tpu.models.pangu import PanguConfig as JConfig
    from skyrim_tpu.models.pangu import PanguModel as JModel
    from skyrim_tpu.utils import stability as JS

    from skyrim_tpu_torch.models.pangu import PanguConfig, PanguModel

    jm = JModel("pangu6", cfg=JConfig(**PANGU_CFG))
    jparams = JS.climatological_params(jm, jax.random.key(0))
    model = PanguModel("pangu6", cfg=PanguConfig(**PANGU_CFG), device="cpu")
    params = model.prepare_params(from_jax(jax.tree.map(np.asarray, jparams), model))
    return jm, jparams, model, params, JS.synthetic_ic(jm)


@pytest.fixture(scope="module")
def tiny_dlwp():
    jax = pytest.importorskip("jax")
    from skyrim_tpu.utils import stability as JS
    from test_torch_dlwp import SMALL, _jax_class

    from skyrim_tpu_torch.models.dlwp import DLWPModel

    jm = _jax_class()()
    jparams = JS.climatological_params(jm, jax.random.key(0))
    model = DLWPModel(**SMALL, device="cpu")
    params = model.prepare_params(from_jax(jax.tree.map(np.asarray, jparams), model))
    return jm, jparams, model, params, JS.synthetic_ic(jm)


def _close_stats(got, want):
    for k, scale in (("rms", 1), ("amax", 10)):
        assert len(got[k]) == len(want[k])
        for g, w, r in zip(got[k], want[k], want["rms"]):
            assert abs(g - w) <= scale * GOLDEN * r, (k, got[k], want[k])


def _close_curve(got, want, rel=5e-2):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert abs(g - w) <= rel * abs(w), (got, want)


def test_climatological_norm_and_ic_match_jax(tiny_pangu):
    from skyrim_tpu.utils import stability as JS

    jm, _, model, _, x0 = tiny_pangu
    norm, jnorm = S.climatological_norm(model.channels), JS.climatological_norm(jm.channels)
    for k in ("mean", "std"):
        np.testing.assert_array_equal(norm[k].numpy().ravel(), np.asarray(jnorm[k]).ravel())
    x = S.synthetic_ic(model)
    assert x.shape == x0.shape and x.dtype == np.float32
    z = (x[0] - norm["mean"].numpy().reshape(-1, 1, 1)) / norm["std"].numpy().reshape(-1, 1, 1)
    assert 0.2 < float(np.sqrt(np.mean(z**2))) < 3.0


@pytest.mark.parametrize("which", ["pangu", "dlwp"])
def test_stability_rollout_matches_jax(which, tiny_pangu, tiny_dlwp):
    from skyrim_tpu.utils import stability as JS

    jm, jparams, model, params, x0 = tiny_pangu if which == "pangu" else tiny_dlwp
    r, jr = S.stability_rollout(model, params, x0, 4), JS.stability_rollout(jm, jparams, x0, 4)
    assert {k: r[k] for k in ("n_steps", "n_calls", "finite", "all_finite")} == {
        k: jr[k] for k in ("n_steps", "n_calls", "finite", "all_finite")}
    assert r["n_calls"] == (4 if which == "pangu" else 2) and r["all_finite"]
    _close_stats(r, jr)
    assert r["growth_per_step_geo"] < 1.5


def test_precision_divergence_matches_jax(tiny_pangu):
    from skyrim_tpu.utils import stability as JS

    jm, jparams, model, params, x0 = tiny_pangu
    d, jd = S.precision_divergence(model, params, x0, 2), JS.precision_divergence(jm, jparams, x0, 2)
    assert 0.0 < d["rel_l2"][0] < 0.05
    _close_curve(d["rel_l2"], jd["rel_l2"])
    seq = S.precision_divergence(model, params, x0, 2, sequential=True, fp32_device="cpu")
    assert seq["mode"] == "sequential" and seq["rel_l2"] == d["rel_l2"]


def test_precision_divergence_refuses_tpu_options(tiny_pangu):
    _, _, model, params, x0 = tiny_pangu
    for opt in ("fp32_pallas", "fp32_strip_cache", "fp32_share_cache"):
        with pytest.raises(ValueError, match=opt):
            S.precision_divergence(model, params, x0, 1, **{opt: True})
    with pytest.raises(ValueError, match="sequential"):
        S.precision_divergence(model, params, x0, 1, fp32_device="cpu")


def test_fp32_leg_runs_the_plain_compositions_with_tf32_off(tiny_pangu, monkeypatch):
    """The bf16 leg steps the model itself through the wrappers; the f32 leg
    a copy computing in f32, every wrapper on its plain version and TF32 off;
    the settings restored after."""
    from skyrim_tpu_torch.ops import vjp

    _, _, model, params, x0 = tiny_pangu
    seen, real = [], type(model).advance

    def spy(self, p, s):
        seen.append((self is model, vjp._PLAIN[0], torch.backends.cuda.matmul.allow_tf32,
                     torch.get_float32_matmul_precision(), self.compute_dtype))
        return real(self, p, s)

    monkeypatch.setattr(type(model), "advance", spy)
    before = (torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision())
    S.precision_divergence(model, params, x0, 1)
    assert (torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision()) == before
    assert vjp._PLAIN[0] == 0
    assert seen == [(True, 0, before[0], before[1], torch.bfloat16), (False, 1, False, "highest", torch.float32)]


@pytest.mark.parametrize("which", ["pangu", "dlwp"])
def test_perturbation_control_matches_jax(which, tiny_pangu, tiny_dlwp):
    from skyrim_tpu.utils import stability as JS

    jm, jparams, model, params, x0 = tiny_pangu if which == "pangu" else tiny_dlwp
    c, jc = S.perturbation_control(model, params, x0, 3, eps=1e-4), JS.perturbation_control(jm, jparams, x0, 3, eps=1e-4)
    assert all(np.isfinite(v) for v in c["rel_l2"]) and 1e-6 < c["rel_l2"][0] < 1e-1
    assert c["implied_bf16_floor_last_step"] > 0
    _close_curve(c["rel_l2"], jc["rel_l2"], rel=0.5)


@pytest.mark.parametrize("which", ["pangu", "dlwp"])
def test_delta_decomposition_matches_jax(which, tiny_pangu, tiny_dlwp):
    from skyrim_tpu.utils import stability as JS

    jm, jparams, model, params, x0 = tiny_pangu if which == "pangu" else tiny_dlwp
    n = 8 if which == "pangu" else 4
    d, jd = S.delta_decomposition(model, params, x0, n), JS.delta_decomposition(jm, jparams, x0, n)
    assert len(d["rms"]) == (8 if which == "pangu" else 2)
    _close_stats({"rms": d["rms"], "amax": d["rms_delta"]}, {"rms": jd["rms"], "amax": jd["rms_delta"]})
    assert all(v > 0 for v in d["rms_delta"])


def test_params_divergence_matches_jax(tiny_pangu):
    """Two trees, the second with every network weight scaled by 1.01 (its
    derived cache rebuilt from them)."""
    import jax
    from skyrim_tpu.utils import stability as JS

    jm, jparams, model, params, x0 = tiny_pangu
    jb = jm.prepare_params({k: jax.tree.map(lambda a: a * 1.01, v) if k.startswith("net") else v
                            for k, v in jparams.items() if k != "cache"})
    pb = model.prepare_params(from_jax(jax.tree.map(np.asarray, jb), model))
    d, jd = S.params_divergence(model, params, pb, x0, 2), JS.params_divergence(jm, jparams, jb, x0, 2)
    assert all(v > 0 for v in d["rel_l2"])
    _close_curve(d["rel_l2"], jd["rel_l2"])
