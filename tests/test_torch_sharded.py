"""The port's sharded models and ensembles on 4 gloo ranks, and its mp_worker.

Two launches of 4 CPU ranks (tests/torch_ranks.py).  ``families`` runs
every family of tests/parallel/test_all_models_sharded.py:18-95 at its
tiny widths over a (2, 1, 2) mesh — Pangu, FuXi's V1 flavour and FengWu in
the ``manual`` mode (their window blocks on lon-local covers), the others
in ``gather`` mode.  ``ensembles`` runs ``dp_ensemble_rollout`` and
``ic_ensemble_forecast`` over the same mesh against ``mesh=None``.  The
families' references run here:

- the port's single-process rollout, f32 (``compute_dtype`` f32 in both),
  atol 3e-5;
- JAX's single-device ``scan_rollout`` on the same parameters (initialised
  in JAX, carried over by ``params.from_jax``; GraphCast on JAX's tiled
  path, Pallas in interpret mode, the port's algorithm, as
  tests/test_torch_graphcast.py holds them), f32, at the JAX package's
  own tolerances: 5e-3 of the mean |output| for every family
  (test_all_models_sharded.py:121-125) and 1e-2 of it at every step for
  the manual path (test_fused_shard.py:186-193).  f32 because the two
  packages' plain bf16 paths round in different orders (the port's bf16
  forwards are held to JAX's with the golden tolerance elsewhere).

Pangu's constant masks are drawn at random, so a rank reading another
rank's columns shows.  Then ``mp_worker`` on 2 ranks exits 0 with its ok
lines.
"""

import datetime

import numpy as np
import pytest
import torch

import torch_ranks as R
from skyrim_tpu_torch.params import from_jax
from skyrim_tpu_torch.rollout import scan_rollout

jax = pytest.importorskip("jax")  # the card's machine has no JAX

MANUAL = ("fengwu", "fuxi", "pangu")  # the lon-manual families; the rest step in gather mode
T0 = datetime.datetime(2024, 5, 1, 0)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The launches' inputs and parameters in a directory; per family:
    (JAX's f32 rollout, the port's single-process f32 rollout)."""
    import jax.numpy as jnp

    import skyrim_tpu.ops.flash_window_attention as fwa
    from skyrim_tpu.models.base import PrognosticModel as JModel
    from skyrim_tpu.rollout import scan_rollout as j_scan_rollout
    from tests.parallel.test_all_models_sharded import FAMILIES

    d = tmp_path_factory.mktemp("sharded")
    rng = np.random.default_rng(0)
    refs, x0 = {}, {}
    for name in R.FAMILY_NAMES:
        with pytest.MonkeyPatch.context() as mp:
            if name == "graphcast":  # JAX's tiled path, the port's algorithm (tests/test_torch_graphcast.py)
                mp.setattr(fwa, "use_pallas", lambda: True)
            mp.setattr(JModel, "compute_dtype", jnp.float32)  # a JAX net takes its dtype when it is built
            jmodel = FAMILIES[name]()
            jparams = jmodel.init_params(jax.random.key(0))
            if name == "pangu":
                consts = rng.normal(size=jparams["consts"].shape).astype(np.float32)
                jparams = dict(jparams, consts=jnp.asarray(consts))
            model = R.family(name)
            model.compute_dtype = torch.float32
            params = from_jax(jax.tree.map(np.asarray, jparams), model)
            H, W = model.grid.shape
            x0[name] = rng.normal(size=(model.n_history, len(model.channels), H, W)).astype(np.float32)
            _, jys = j_scan_rollout(jmodel, jparams, jmodel.init_state(jparams, x0[name]), n_steps=2)
        _, ys = scan_rollout(model, params, model.init_state(params, x0[name]), 2)
        refs[name] = (np.asarray(jys), ys.numpy())
        torch.save(params, d / f"params_{name}.pt")
    members = rng.normal(size=(max(R.ENSEMBLE_MEMBERS), 1, 69, 49, 96)).astype(np.float32)
    torch.save({"x0": x0, "members": members, "start": T0}, d / "inputs.pt")
    return d, refs


@pytest.fixture(scope="module")
def runs(inputs):
    """The references, then the 4 ranks' results of ``families``."""
    d, refs = inputs
    return refs, R.launch("families", 4, d)


@pytest.fixture(scope="module")
def ensembles(inputs):
    """The 4 ranks' results of ``ensembles``."""
    return R.launch("ensembles", 4, inputs[0])


@pytest.mark.parametrize("name", R.FAMILY_NAMES)
def test_step_mode(runs, name):
    modes = {out[("family", name)][0] for out in runs[1]}
    assert modes == {"manual" if name in MANUAL else "gather"}


@pytest.mark.parametrize("name", R.FAMILY_NAMES)
def test_sharded_equals_single_process(runs, name):
    _, ref = runs[0][name]
    out = runs[1][0][("family", name)][1].numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=3e-5, rtol=0)


@pytest.mark.parametrize("name", R.FAMILY_NAMES)
def test_sharded_within_jax_tolerances_of_jax_single_device(runs, name):
    ref, _ = runs[0][name]
    out = runs[1][0][("family", name)][1].numpy()
    assert out.shape == ref.shape and np.isfinite(out).all()
    scale = np.abs(ref).mean() + 1e-6
    np.testing.assert_allclose(out / scale, ref / scale, atol=5e-3)
    if name in MANUAL:
        for t in range(ref.shape[0]):
            s = np.abs(ref[t]).mean() + 1e-6
            np.testing.assert_allclose(out[t] / s, ref[t] / s, atol=1e-2, err_msg=f"step {t}")


@pytest.mark.parametrize("members", R.ENSEMBLE_MEMBERS)
def test_dp_ensemble_over_a_mesh_equals_in_turn(ensembles, members):
    """Members split over dp (2) or, where dp does not divide them (3), run
    by every dp rank; each lon-sharded.  Every rank returns all members."""
    for out in ensembles:
        meshed, alone = out[("dp_ensemble", members)]
        assert meshed.shape == alone.shape == (members, 2, 69, 49, 96)
        np.testing.assert_allclose(meshed, alone, atol=3e-5 * np.abs(alone).max(), rtol=0)
        np.testing.assert_array_equal(meshed, ensembles[0][("dp_ensemble", members)][0])


def test_ic_ensemble_forecast_with_a_mesh(ensembles):
    for out in ensembles:
        meshed, alone, same_coords = out["ic_ensemble"]
        assert same_coords and meshed.shape == alone.shape == (2, 2, 69, 49, 96)
        np.testing.assert_allclose(meshed, alone, atol=3e-5 * np.abs(alone).max(), rtol=0)
        np.testing.assert_array_equal(meshed, ensembles[0]["ic_ensemble"][0])
    assert np.abs(meshed[1] - meshed[0]).max() > 0


def test_mp_worker_on_two_ranks(tmp_path):
    logs = R.run_ranks(["-m", "skyrim_tpu_torch.parallel.mp_worker", "--device", "cpu"], 2, tmp_path)
    for r, log in enumerate(logs):
        assert f"mp_worker rank={r} procs=2 backend=gloo device=cpu ok" in log
        assert f"mp_worker rank={r} psum(15.0) ok" in log
        assert "sharded_advance mode=manual mesh=lon2 steps=2" in log and log.rstrip().endswith("ok")
