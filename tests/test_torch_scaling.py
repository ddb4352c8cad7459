"""The port's scaling harness, collective accounting and mesh trainer, on gloo
ranks on the CPU (tests/torch_ranks.py's ``tooling`` program, 2 ranks).

- ``parallel/scaling_bench.py``: the efficiency arithmetic of JAX's test,
  and a run over 1 and 2 ranks of its own launcher, ``time_sliced`` set.
- ``parallel/collective_analysis.py``: the bytes a rank sends in one
  lon-sharded step of the small Pangu over (1,1,2) equal the halo bytes
  reckoned from its window shapes, and for the 1-1-1-1 Pangu of JAX's
  ``test_end_to_end_tiny_manual_pangu`` they equal what JAX's
  ``analyze_model`` counts on its manual path (``SKYRIM_FORCE_PALLAS``, two
  virtual devices) over the same exchange: its collective-permutes' link
  bytes (a 2-ring hop is one link; JAX's permute that comes round to its own
  device is a copy in the port, not an exchange).  The projections' algebra
  as JAX's tests hold it.
- The mesh trainer (``finetune/trainer.py``) at (2,1,1) and (1,1,2): two
  steps of batch 2 on the small SFNO in f32, against JAX's single-device
  ``Trainer`` at the same batch: losses at rtol 1e-3, the global gradient
  norms (before the clip) at rtol 1e-4, the leaves at atol 3e-5, rtol 1e-3
  (tests/test_torch_finetune.py's f32 tolerance); both ranks' leaves
  bit-equal; and against the port's single-process ``Trainer`` at 1e-6.

JAX is imported inside the tests: the card's machine has no JAX.
"""

import numpy as np
import pytest
import torch

import torch_ranks
from skyrim_tpu_torch.parallel import collective_analysis as CA
from skyrim_tpu_torch.parallel.scaling_bench import add_efficiency, run_scaling

LR, WD, B = 1e-3, 0.1, 2


def test_add_efficiency_from_own_output():
    results = [
        {"devices": 1, "wall_s": 8.0, "grid_points_per_s": 100.0},
        {"devices": 2, "wall_s": 4.4, "grid_points_per_s": 181.8},
        {"devices": 4, "wall_s": 2.5, "grid_points_per_s": 320.0},
    ]
    out = add_efficiency(results)
    assert "scaling_efficiency" not in out[0]
    np.testing.assert_allclose(out[1]["scaling_efficiency"], 0.909)
    np.testing.assert_allclose(out[2]["scaling_efficiency"], 0.8)


def test_run_scaling_over_one_and_two_ranks():
    rs = run_scaling("pangu", [1, 2], 1, tiny=True, device="cpu")
    assert [r["devices"] for r in rs] == [1, 2] and [r["mode"] for r in rs] == ["local", "manual"]
    assert all(r["time_sliced"] for r in rs) and rs[0]["grid_points_per_s"] > 0
    assert 0 < rs[1]["scaling_efficiency"]


def test_projection_algebra():
    p = CA.project_efficiency(0.16, 0, 4, link_bw=4.5e10)
    assert p["projected_efficiency"] == 1.0 and p["binding_term"] == "compute"
    p = CA.project_efficiency(0.16, int(0.08 * 4.5e10), 4, link_bw=4.5e10)
    assert p["projected_efficiency"] == pytest.approx(1 / 3, abs=0.01) and p["binding_term"] == "ici"
    p8 = CA.project_efficiency(0.16, 10**6, 8, spatial_split=4)
    p4 = CA.project_efficiency(0.16, 10**6, 4, spatial_split=4)
    assert p8["projected_efficiency"] == p4["projected_efficiency"] and p8["t_comp_s"] == pytest.approx(0.04)
    assert p8["link_bw"] == CA.H100_NVLINK_BW == 450e9


def test_summary_dcn_and_multihost_match_jax():
    pytest.importorskip("jax")
    from skyrim_tpu.parallel import collective_analysis as JCA

    colls = [{"kind": "collective-permute", "bytes": 1000, "ici_bytes": 2000, "group_size": 8, "op_name": ""},
             {"kind": "all-gather", "bytes": 800, "ici_bytes": 700, "group_size": 8, "op_name": ""},
             {"kind": "all-reduce", "bytes": 640, "ici_bytes": 1120, "group_size": 8, "op_name": ""}]
    assert CA.summarize(colls) == JCA.summarize(colls)
    for n, c in ((8, 4), (4, 4), (8, 2)):
        assert CA.dcn_egress_per_host(colls, n, c) == JCA.dcn_egress_per_host(colls, n, c)
    kw = dict(t_step_1chip_s=0.2, ici_bytes_N=10**8, dcn_bytes_per_host=5e7, n_devices=8, chips_per_host=4,
              ici_bytes_C=8 * 10**7, link_bw=4.5e10, dcn_bw=2.5e10)
    want = JCA.project_multihost(**kw)
    got = CA.project_multihost(0.2, 10**8, 5e7, 8, 4, 8 * 10**7, link_bw=4.5e10, dcn_bw=2.5e10)
    assert got["projected_efficiency_1_to_H_hosts"] == want["projected_efficiency_1_to_H_hosts"]
    assert got["binding_term"] == want["binding_term"] and got["t_dcn_s"] == want["t_dcn_s"]


@pytest.fixture(scope="module")
def tooling(tmp_path_factory):
    """The ``tooling`` program's results on 2 ranks, the inputs it was given,
    and the SFNO pair of tests/test_torch_finetune.py."""
    pytest.importorskip("jax")
    from test_torch_finetune import SFNO_CFG, _sfno

    jm, tree, _ = _sfno()
    rng = np.random.default_rng(5)
    shape = (B, 1, SFNO_CFG["in_channels"], SFNO_CFG["lat"], SFNO_CFG["lon"])
    batches = [(rng.normal(size=shape).astype(np.float32), rng.normal(size=shape).astype(np.float32))
               for _ in range(2)]
    inputs = {"tree": tree, "sfno_cfg": SFNO_CFG, "batches": batches,
              "train_cfg": dict(batch_size=B, learning_rate=LR, weight_decay=WD)}
    workdir = tmp_path_factory.mktemp("tooling")
    torch.save(inputs, workdir / "inputs.pt")
    return torch_ranks.launch("tooling", 2, workdir), inputs, jm


@pytest.mark.parametrize("depths", [(2, 2, 2, 2), (1, 1, 1, 1)])
def test_counted_halo_bytes_equal_the_reckoned(tooling, depths):
    ranks, _, _ = tooling
    for r in ranks:
        rec = r[("collectives", depths)]
        assert rec["mode"] == "manual" and set(rec["collectives"]["by_kind"]) == {"collective-permute"}
        assert rec["collectives"]["total_payload_bytes"] == r[("reckoned", depths)] > 0
        assert rec["collectives"]["total_ici_bytes"] == rec["collectives"]["total_payload_bytes"]  # one hop
        assert 0 < rec["projection"]["projected_efficiency"] <= 1


def test_counted_bytes_equal_jax_analyze_model(tooling, monkeypatch):
    import jax

    from skyrim_tpu.models.pangu import PanguConfig as JConfig
    from skyrim_tpu.models.pangu import PanguModel as JModel
    from skyrim_tpu.parallel.collective_analysis import analyze_model
    from skyrim_tpu.parallel.mesh import make_mesh

    if len(jax.devices()) < 2:
        pytest.skip("JAX has one device here; tests/conftest.py gives it eight")
    monkeypatch.setenv("SKYRIM_FORCE_PALLAS", "1")
    model = JModel("pangu6", cfg=JConfig(lat=49, lon=96, embed_dim=16, depths=(1, 1, 1, 1), num_heads=(2, 2, 2, 2)))
    rec = analyze_model(model, make_mesh(dp=1, lat=1, lon=2, devices=np.asarray(jax.devices()[:2])), 0.05)
    assert rec["mode"] == "manual"
    want = rec["collectives"]["by_kind"]["collective-permute"]["ici_bytes"]
    for r in tooling[0]:
        assert r[("collectives", (1, 1, 1, 1))]["collectives"]["by_kind"]["collective-permute"]["bytes"] == want


def _jax_two_steps(jm, tree, batches):
    import jax
    import jax.numpy as jnp
    import optax
    from skyrim_tpu.finetune import TrainConfig as JTC
    from skyrim_tpu.finetune import Trainer as JTrainer

    from skyrim_tpu_torch.params import flatten

    jm.compute_dtype = jnp.float32
    jt = JTrainer(jm, jax.tree.map(jnp.asarray, tree), JTC(batch_size=B, learning_rate=LR, weight_decay=WD))
    losses, norms = [], []
    for xs, ys in batches:
        def loss_fn(p):
            return jnp.mean(jax.vmap(lambda x, y: jnp.mean((jm.apply(p, x) - y) ** 2))(xs, ys))

        norms.append(float(optax.global_norm(jax.grad(loss_fn)(jt.params))))
        jt.params, jt.opt_state, loss = jt._step_fn(jt.params, jt.opt_state, xs, ys)
        losses.append(float(loss))
    return losses, norms, {k: np.asarray(v, np.float32) for k, v in flatten(jax.tree.map(lambda a: a, jt.params)).items()}


@pytest.mark.parametrize("sizes", [(2, 1, 1), (1, 1, 2)])
def test_mesh_trainer_matches_jax_and_one_process(tooling, sizes):
    from skyrim_tpu_torch.finetune import TrainConfig, Trainer
    from skyrim_tpu_torch.models.sfno import FourCastNetV2Model, SFNOConfig
    from skyrim_tpu_torch.params import flatten, from_jax

    ranks, inputs, jm = tooling
    got = [r[("trainer", sizes)] for r in ranks]
    for k in got[0]["leaves"]:  # every rank ends the step with the same bits
        np.testing.assert_array_equal(got[0]["leaves"][k], got[1]["leaves"][k])
    assert got[0]["losses"] == got[1]["losses"] and got[0]["norms"] == got[1]["norms"]

    jlosses, jnorms, jleaves = _jax_two_steps(jm, inputs["tree"], inputs["batches"])
    np.testing.assert_allclose(got[0]["losses"], jlosses, rtol=1e-3)
    np.testing.assert_allclose(got[0]["norms"], jnorms, rtol=1e-4)
    init = {k: np.asarray(v, np.float32) for k, v in flatten(inputs["tree"]).items()}
    assert set(got[0]["leaves"]) == set(jleaves) == set(init)
    for k, v in got[0]["leaves"].items():
        np.testing.assert_allclose(v, jleaves[k], atol=3e-5, rtol=1e-3, err_msg=k)
    assert sum(not np.array_equal(v, init[k]) for k, v in got[0]["leaves"].items()) > 0.9 * len(init)
    model = FourCastNetV2Model(SFNOConfig(**inputs["sfno_cfg"]), device="cpu")
    model.compute_dtype = torch.float32
    tr = Trainer(model, from_jax(inputs["tree"], model), TrainConfig(**inputs["train_cfg"]))
    losses = [float(tr.train_step(xs, ys)) for xs, ys in inputs["batches"]]
    np.testing.assert_allclose(got[0]["losses"], losses, rtol=1e-6)
    for k, p in tr.leaves.items():
        np.testing.assert_allclose(got[0]["leaves"][k], p.detach().numpy(), atol=1e-6, rtol=0, err_msg=k)
