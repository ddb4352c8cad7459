"""The port's multi-device layer on gloo ranks: mesh, halo, ring, window block.

Each world (2 and 4 ranks, CPU processes of tests/torch_ranks.py on a
``file://`` rendezvous) is launched once per module and runs every case of
that world; the JAX references run here, on conftest's 8-device CPU mesh
(its first 4 devices for a 4-rank mesh).  Cases and tolerances follow the
JAX package's tests:

- ``make_mesh``'s wildcard and errors, the row-major layout, and
  ``compatible_spec`` equal to JAX's (tests/parallel/test_sharding.py:22);
- ``halo_pad`` on lat and lon (and each one-rank axis) bit for bit against
  JAX's ``halo_pad`` (:30, :50);
- ``ring_extend``, ``ring_roll`` and ``local_lon_slice`` bit for bit against
  a periodic pad and ``np.roll`` (tests/parallel/test_fused_shard.py:30-80);
- ``manual_swin_block`` at n 2 and 4 against the port's and JAX's
  ``reference_manual_swin_block``, f32, atol = rtol = 2e-4 (:116-150), on
  JAX's 24 lon tokens (each cover the whole ring) and on 72 (covers cut
  from the ring, as at Pangu's full width), and two planted faults (the
  halo from the wrong ring neighbour, the cover offset one token off),
  which that check must refuse.
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_ranks as R
from skyrim_tpu_torch.parallel.mesh import make_mesh, single_device_mesh
from skyrim_tpu_torch.parallel.sharding import compatible_spec

jax = pytest.importorskip("jax")  # the card's machine has no JAX


def _block_inputs():
    """Per (width, shift): x (Z, H, W, C) and the block's weights,
    numpy-seeded, f32 (as tests/parallel/test_fused_shard.py:_block_weights)."""
    g = R.BLOCK_GEOMETRY
    Z, H, C, heads = g["Z"], g["H"], g["C"], g["heads"]
    wlen = int(np.prod(g["window"]))
    n_types = (Z // g["window"][0]) * (H // g["window"][1])
    out = {}
    for i, (W, shift) in enumerate((W, s) for W in R.BLOCK_WIDTHS for s in R.BLOCK_SHIFTS):
        rng = np.random.default_rng(i)

        def normal(*shape, scale=1.0):
            return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

        mask = None
        if any(shift):
            m = np.zeros((1, 1, wlen, wlen), np.float32)
            m[..., : wlen // 3] = -1e9
            mask = torch.from_numpy(m)
        out[W, shift] = dict(
            x=normal(Z, H, W, C),
            ln1=(torch.ones(C), torch.zeros(C)),
            qkv=(normal(C, 3 * C, scale=0.2), torch.zeros(3 * C)),
            bias=normal(n_types, heads, wlen, wlen, scale=0.05),
            mask=mask,
            proj=(normal(C, C, scale=0.2), torch.zeros(C)),
            ln2=(torch.ones(C) * 1.1, torch.zeros(C) + 0.05),
            mlp=(normal(C, 2 * C, scale=0.2), torch.zeros(2 * C), normal(2 * C, C, scale=0.2), torch.zeros(C)),
        )
    return out


def _run(tmp_path_factory, world):
    d = tmp_path_factory.mktemp(f"parallel{world}")
    torch.save({"blocks": _block_inputs()}, d / "inputs.pt")
    return R.launch("parallel", world, d)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _run(tmp_path_factory, 2)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _run(tmp_path_factory, 4)


def _jax_mesh(sizes):
    """JAX's mesh of ``sizes`` over conftest's first 4 CPU devices."""
    from skyrim_tpu.parallel.mesh import make_mesh as j_make_mesh

    return j_make_mesh(*sizes, devices=jax.devices()[:4])


# --- mesh --------------------------------------------------------------------------


def test_make_mesh_wildcard_and_errors(world4):
    from skyrim_tpu.parallel.mesh import make_mesh as j_make_mesh

    out = world4[0]
    assert out["wildcard"] == {"dp": 2, "lat": 2, "lon": 1} == dict(_jax_mesh((2, -1, 1)).shape)
    for sizes in ((3, 1, 1), (-1, -1, 1), (2, 3, -1)):
        with pytest.raises(ValueError) as ref:
            j_make_mesh(*sizes, devices=jax.devices()[:4])
        assert out[("mesh_error", sizes)] == str(ref.value)


def test_one_rank_mesh():
    """Without a process group the world is this process: a 1×1×1 mesh, no
    group on any axis; anything larger is refused as JAX refuses it."""
    for mesh in (make_mesh(device="cpu"), single_device_mesh("cpu")):
        assert mesh.shape == {"dp": 1, "lat": 1, "lon": 1} and mesh.size == 1 and mesh.backend is None
        assert all(g is None for g in mesh.groups.values()) and mesh.device.type == "cpu"
    with pytest.raises(ValueError, match=r"does not cover 1 devices"):
        make_mesh(2, 1, 1, device="cpu")


def test_mesh_layout_is_jax_row_major(world4):
    """Rank r sits where JAX's (2, 1, 2) mesh puts device r; each axis group
    holds the ranks of its line in axis order."""
    devices = np.vectorize(lambda d: d.id)(_jax_mesh((2, 1, 2)).devices)
    for r, out in enumerate(world4):
        assert tuple(out["coords"].values()) == tuple(int(i) for i in np.argwhere(devices == r)[0])
        for axis in ("dp", "lat", "lon"):
            idx = [out["coords"][a] if a != axis else slice(None) for a in ("dp", "lat", "lon")]
            assert out["members"][axis] == [int(i) for i in devices[tuple(idx)]]


@pytest.mark.parametrize("base", R.SPEC_BASES, ids=lambda b: "-".join(str(a) for a in b))
@pytest.mark.parametrize("shape", R.SPEC_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_compatible_spec_matches_jax(world4, shape, base):
    from jax.sharding import PartitionSpec as P

    from skyrim_tpu.parallel.sharding import compatible_spec as j_spec

    out = world4[0][("spec", shape, base)]
    assert out == tuple(j_spec(shape, _jax_mesh((2, 1, 2)), P(*base)))
    assert len(out) == len(shape)


def test_compatible_spec_on_one_rank():
    assert compatible_spec((2, 69, 49, 96), single_device_mesh("cpu"), (None, None, "lat", "lon")) == (
        None, None, "lat", "lon")


# --- halo ----------------------------------------------------------------------------


@pytest.mark.parametrize("case", R.HALO_CASES, ids=lambda c: f"mesh{''.join(map(str, c[0]))}-lat{c[1]}-lon{c[2]}")
def test_halo_pad_matches_jax(world4, case):
    from jax.sharding import NamedSharding, PartitionSpec as P

    from skyrim_tpu.parallel.halo import halo_pad as j_halo_pad

    sizes, hl, hw = case
    H, W = R.HALO_SHAPE
    jmesh = _jax_mesh(sizes)
    x = jax.device_put(np.arange(H * W, dtype=np.float32).reshape(H, W), NamedSharding(jmesh, P("lat", "lon")))
    ref = np.asarray(j_halo_pad(x, jmesh, halo_lat=hl, halo_lon=hw))
    for out in world4:  # every rank holds the gathered result
        np.testing.assert_array_equal(out[("halo", *case)].numpy(), ref)
    if hl and sizes[1] > 1:  # the pole edges are zero
        np.testing.assert_array_equal(ref[0], 0)


# --- ring ops --------------------------------------------------------------------------


@pytest.mark.parametrize("left,right", R.RING_EXTENTS)
def test_ring_extend_matches_periodic_pad(world4, left, right):
    n, Wl = 4, 6
    x = np.arange(n * Wl, dtype=np.float32)
    out = world4[0][("ring_extend", left, right)].numpy().reshape(n, -1)  # each rank's extended chunk
    for d in range(n):
        want = np.array([x[i % (n * Wl)] for i in range(d * Wl - left, (d + 1) * Wl + right)])
        np.testing.assert_array_equal(out[d], want)


@pytest.mark.parametrize("shift", R.RING_SHIFTS)
def test_ring_roll_matches_np_roll(world4, shift):
    x = np.arange(24, dtype=np.float32).reshape(1, 24)
    np.testing.assert_array_equal(world4[0][("ring_roll", shift)].numpy(), np.roll(x, shift, axis=1))


def test_local_lon_slice(world4):
    g = np.arange(3 * 24, dtype=np.float32).reshape(3, 24)
    np.testing.assert_array_equal(world4[0]["local_lon_slice"].numpy(), g)


# --- the sharded window block ------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_blocks():
    """JAX's reference_manual_swin_block on every (width, shift)'s inputs."""
    import jax.numpy as jnp

    from skyrim_tpu.parallel import fused_shard as j_FS

    g = R.BLOCK_GEOMETRY
    refs = {}
    for (W, shift), w in _block_inputs().items():
        j = {k: v if v is None else jax.tree.map(lambda t: jnp.asarray(t.numpy()), v) for k, v in w.items()}
        refs[W, shift] = np.asarray(j_FS.reference_manual_swin_block(
            j["x"], j["ln1"], j["qkv"], j["bias"], j["mask"], j["proj"], j["ln2"], j["mlp"], g["window"], g["heads"],
            shift))
    return refs


@pytest.mark.parametrize("shift", R.BLOCK_SHIFTS, ids=lambda s: "shift" + "".join(map(str, s)))
@pytest.mark.parametrize("W", R.BLOCK_WIDTHS, ids=lambda w: f"W{w}")
@pytest.mark.parametrize("n", (2, 4))
def test_manual_swin_block_matches_references(world2, world4, jax_blocks, n, W, shift):
    ranks = world2 if n == 2 else world4
    out = ranks[0][("block", n, W, shift)].numpy()
    assert all(np.array_equal(r[("block", n, W, shift)].numpy(), out) for r in ranks)
    np.testing.assert_allclose(out, ranks[0][("block_ref", n, W, shift)].numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(out, jax_blocks[W, shift], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("fault", R.FAULTS)
@pytest.mark.parametrize("W", R.BLOCK_WIDTHS, ids=lambda w: f"W{w}")
def test_planted_faults_are_refused(world4, W, fault):
    """The check above must refuse a block whose halo came from the other
    side of the ring, or whose cover sits one token off."""
    out, ref = world4[0][("fault", W, fault)].numpy(), world4[0][("block_ref", 4, W, (1, 3, 6))].numpy()
    err = np.abs(out - ref) / (2e-4 + 2e-4 * np.abs(ref))
    assert err.max() > 10, f"{fault}: {err.max():.3g}x the limit"


def test_pad_to_windows_keeps_lon_inside_a_region():
    """Inside a lon-manual region only z and lat are padded: the local lon
    chunk of a periodic axis is never padded (JAX ops/windows.py:27-46)."""
    from skyrim_tpu_torch.ops.windows import pad_to_windows
    from skyrim_tpu_torch.parallel import fused_shard as FS

    x = torch.randn(7, 13, 18, 4)  # 18 lon tokens: a chunk that cuts a 12-token window
    assert pad_to_windows(x, (2, 6, 12))[0].shape == (8, 18, 24, 4)
    two = dataclasses.replace(single_device_mesh("cpu"), shape={"dp": 1, "lat": 1, "lon": 2})  # no exchange here
    with FS.lon_manual(two):
        xp, pads = pad_to_windows(x, (2, 6, 12))
    assert xp.shape == (8, 18, 18, 4) and pads == (1, 5, 0)
    torch.testing.assert_close(xp[:7, :13], x, rtol=0, atol=0)
