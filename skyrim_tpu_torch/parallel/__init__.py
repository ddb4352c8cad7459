"""The multi-device layer (port of skyrim_tpu/parallel/): a (dp, lat, lon)
mesh over torch.distributed ranks (``mesh``), halo exchange (``halo``),
the lon-sharded window blocks (``fused_shard``), sharded steps, rollouts
and dp ensembles (``sharding``), and one rank of a global mesh
(``mp_worker``)."""

from skyrim_tpu_torch.parallel.mesh import Mesh, MeshAxes, make_mesh  # noqa: F401
