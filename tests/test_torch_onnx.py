"""The port's weight readers against the JAX package's: the ONNX protobuf
reader (weights/onnx_io.py), the exporter-name rename pass
(weights/onnx_rename.py), the ONNX branches of weights/convert.py and the
Haiku GraphCast converter.

Every artifact is synthetic: the same bytes (built by the JAX package's
``build_onnx`` and wire helpers, which the port's ``build_onnx`` must
reproduce byte for byte) go through both readers, and the traced FuXi and
FengWu graphs are tests/test_onnx_rename.py's.  Every comparison is bit
for bit: arrays, dtypes and shapes, renamed state dicts, converted trees
leaf for leaf.  JAX is imported inside the tests: the card's machine has
no JAX.
"""

import dataclasses
import struct

import numpy as np
import pytest
import torch

from skyrim_tpu_torch.weights import convert, onnx_io, onnx_rename
from test_torch_fuxi import _assert_converted_equal
from test_torch_sfno import _assert_trees_equal

jax = pytest.importorskip("jax")  # the card's machine has no JAX

from skyrim_tpu.weights import convert as jconvert  # noqa: E402
from skyrim_tpu.weights import onnx_io as jio  # noqa: E402
from skyrim_tpu.weights import onnx_rename as jrename  # noqa: E402


def _model(body: bytes) -> bytes:
    return jio._len_field(7, jio._len_field(5, body))


def _tensors():
    rng = np.random.default_rng(0)
    return {
        "w_f32": rng.normal(size=(3, 4)).astype(np.float32),
        "w_f16": np.arange(6, dtype=np.float16).reshape(2, 3),
        "w_f64": rng.normal(size=(2, 2)),
        "w_i64": np.arange(5, dtype=np.int64) - 2,
        "w_i32": np.arange(4, dtype=np.int32) - 1,
        "w_i8": np.asarray([-3, 0, 7, 127], np.int8),
        "w_u8": np.arange(3, dtype=np.uint8),
        "w_bool": np.asarray([True, False]),
        "scalar": np.float32(3.25).reshape(()),
    }


def _bf16_raw():
    f32 = np.asarray([1.5, -2.0, 0.15625], np.float32)
    body = jio._tag(1, 0) + jio._varint(3) + jio._tag(2, 0) + jio._varint(16)
    body += jio._len_field(8, b"w") + jio._len_field(9, (f32.view(np.uint32) >> 16).astype(np.uint16).tobytes())
    return _model(body)


def _float_data():
    vals = [1.0, 2.5, -3.0, 4.0]
    body = (jio._tag(1, 0) + jio._varint(2)) * 2 + jio._tag(2, 0) + jio._varint(1)
    body += jio._len_field(8, b"w") + jio._len_field(4, struct.pack("<4f", *vals))
    return _model(body)


def _int32_data(dtype_code, vals, name):
    packed = b"".join(jio._varint(v) for v in vals)
    body = jio._tag(1, 0) + jio._varint(len(vals)) + jio._tag(2, 0) + jio._varint(dtype_code)
    return _model(body + jio._len_field(5, packed) + jio._len_field(8, name))


def _double_data():
    vals = np.asarray([0.5, -1.25], np.float64)
    body = jio._tag(1, 0) + jio._varint(2) + jio._tag(2, 0) + jio._varint(11)
    return _model(body + jio._len_field(10, vals.tobytes()) + jio._len_field(8, b"d"))


def _constant_node():
    attr = jio._len_field(1, b"value") + jio._len_field(5, jio._tensor_proto("", np.asarray([7.0, 8.0], np.float32)))
    node = jio._len_field(2, b"const_out") + jio._len_field(4, b"Constant") + jio._len_field(5, attr)
    init = jio._tensor_proto("w", np.zeros((2,), np.float32))
    return jio._len_field(7, jio._len_field(1, node) + jio._len_field(5, init))


def _topology():
    rng = np.random.default_rng(1)
    tensors = {"onnx::MatMul_1": rng.normal(size=(4, 8)).astype(np.float32), "1002": np.ones(8, np.float32)}
    nodes = [("MatMul", ["input", "onnx::MatMul_1"], ["t1"]), ("Add", ["t1", "1002"], ["t2"])]
    return jio.build_onnx(tensors, nodes=nodes, graph_inputs=("input",), graph_outputs=("t2",))


ARTIFACTS = {
    "dtypes": lambda: jio.build_onnx(_tensors()),
    "bf16 raw_data": _bf16_raw,
    "float_data": _float_data,
    "int32_data fp16": lambda: _int32_data(
        10, [int(b) for b in np.asarray([1.5, -2.0, 0.25, 8.0], np.float16).view(np.uint16)], b"w"),
    "int32_data int8": lambda: _int32_data(3, [v & 0xFFFFFFFF for v in (-3, 0, 7, 127)], b"q"),
    # proto3 sign-extends a negative int32 to 64 bits on the wire
    "int32_data negative": lambda: _int32_data(6, [v & 0xFFFFFFFFFFFFFFFF for v in (-1, -2**31, 5)], b"n"),
    "double_data": _double_data,
    "constant node": _constant_node,
    "topology": _topology,
}


def _assert_arrays_equal(out: dict, ref: dict):
    assert list(out) == list(ref)
    for k in ref:
        a, b = out[k], ref[k]
        assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("case", list(ARTIFACTS))
def test_readers_equal_jax(case):
    """read_onnx_initializers_from_bytes (with and without Constant nodes)
    and read_onnx_graph_from_bytes give JAX's arrays bit for bit."""
    data = ARTIFACTS[case]()
    for constants in (True, False):
        _assert_arrays_equal(onnx_io.read_onnx_initializers_from_bytes(data, include_constants=constants),
                             jio.read_onnx_initializers_from_bytes(data, include_constants=constants))
    out, ref = onnx_io.read_onnx_graph_from_bytes(data), jio.read_onnx_graph_from_bytes(data)
    assert out["nodes"] == ref["nodes"] and out["inputs"] == ref["inputs"] and out["outputs"] == ref["outputs"]
    _assert_arrays_equal(out["initializers"], ref["initializers"])


def test_build_onnx_bytes_equal_jax():
    tensors = _tensors()
    nodes = [("MatMul", ["input", "w_f32"], ["t1"]), ("Add", ["t1", "w_f16"], ["t2"])]
    assert onnx_io.build_onnx(tensors) == jio.build_onnx(tensors)
    assert onnx_io.build_onnx(tensors, nodes, ("input",), ("t2",)) == jio.build_onnx(tensors, nodes, ("input",), ("t2",))


def test_files_and_external_data_equal_jax(tmp_path):
    """read_onnx_initializers and read_onnx_graph on a file whose tensor
    lives in an external data file beside it; a file that is not ONNX
    raises in both."""
    arr = np.random.default_rng(1).normal(size=(4, 5)).astype(np.float32)
    (tmp_path / "weights.bin").write_bytes(b"\x00" * 16 + arr.tobytes())

    def entry(k, v):
        return jio._len_field(13, jio._len_field(1, k.encode()) + jio._len_field(2, v.encode()))

    body = b"".join(jio._tag(1, 0) + jio._varint(d) for d in arr.shape) + jio._tag(2, 0) + jio._varint(1)
    body += jio._len_field(8, b"big") + entry("location", "weights.bin") + entry("offset", "16")
    body += entry("length", str(arr.nbytes)) + jio._tag(14, 0) + jio._varint(1)
    path = tmp_path / "model.onnx"
    path.write_bytes(_model(body))
    _assert_arrays_equal(onnx_io.read_onnx_initializers(path), jio.read_onnx_initializers(path))
    np.testing.assert_array_equal(onnx_io.read_onnx_initializers(path)["big"], arr)
    _assert_arrays_equal(onnx_io.read_onnx_graph(path)["initializers"], jio.read_onnx_graph(path)["initializers"])
    with pytest.raises(ValueError, match="no base dir"):
        onnx_io.read_onnx_initializers_from_bytes(_model(body))
    junk = tmp_path / "junk.onnx"
    junk.write_bytes(b"\x0a\x04none")
    for reader in (onnx_io.read_onnx_initializers, jio.read_onnx_initializers):
        with pytest.raises(ValueError):
            reader(junk)


def test_malformed_refused_as_jax():
    body = jio._tag(1, 0) + jio._varint(3) + jio._tag(2, 0) + jio._varint(1) + jio._len_field(8, b"broken")
    for reader in (onnx_io.read_onnx_initializers_from_bytes, jio.read_onnx_initializers_from_bytes):
        with pytest.raises(ValueError, match="no recognized data field"):
            reader(_model(body))
    with pytest.raises(ValueError, match="non-negative"):
        onnx_io._varint(-1)


# --- the rename pass -----------------------------------------------------------


def _port_fuxi(jmodel):
    from skyrim_tpu_torch.models.fuxi import FuXiConfig, FuXiModel

    return FuXiModel(FuXiConfig(**dataclasses.asdict(jmodel.cfg)), device="cpu")


def _port_fengwu_cfg(jcfg):
    from skyrim_tpu_torch.models.fengwu import FengWuConfig

    return FengWuConfig(**dataclasses.asdict(jcfg))


@pytest.mark.parametrize("conv_updown", [False, True], ids=["gemm down/up", "conv down/up"])
def test_fuxi_rename_equals_jax(conv_updown):
    """A traced FuXi stage (stage 1) renames to JAX's state dict bit for
    bit, the strided-conv variant through the fallback program."""
    from test_onnx_rename import _fuxi_case, _fuxi_trace

    jmodel, sd, _ = _fuxi_case()
    cfg = jmodel.cfg
    if conv_updown:
        rng = np.random.default_rng(7)
        sd = dict(sd)
        sd["stages.1.down.weight"] = rng.normal(size=(cfg.embed_dim, cfg.cube_dim, 2, 2)).astype(np.float32)
        sd["stages.1.up.weight"] = rng.normal(size=(cfg.embed_dim, cfg.cube_dim, 2, 2)).astype(np.float32)
    graph = _fuxi_trace(sd, cfg, "stages.1", conv_updown=conv_updown)
    pcfg = _port_fuxi(jmodel).cfg
    out = onnx_rename.rename_fuxi_graph(graph, pcfg, stage=1, n_history=2)
    _assert_arrays_equal(out, jrename.rename_fuxi_graph(graph, cfg, stage=1, n_history=2))
    roles = onnx_rename.fuxi_stage_program(pcfg, 2, "stages.1", conv_updown)
    assert [dataclasses.astuple(r) for r in roles] == \
        [dataclasses.astuple(r) for r in jrename.fuxi_stage_program(cfg, 2, "stages.1", conv_updown)]
    with pytest.raises(ValueError, match="not found in"):
        onnx_rename.rename_fuxi_graph(graph, dataclasses.replace(pcfg, depth=pcfg.depth + 2), stage=1)


def test_fengwu_rename_and_config_equal_jax():
    from test_onnx_rename import _fengwu_case, _fengwu_trace

    jmodel, jcfg, sd = _fengwu_case()
    graph = _fengwu_trace(sd, jcfg, 1 + jcfg.level_vars)
    cfg = _port_fengwu_cfg(jcfg)
    _assert_arrays_equal(onnx_rename.rename_fengwu_graph(graph, cfg), jrename.rename_fengwu_graph(graph, jcfg))
    assert [dataclasses.astuple(r) for r in onnx_rename.fengwu_program(cfg)] == \
        [dataclasses.astuple(r) for r in jrename.fengwu_program(jcfg)]
    derived = onnx_rename.fengwu_config_from_graph(graph, lat=49, lon=96)
    assert dataclasses.asdict(derived) == dataclasses.asdict(jrename.fengwu_config_from_graph(graph, lat=49, lon=96))
    assert dataclasses.asdict(derived) == dataclasses.asdict(jcfg)
    events, jevents = onnx_rename.ordered_param_events(graph), jrename.ordered_param_events(graph)
    assert [(e.name, e.op, e.pos) for e in events] == [(e.name, e.op, e.pos) for e in jevents]
    for names in (list(graph["initializers"]), list(sd), ["onnx::MatMul_1", "1007", "t3"], []):
        assert onnx_rename.looks_exporter_named(names) == jrename.looks_exporter_named(names)


# --- the converters' ONNX branches ---------------------------------------------


def _traced_fuxi_files(tmp_path, sd, cfg):
    """One traced ONNX file a stage, as tests/test_onnx_rename.py builds
    them."""
    from test_onnx_rename import _Trace, _trace_v2_block

    paths = []
    for s in range(cfg.n_stages):
        tr, p = _Trace(), f"stages.{s}"
        tr.op("Conv", sd[f"{p}.cube_embed.weight"], sd[f"{p}.cube_embed.bias"])
        tr.ln(sd[f"{p}.down_norm.weight"], sd[f"{p}.down_norm.bias"])
        tr.linear(sd[f"{p}.down.weight"])
        for i in range(cfg.depth):
            _trace_v2_block(tr, sd, f"{p}.blocks.{i}")
        tr.linear(sd[f"{p}.up.weight"])
        tr.ln(sd[f"{p}.up_norm.weight"], sd[f"{p}.up_norm.bias"])
        tr.linear(sd[f"{p}.fuse.weight"], sd[f"{p}.fuse.bias"])
        tr.op("ConvTranspose", sd[f"{p}.head.weight"], sd[f"{p}.head.bias"])
        path = tmp_path / f"fuxi_stage{s}.onnx"
        path.write_bytes(jio.build_onnx(tr.tensors, nodes=tr.nodes, graph_inputs=("input",)))
        paths.append(path)
    return paths


def test_fuxi_onnx_cascade_equals_jax(tmp_path):
    """convert_fuxi_onnx_cascade on three traced stage files gives JAX's
    tree leaf for leaf (bf16 stages); a wrong file count and a single
    traced FuXi file through convert_torch_file raise as in JAX."""
    from test_onnx_rename import _fuxi_case

    jmodel, sd, _ = _fuxi_case()
    model = _port_fuxi(jmodel)
    paths = _traced_fuxi_files(tmp_path, sd, jmodel.cfg)
    out = convert.convert_fuxi_onnx_cascade(model, paths)
    _assert_converted_equal(out, jax.tree.map(np.asarray, jconvert.convert_fuxi_onnx_cascade(jmodel, paths)))
    with pytest.raises(ValueError, match="needs 3 stage artifacts"):
        convert.convert_fuxi_onnx_cascade(model, paths[:1])
    with pytest.raises(ValueError, match="convert_fuxi_onnx_cascade"):
        convert.convert_torch_file(model, paths[0])


@pytest.mark.parametrize("name", ["pangu", "fuxi", "fengwu", "dlwp"])
def test_convert_torch_file_onnx_equals_jax(name, tmp_path):
    """A state-dict-named ONNX artifact (tests/test_weights_convert.py's
    synthetic cases) converts through convert_torch_file to JAX's tree."""
    import test_weights_convert as twc

    from skyrim_tpu_torch.models import MODELS

    if name == "dlwp":
        from test_torch_dlwp import SMALL, _jax_class

        jmodel = _jax_class()()
        rng = np.random.default_rng(0)
        sd = {}
        native = jmodel.init_params(jax.random.key(0))["net"]
        for i, blk in enumerate(k for k in native if k.startswith("CSConvBlock")):
            for j, conv in enumerate(("conv1", "conv2")):
                kh, kw, ci, co = native[blk][f"Conv_{j}"]["kernel"].shape
                sd[f"blocks.{i}.{conv}.weight"] = rng.normal(size=(co, ci, kh, kw)).astype(np.float32)
                sd[f"blocks.{i}.{conv}.bias"] = rng.normal(size=(co,)).astype(np.float32)
        kh, kw, ci, co = native["Conv_0"]["kernel"].shape
        sd["head.weight"] = rng.normal(size=(co, ci, kh, kw)).astype(np.float32)
        sd["head.bias"] = rng.normal(size=(co,)).astype(np.float32)
        model = MODELS["dlwp"](**SMALL, device="cpu")
    else:
        from skyrim_tpu_torch.models.fengwu import FengWuConfig
        from skyrim_tpu_torch.models.fuxi import FuXiConfig
        from skyrim_tpu_torch.models.pangu import PanguConfig

        jmodel, sd, _ = {"pangu": twc._make_pangu_case, "fuxi": twc._make_fuxi_case,
                         "fengwu": twc._make_fengwu_case}[name]()
        cfg = {"pangu": PanguConfig, "fuxi": FuXiConfig, "fengwu": FengWuConfig}[name](**dataclasses.asdict(jmodel.cfg))
        kw = {"variant": jmodel.variant} if name == "pangu" else {}
        model = MODELS[name](cfg=cfg, device="cpu", **kw)
    path = tmp_path / f"{name}.onnx"
    path.write_bytes(onnx_io.build_onnx({k: np.asarray(v) for k, v in sd.items()}))
    out = convert.convert_torch_file(model, path)
    ref = jax.tree.map(np.asarray, jconvert.convert_torch_file(jmodel, path))
    (_assert_converted_equal if name == "fuxi" else _assert_trees_equal)(out, ref)


def test_fengwu_artifact_onnx_equals_jax(tmp_path):
    """load_fengwu_from_artifact on the traced FengWu export and on a
    state-dict-named ONNX: the configuration and the tree equal JAX's."""
    from test_onnx_rename import _fengwu_case, _Trace, _trace_v1_block

    _, jcfg, sd = _fengwu_case()
    # tests/test_onnx_rename.py's _fengwu_trace, kept as bytes
    tr, groups, wlen = _Trace(), 1 + jcfg.level_vars, jcfg.window[0] * jcfg.window[1]
    for g in range(groups):
        tr.op("Conv", sd[f"encoders.{g}.weight"], sd[f"encoders.{g}.bias"])
    tr.linear(sd["fuse_in.weight"], sd["fuse_in.bias"])
    for i in range(jcfg.depth):
        _trace_v1_block(tr, sd, f"fuser.{i}", (1, 2, wlen, wlen))
    for g in range(groups):
        tr.op("ConvTranspose", sd[f"decoders.{g}.weight"], sd[f"decoders.{g}.bias"])
    traced, named = tmp_path / "fengwu.onnx", tmp_path / "named" / "fengwu.onnx"
    traced.write_bytes(jio.build_onnx(tr.tensors, nodes=tr.nodes, graph_inputs=("input",), graph_outputs=(tr.cur,)))
    named.parent.mkdir()
    named.write_bytes(jio.build_onnx({k: np.asarray(v) for k, v in sd.items()}))
    for path in (traced, named):
        model, tree = convert.load_fengwu_from_artifact(path, lat=49, lon=96, device="cpu")
        jmodel, jtree = jconvert.load_fengwu_from_artifact(path, lat=49, lon=96)
        assert dataclasses.asdict(model.cfg) == dataclasses.asdict(jmodel.cfg) == dataclasses.asdict(jcfg)
        assert model.device.type == "cpu"
        _assert_trees_equal(tree, jax.tree.map(np.asarray, jtree))


# --- GraphCast's Haiku parameters ---------------------------------------------------


def _haiku_case(nested: bool):
    """tests/test_weights_convert.py's official haiku module paths
    (deep_typed_graph_net ``~_networks_builder`` naming) with (in, out)
    w/b/scale/offset leaves, flat ('/'-joined, the npz form) or nested."""
    from skyrim_tpu.models.graphcast import GraphCastConfig as JConfig
    from skyrim_tpu.models.graphcast import GraphCastModel as JModel

    from skyrim_tpu_torch.models.graphcast import GraphCastConfig, GraphCastModel

    kw = dict(lat=19, lon=36, in_channels=4, latent=16, processor_rounds=2, mesh_refinements=2)
    jmodel, model = JModel(JConfig(**kw, edge_chunks=2)), GraphCastModel(GraphCastConfig(**kw), device="cpu")
    native = {k: v for k, v in jmodel.init_params(jax.random.key(0))["net"].items()}
    rng = np.random.default_rng(0)
    B = "~_networks_builder"
    paths = {
        ("embed_grid",): f"grid2mesh_gnn/{B}/encoder_nodes_grid_nodes_mlp",
        ("embed_mesh",): f"grid2mesh_gnn/{B}/encoder_nodes_mesh_nodes_mlp",
        ("g2m", "edge_embed"): f"grid2mesh_gnn/{B}/encoder_edges_grid2mesh_mlp",
        ("g2m", "message"): f"grid2mesh_gnn/{B}/processor_edges_0_grid2mesh_mlp",
        ("g2m", "MLP_0"): f"grid2mesh_gnn/{B}/processor_nodes_0_mesh_nodes_mlp",
        ("grid_update",): f"grid2mesh_gnn/{B}/processor_nodes_0_grid_nodes_mlp",
        ("embed_mm",): f"mesh_gnn/{B}/encoder_edges_mesh_mlp",
        ("round_0", "MLP_0"): f"mesh_gnn/{B}/processor_edges_0_mesh_mlp",
        ("round_0", "MLP_1"): f"mesh_gnn/{B}/processor_nodes_0_mesh_nodes_mlp",
        ("round_1", "MLP_0"): f"mesh_gnn/{B}/processor_edges_1_mesh_mlp",
        ("round_1", "MLP_1"): f"mesh_gnn/{B}/processor_nodes_1_mesh_nodes_mlp",
        ("m2g", "edge_embed"): f"mesh2grid_gnn/{B}/encoder_edges_mesh2grid_mlp",
        ("m2g", "message"): f"mesh2grid_gnn/{B}/processor_edges_0_mesh2grid_mlp",
        ("m2g", "MLP_0"): f"mesh2grid_gnn/{B}/processor_nodes_0_grid_nodes_mlp",
        ("head",): f"mesh2grid_gnn/{B}/decoder_nodes_grid_nodes_mlp",
    }
    hk = {}
    for slot, path in paths.items():
        node = native
        for part in slot:
            node = node[part]
        leaves = {}
        for dense, lin in (("Dense_0", "linear_0"), ("Dense_1", "linear_1")):
            kin, kout = node[dense]["kernel"].shape
            leaves[f"{lin}/w"] = rng.normal(size=(kin, kout)).astype(np.float32)
            if dense == "Dense_0" or not nested:  # a module without b takes a zero bias
                leaves[f"{lin}/b"] = rng.normal(size=(kout,)).astype(np.float32)
        if "LayerNorm_0" in node:
            d = node["LayerNorm_0"]["scale"].shape[0]
            leaves["layer_norm/scale"] = rng.normal(size=(d,)).astype(np.float32)
            leaves["layer_norm/offset"] = rng.normal(size=(d,)).astype(np.float32)
        if nested:
            for k, v in leaves.items():
                module, _, param = k.rpartition("/")
                hk.setdefault(f"{path}/~/{module}", {})[param] = v
        else:
            hk.update({f"{path}/~/{k}": v for k, v in leaves.items()})
    hk["means"], hk["stds"] = rng.normal(size=4).astype(np.float32), rng.uniform(1, 2, size=4).astype(np.float32)
    return jmodel, model, hk


@pytest.mark.parametrize("nested", [False, True], ids=["flat npz", "nested"])
def test_graphcast_haiku_equals_jax(nested):
    """convert_graphcast dispatches the Haiku layout to
    convert_graphcast_haiku; the tree equals JAX's leaf for leaf and loads
    through params.from_jax; a checkpoint lacking modules, and a module
    path that does not classify, raise as in JAX."""
    from skyrim_tpu_torch.params import from_jax

    jmodel, model, hk = _haiku_case(nested)
    out = convert.convert_graphcast(model, hk)
    ref = jax.tree.map(np.asarray, jconvert.convert_graphcast(jmodel, hk))
    _assert_trees_equal(out, ref)
    assert out["norm"]["mean"].shape == (4, 1, 1)
    assert from_jax(out, model)["net"].head.Dense_1.kernel.shape == (16, 4)
    with pytest.raises(ValueError, match="lacks modules"):
        convert.convert_graphcast_haiku(model, {k: v for k, v in hk.items() if "mesh2grid" not in k})
    with pytest.raises(ValueError, match="did not classify"):
        convert.convert_graphcast_haiku(model, {**hk, "grid2mesh_gnn/odd_module/w": np.zeros(2, np.float32)})
    assert torch.is_tensor(from_jax(out, model)["norm"]["std"])
