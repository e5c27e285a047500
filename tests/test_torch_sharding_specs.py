"""The model half of the port's sharding rules against the JAX package's:
``param_specs``, ``cache_specs``, ``batch_spec``, ``stacked_specs`` and the
serving variant, at full width on the production layouts (16 x 16 and
2 x 16 x 16).  Shapes come from ``jax.eval_shape`` and ``FakeTensorMode``:
no weight is materialised.  The specs are compared exactly, entry by
entry, after the reference's ``PartitionSpec`` is read as a tuple (a
one-name tuple entry read as the name, trailing entries padded with
None)."""
import dataclasses

import jax
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as jax_config
from repro.dist import sharding as jshard
from repro.launch import mesh as jmesh
from repro.launch.steps import _serve_variant as jax_serve_variant
from repro.models import get_model as jax_model
from repro_torch.configs import INPUT_SHAPES, dryrun_pairs, get_config, \
    get_shape, list_archs
from repro_torch.dist import sharding as tshard
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.steps import _serve_variant
from repro_torch.models import get_model
from repro_torch.tree import tree_map

MESHES = {"single": False, "multi": True}


def _norm(entry):
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        return entry[0] if len(entry) == 1 else entry
    return entry


def _spec(spec, ndim):
    e = [_norm(x) for x in spec]
    return tuple(e + [None] * (ndim - len(e)))


def _flat(tree, pre=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, pre + (str(k),)))
        return out
    return {pre: tree}


def _jax_flat(tree, is_leaf=None):
    leaves = jax.tree_util.tree_leaves_with_path(tree, is_leaf=is_leaf)
    return {tuple(str(k.key) for k in path): x for path, x in leaves}


def _is_jspec(x):
    return isinstance(x, jax.sharding.PartitionSpec)


@pytest.fixture(scope="module")
def trees():
    """{arch: (reference params (ShapeDtypeStructs), the port's params
    (fake tensors))} for every arch at full width."""
    mode = FakeTensorMode()
    out = {}
    for arch in list_archs():
        jm = jax_model(jax_config(arch))
        jp = jax.eval_shape(lambda: jm.init_params(jax.random.PRNGKey(0)))
        with mode:
            tp = get_model(get_config(arch)).init_params(
                torch.Generator().manual_seed(0))
        out[arch] = (jp, tp)
    return out


def _like_reference(jp):
    """Fake tensors of the reference's shapes (the CNN's conv weights are
    HWIO there, OIHW in the port: the rules are positional)."""
    with FakeTensorMode():
        return tree_map(lambda x: torch.empty(x.shape),
                        jax.tree_util.tree_map(lambda x: x, jp))


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_equal_the_references(trees, arch, mesh, fsdp):
    jp, tp = trees[arch]
    if arch == "cifar-cnn":
        tp = _like_reference(jp)
    mp = MESHES[mesh]
    want = _jax_flat(jshard.param_specs(
        jp, jmesh.production_spec_mesh(multi_pod=mp), fsdp=fsdp),
        is_leaf=_is_jspec)
    got = _flat(tshard.param_specs(
        tp, tmesh.production_spec_mesh(multi_pod=mp), fsdp=fsdp))
    shapes = _flat(tree_map(lambda x: tuple(x.shape), tp))
    assert set(want) == set(got)
    for path, spec in want.items():
        nd = len(shapes[path])
        assert _spec(got[path], nd) == _spec(spec, nd), path


def test_the_cnn_keeps_the_references_leaves(trees):
    """The port's CNN differs from the reference only in its conv
    layout (OIHW for HWIO), which its specs follow."""
    jp, tp = trees["cifar-cnn"]
    a = _flat(tree_map(lambda x: tuple(x.shape), tp))
    b = _jax_flat(jax.tree_util.tree_map(lambda x: tuple(x.shape), jp),
                  is_leaf=lambda x: isinstance(x, tuple))
    assert set(a) == set(b)
    for path, shape in b.items():
        if path[-1] == "w" and len(shape) == 4:
            shape = (shape[3], shape[2], shape[0], shape[1])
        assert a[path] == shape, path


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", [a for a in list_archs()
                                  if a != "cifar-cnn"])
def test_cache_specs_equal_the_references_at_decode_32k(arch, mesh):
    shape = get_shape("decode_32k")
    jm = jax_model(jax_config(arch))
    var = _serve_variant(get_config(arch), shape)
    cl = var["cache_len"] or shape.seq_len
    jc = jax.eval_shape(lambda: jm.init_cache(shape.global_batch, cl))
    with FakeTensorMode():
        tc = get_model(get_config(arch)).init_cache(shape.global_batch, cl,
                                                    device="cpu")
    mp = MESHES[mesh]
    want = _jax_flat(jshard.cache_specs(
        jc, jmesh.production_spec_mesh(multi_pod=mp)), is_leaf=_is_jspec)
    got = _flat(tshard.cache_specs(
        tc, tmesh.production_spec_mesh(multi_pod=mp)))
    shapes = _flat(tree_map(lambda x: tuple(x.shape), tc))
    assert set(want) == set(got)
    for path, spec in want.items():
        nd = len(shapes[path])
        assert _spec(got[path], nd) == _spec(spec, nd), path


def test_batch_spec_equals_the_references_over_a_grid():
    meshes = [(jmesh.production_spec_mesh(multi_pod=mp),
               tmesh.production_spec_mesh(multi_pod=mp)) for mp in MESHES.values()]
    meshes.append((jmesh.SpecMesh({"data": 1, "model": 1}),
                   tmesh.card_spec_mesh()))
    meshes.append((jmesh.SpecMesh({"pod": 4, "data": 8, "model": 2}),
                   tmesh.SpecMesh({"pod": 4, "data": 8, "model": 2})))
    n = 0
    for jm, tm in meshes:
        for ndim in (1, 2, 3, 5):
            for bdim in range(-1, ndim + 1):
                for size in (0, 1, 2, 3, 8, 16, 24, 32, 48, 64, 128, 256,
                             512, 768):
                    want = jshard.batch_spec(jm, ndim, bdim, size)
                    got = tshard.batch_spec(tm, ndim, bdim, size)
                    assert _spec(got, ndim) == _spec(want, ndim), \
                        (tm, ndim, bdim, size)
                    n += 1
    assert n > 1000


def _oracle(tree, mesh, model_axis, zero_axis):
    """The reference's ``stacked_constrainer`` rule, spec by spec: the data
    axes on the client dim, the reference's ``_param_spec`` of the leaf's
    trailing dims, and ZeRO-1's last free dim that ``zero_axis``
    divides."""
    daxes = jshard.data_axes(mesh)
    lead = daxes if len(daxes) > 1 else daxes[0]

    def leaf(path, x):
        if x.dim() == 0:
            return ()
        spec = jshard._param_spec(path, tuple(x.shape)[1:], mesh,
                                  model_axis=model_axis)
        entries = [lead] + list(_spec(spec, x.dim() - 1))
        if zero_axis is not None:
            for dim in range(x.dim() - 1, 0, -1):
                if entries[dim] is None and x.shape[dim] > 1 \
                        and x.shape[dim] % mesh.shape[zero_axis] == 0:
                    entries[dim] = zero_axis
                    break
        return tuple(_norm(e) for e in entries)

    return {p: leaf(p, x) for p, x in _flat(tree).items()}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ["granite-3-2b", "olmoe-1b-7b",
                                  "mamba2-1.3b", "recurrentgemma-2b"])
def test_stacked_specs_follow_the_reference_rule(trees, arch, mesh):
    """The specs the parallel round pins on its client-stacked params and
    Adam state (C = 16 leading), tp and dp (model axis idle), with and
    without ZeRO-1, against an oracle built from the reference's rule."""
    _, tp = trees[arch]
    mp = MESHES[mesh]
    jm, tm = (jmesh.production_spec_mesh(multi_pod=mp),
              tmesh.production_spec_mesh(multi_pod=mp))
    with FakeTensorMode():
        stacked = tree_map(lambda x: torch.empty((16,) + tuple(x.shape)), tp)
        state = {"m": stacked, "v": stacked, "t": torch.empty(())}
    for model_axis, zero in (("model", None), (None, None), (None, "model")):
        want = _oracle(state, jm, model_axis, zero)
        got = _flat(tshard.stacked_specs(state, tm, model_axis=model_axis,
                                         zero_axis=zero))
        assert set(want) == set(got)
        for path, spec in want.items():
            assert _spec(got[path], len(spec)) == spec, (path, model_axis,
                                                         zero)


def test_serve_variant_equals_the_references_for_every_pair():
    for arch, shape in dryrun_pairs():
        assert _serve_variant(get_config(arch), get_shape(shape)) == \
            jax_serve_variant(jax_config(arch), get_shape(shape)), \
            (arch, shape)


def test_specs_read_any_mesh_the_fleet_keeps_a_device_mesh():
    """The spec side reads a SpecMesh; the fleet side still needs a
    DeviceMesh, and anything that is neither is refused."""
    single = tmesh.production_spec_mesh()
    assert tshard.data_axes(single) == ("data",)
    assert tshard.data_axes(tmesh.production_spec_mesh(multi_pod=True)) == \
        ("pod", "data")
    assert tshard.mesh_axis_size(single, ("data", "model")) == 256
    assert tshard.fleet_spec(single, 2) == tshard.P("data", None)
    with pytest.raises(ValueError, match="DeviceMesh"):
        tshard.slab(32, single)
    with pytest.raises(ValueError, match="DeviceMesh"):
        tshard.data_axes(object())
    assert tmesh.PRODUCTION_TOPOLOGY == jmesh.PRODUCTION_TOPOLOGY
    assert tmesh.make_local_mesh() is None
    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        tmesh.make_production_mesh()


def test_input_shapes_are_the_references():
    from repro.configs.base import INPUT_SHAPES as J

    assert {k: dataclasses.astuple(v) for k, v in INPUT_SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in J.items()}
