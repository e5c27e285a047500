"""``repro_torch.checkpoint``'s codec and tree file against the JAX
package's: the port's own msgpack codec writes the bytes of
``msgpack.packb(..., use_bin_type=True)`` and reads what msgpack writes;
a checkpoint file written by either package loads in the other, with and
without ``like=``, for every dtype the runs store (bfloat16 and uint32
included); and the reference's file contract (``tests/test_checkpoint.py``)
holds on the port."""
import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import checkpoint as jck
from repro_torch import checkpoint as tck
from repro_torch.checkpoint import _msgpack
from repro_torch.checkpoint.ckpt import tree_flatten


def _raw(x) -> tuple:
    """(numpy dtype name, shape, raw bytes) of a leaf of either package."""
    if isinstance(x, torch.Tensor):
        t = x.contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return (str(x.dtype).removeprefix("torch."), tuple(x.shape),
                t.numpy().tobytes())
    a = np.asarray(x)
    return str(a.dtype), a.shape, a.tobytes()


def _same_leaves(a, b):
    la, lb = tree_flatten(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert _raw(x) == _raw(y)


# ------------------------------------------------------------- the codec ---

INT_EDGES = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
             2 ** 63 - 1, 2 ** 63, 2 ** 64 - 1, -1, -32, -33, -128, -129,
             -32768, -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63]
LENGTHS = [0, 31, 32, 255, 256, 65535, 65536]
COUNTS = [0, 15, 16, 65535, 65536]
NESTED = {"z": [1, {"b": (None, 2.5, "é", b"\x00\xff")}, [], {}],
          "a": {"y": [True, False, -1.0e300], "x": None}, "": ()}
CODEC_CASES = (
    [pytest.param(x, id=f"int{x}") for x in INT_EDGES]
    + [pytest.param("s" * n, id=f"str{n}") for n in LENGTHS]
    + [pytest.param("é" * (n // 2), id=f"str-utf8-{n}") for n in (32, 256)]
    + [pytest.param(b"\x07" * n, id=f"bin{n}") for n in LENGTHS]
    + [pytest.param(list(range(n)), id=f"array{n}") for n in COUNTS]
    + [pytest.param({str(i): i for i in range(n)}, id=f"map{n}")
       for n in COUNTS]
    + [pytest.param(x, id=n) for n, x in (
        ("nil", None), ("true", True), ("false", False), ("float", 0.1),
        ("float-neg", -2.5e-300), ("inf", float("inf")),
        ("np-float64", np.float64(1.25)), ("bytearray", bytearray(b"ab")),
        ("memoryview", memoryview(b"cd")), ("nested", NESTED))])


@pytest.mark.parametrize("obj", CODEC_CASES)
def test_codec_bytes_equal_msgpack(obj):
    want = msgpack.packb(obj, use_bin_type=True)
    assert _msgpack.packb(obj) == want
    assert _msgpack.unpackb(want) == msgpack.unpackb(want, raw=False)


_SCALARS = (st.none() | st.booleans()
            | st.integers(-2 ** 63, 2 ** 64 - 1)
            | st.floats(allow_nan=False) | st.text(max_size=40)
            | st.binary(max_size=300))
_TREES = st.recursive(
    _SCALARS, lambda kids: st.lists(kids, max_size=20)
    | st.dictionaries(st.text(max_size=8), kids, max_size=20),
    max_leaves=60)


@settings(max_examples=150, deadline=None)
@given(_TREES)
def test_codec_drawn_payloads_equal_msgpack(obj):
    want = msgpack.packb(obj, use_bin_type=True)
    assert _msgpack.packb(obj) == want
    assert _msgpack.unpackb(want) == msgpack.unpackb(want, raw=False)


def test_codec_reads_every_form_msgpack_writes():
    """float32, and the 8/16/32-bit forms msgpack's str8-less mode never
    chooses for our writes, decode as msgpack decodes them."""
    single = msgpack.packb([1.5, -0.1], use_single_float=True)
    assert _msgpack.unpackb(single) == msgpack.unpackb(single)
    # hand-built long forms of short values: uint64 5, int64 -5, str32,
    # bin32, array32, map32
    forms = (b"\xcf" + (5).to_bytes(8, "big"),
             b"\xd3" + (-5).to_bytes(8, "big", signed=True),
             b"\xdb\x00\x00\x00\x02hi", b"\xc6\x00\x00\x00\x01z",
             b"\xdd\x00\x00\x00\x01\xc0", b"\xdf\x00\x00\x00\x01\xa1k\x01")
    for raw in forms:
        assert _msgpack.unpackb(raw) == msgpack.unpackb(raw, raw=False)


@pytest.mark.parametrize("raw,err", [
    (b"", "truncated"), (b"\x92\x01", "truncated"),
    (b"\xc4\x05ab", "truncated"), (b"\x01\x02", "trailing"),
    (b"\xd4\x01\x00", "unsupported"), (b"\xc1", "unsupported")])
def test_codec_refuses_bad_bytes(raw, err):
    with pytest.raises(ValueError, match=err):
        _msgpack.unpackb(raw)


@pytest.mark.parametrize("obj", [np.int64(3), np.bool_(True), object(),
                                 2 ** 64, -2 ** 63 - 1],
                         ids=["np-int64", "np-bool", "object", "uint65",
                              "int65"])
def test_codec_refuses_what_msgpack_refuses(obj):
    with pytest.raises((TypeError, OverflowError)):
        msgpack.packb(obj, use_bin_type=True)
    with pytest.raises((TypeError, OverflowError)):
        _msgpack.packb(obj)


# ------------------------------------------ files across the two packages ---

def _trees(lib):
    """The same trees in the reference's arrays (lib=jnp) or the port's
    tensors (lib=torch)."""
    def arr(x, dtype):
        if lib is jnp:
            return jnp.asarray(x, dtype=getattr(jnp, dtype)) \
                if dtype != "uint32" else np.asarray(x, np.uint32)
        if dtype == "uint32":
            return torch.tensor(np.asarray(x, np.int64)).to(torch.uint32)
        return torch.tensor(np.asarray(x)).to(getattr(torch, dtype))

    return {
        "dtypes": {"f32": arr([1.5, -2.0], "float32"),
                   "bf16": arr([[0.5, 3.0, -7.0]], "bfloat16"),
                   "i32": arr([-3, 2 ** 31 - 1], "int32"),
                   "u32": arr([0, 2 ** 32 - 1, 7], "uint32"),
                   "b": arr([True, False], "bool")},
        "f64": {"w": np.arange(6, dtype=np.float64).reshape(2, 3)},
        "scalar": {"s": arr(2.5, "float32"), "k": arr(7, "int32")},
        "empty": {},
        "unsorted": {"zeta": arr([1.0], "float32"),
                     "alpha": {"y": arr([2], "int32"),
                               "b": arr([3.0], "float32")},
                     "mid": [arr([4.0], "float32"), arr([5], "int32")]},
        "tuples": {"t": (arr([1.0], "float32"), (), None,
                         (arr([2], "int32"),)), "n": None},
    }


TREES = sorted(_trees(torch))


@pytest.mark.parametrize("name", TREES)
def test_reference_file_loads_in_port(tmp_path, name):
    path = str(tmp_path / "ref.msgpack")
    jtree, ttree = _trees(jnp)[name], _trees(torch)[name]
    jck.save_checkpoint(path, jtree, step=3, metadata={"who": "ref"})
    got, step, meta = tck.load_checkpoint(path, like=ttree)
    assert step == 3 and meta == {"who": "ref"}
    _same_leaves(got, jtree)
    assert tck.ckpt.tree_structure(got) == tck.ckpt.tree_structure(ttree)
    flat, _, _ = tck.load_checkpoint(path)
    ref_flat, _, _ = jck.load_checkpoint(path)
    _same_leaves(flat, ref_flat)
    assert tck.ckpt.tree_structure(flat) == jax.tree.map(
        lambda _: None, ref_flat)


@pytest.mark.parametrize("name", TREES)
def test_port_file_loads_in_reference(tmp_path, name):
    path = str(tmp_path / "port.msgpack")
    jtree, ttree = _trees(jnp)[name], _trees(torch)[name]
    tck.save_checkpoint(path, ttree, step=5, metadata={"who": "port"})
    got, step, meta = jck.load_checkpoint(path, like=jtree)
    assert step == 5 and meta == {"who": "port"}
    _same_leaves(ttree, got)
    flat, _, _ = jck.load_checkpoint(path)
    port_flat, _, _ = tck.load_checkpoint(path)
    _same_leaves(port_flat, flat)


def test_port_file_equals_reference_file_but_for_treedef(tmp_path):
    """Byte for byte, the port's file is the reference's with only the
    ``treedef`` string (which no loader reads) differing."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    jck.save_checkpoint(a, _trees(jnp)["unsorted"], step=1, metadata={"m": 1})
    tck.save_checkpoint(b, _trees(torch)["unsorted"], step=1,
                        metadata={"m": 1})
    pa = msgpack.unpackb(open(a, "rb").read(), raw=False)
    pb = msgpack.unpackb(open(b, "rb").read(), raw=False)
    assert list(pa) == list(pb)
    pa.pop("treedef"), pb.pop("treedef")
    assert msgpack.packb(pa, use_bin_type=True) == \
        msgpack.packb(pb, use_bin_type=True)


# ------------------------- the reference's file contract, on the port ------

def test_roundtrip(tmp_path):
    tree = {"layers": {"w": torch.arange(12, dtype=torch.bfloat16
                                         ).reshape(3, 4),
                       "b": torch.ones(4)},
            "step_scale": torch.tensor(2.5)}
    path = str(tmp_path / "ckpt.msgpack")
    tck.save_checkpoint(path, tree, step=17, metadata={"arch": "test"})
    loaded, step, meta = tck.load_checkpoint(path, like=tree)
    assert step == 17 and meta["arch"] == "test"
    _same_leaves(loaded, jax.tree.map(np.asarray, {
        "layers": {"w": jnp.arange(12, dtype=jnp.bfloat16).reshape(3, 4),
                   "b": jnp.ones(4)}, "step_scale": jnp.asarray(2.5)}))
    assert list(loaded["layers"]) == ["w", "b"]      # like's key order


def test_atomic_overwrite(tmp_path):
    path = str(tmp_path / "c.msgpack")
    tck.save_checkpoint(path, {"w": torch.zeros(3)}, step=1)
    tck.save_checkpoint(path, {"w": torch.ones(3)}, step=2)
    loaded, step, _ = tck.load_checkpoint(path, like={"w": torch.ones(3)})
    assert step == 2 and torch.equal(loaded["w"], torch.ones(3))
    assert os.listdir(tmp_path) == ["c.msgpack"]


@pytest.mark.parametrize("like,match", [
    ({"w": torch.zeros(4, dtype=torch.bfloat16)}, "refusing to cast"),
    ({"w": torch.zeros(2, 2)}, "refusing to cast"),
    ({"w": np.zeros(4, np.float64)}, "refusing to cast"),
    ({"w": torch.zeros(4), "b": torch.zeros(1)}, "leaves")],
    ids=["dtype", "shape", "numpy-dtype", "count"])
def test_mismatch_raises_instead_of_casting(tmp_path, like, match):
    path = str(tmp_path / "c.msgpack")
    tck.save_checkpoint(path, {"w": torch.arange(4, dtype=torch.float32)})
    with pytest.raises(tck.CheckpointError, match=match):
        tck.load_checkpoint(path, like=like)


def test_scalar_leaf_roundtrip(tmp_path):
    """0-d and Python-scalar leaves round-trip with numpy's dtypes."""
    path = str(tmp_path / "c.msgpack")
    tree = {"f32": torch.tensor(2.5), "py_float": 2.5, "py_int": 7,
            "i64": np.int64(3), "flag": True}
    tck.save_checkpoint(path, tree)
    loaded, _, _ = tck.load_checkpoint(path, like=tree)
    assert [_raw(x)[:2] for x in tree_flatten(loaded)] == [
        ("float32", ()), ("bool", ()), ("int64", ()), ("float64", ()),
        ("int64", ())]
    assert float(loaded["py_float"]) == 2.5 and int(loaded["py_int"]) == 7


@pytest.mark.parametrize("empty", [{}, [], ()], ids=["dict", "list",
                                                     "tuple"])
def test_empty_tree_roundtrip(tmp_path, empty):
    path = str(tmp_path / "c.msgpack")
    tck.save_checkpoint(path, empty, step=4, metadata={"note": "empty"})
    loaded, step, meta = tck.load_checkpoint(path, like=empty)
    assert step == 4 and meta["note"] == "empty" and loaded == empty
    loaded, _, _ = tck.load_checkpoint(path)
    assert tree_flatten(loaded) == []


def test_structure_restore_without_like(tmp_path):
    path = str(tmp_path / "c.msgpack")
    tree = {"a": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)},
            "b": [np.int64(2), np.float64(0.5)]}
    tck.save_checkpoint(path, tree, step=9)
    loaded, step, _ = tck.load_checkpoint(path)
    assert step == 9 and set(loaded) == {"a", "b"}
    assert torch.equal(loaded["a"]["w"], tree["a"]["w"])
    assert int(loaded["b"][0]) == 2 and float(loaded["b"][1]) == 0.5


@pytest.mark.parametrize("damage", ["half", "zeros", "empty", "garbage"])
def test_truncated_and_corrupt_files_raise_cleanly(tmp_path, damage):
    path = str(tmp_path / "c.msgpack")
    tree = {"w": torch.arange(64, dtype=torch.float32)}
    tck.save_checkpoint(path, tree)
    blob = open(path, "rb").read()
    bad = {"half": blob[:len(blob) // 2], "zeros": b"\x00" * 16 + blob[16:],
           "empty": b"", "garbage": b"\xc1" * 8}[damage]
    with open(path, "wb") as f:
        f.write(bad)
    with pytest.raises(tck.CheckpointError, match="truncated or corrupt"):
        tck.load_checkpoint(path, like=tree)
    with pytest.raises(tck.CheckpointError):
        tck.load_checkpoint(path)


def test_failed_save_leaves_no_tmp_files(tmp_path):
    path = str(tmp_path / "c.msgpack")
    tck.save_checkpoint(path, {"w": torch.ones(3)}, step=1)
    with pytest.raises(TypeError):
        tck.save_checkpoint(path, {"w": torch.ones(3)},
                            metadata={"bad": object()})
    assert os.listdir(tmp_path) == ["c.msgpack"]
    loaded, step, _ = tck.load_checkpoint(path, like={"w": torch.ones(3)})
    assert step == 1 and torch.equal(loaded["w"], torch.ones(3))


def test_card_tensors_and_views_save_as_their_values(tmp_path):
    """A non-contiguous view and a bfloat16 slice store their own values,
    not their storage's."""
    base = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    tree = {"t": base.t(), "s": base.bfloat16()[1:3, ::2]}
    path = str(tmp_path / "c.msgpack")
    tck.save_checkpoint(path, tree)
    loaded, _, _ = tck.load_checkpoint(path, like=tree)
    assert torch.equal(loaded["t"], base.t())
    assert torch.equal(loaded["s"], base.bfloat16()[1:3, ::2])
