"""The port's partition layer (``parallel/partition.py``, ``parallel/mesh.py``)
against the JAX package's, case for case as ``tests/test_partition.py``
holds JAX's: the mesh spec grammar, mesh construction and device slices,
the regex rule engine (first match wins, scalars skip the rules, the
no-match error names the leaf's path, specs clip to the leaf's rank), the
canonical rule sets and the stack trees' naive fallback.

The port's mesh holds rank ids rather than ``jax.Device``s, so each case
builds both meshes over 8 devices (the JAX package's virtual CPU mesh, the
port's ranks 0..7) and compares what they decide: specs entry for entry,
and each device's slices with ``NamedSharding.devices_indices_map``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from deeplearninginassetpricing_paperreplication_torch.parallel import mesh
from deeplearninginassetpricing_paperreplication_torch.parallel import (
    partition,
)
from deeplearninginassetpricing_paperreplication_torch.parallel.partition import (  # noqa: E501
    P,
)
from deeplearninginassetpricing_paperreplication_tpu.parallel import (
    partition as jpartition,
)

EIGHT = tuple(range(8))


def _same_spec(port, jax_spec):
    return tuple(port) == tuple(jax_spec)


def test_rule_precedence_first_match_wins():
    tree = {"sdf_net": {"kernel": torch.ones(8, 3), "bias": torch.ones(8)}}
    specs = partition.match_partition_rules(
        [(r"kernel", P("grid")), (r".*", P())], tree)
    assert specs["sdf_net"]["kernel"] == P("grid")
    assert specs["sdf_net"]["bias"] == P()
    specs = partition.match_partition_rules(
        [(r".*", P()), (r"kernel", P("grid"))], tree)
    assert specs["sdf_net"]["kernel"] == P()
    jspecs = jpartition.match_partition_rules(
        [(r"kernel", JP("grid")), (r".*", JP())],
        {"sdf_net": {"kernel": jnp.ones((8, 3)), "bias": jnp.ones((8,))}})
    assert _same_spec(jspecs["sdf_net"]["kernel"], P("grid"))


def test_rule_matching_skips_scalars_without_consulting_rules():
    tree = {"n_assets": torch.tensor(7.0), "one": torch.ones(1),
            "vec": torch.ones(4), "arr": np.ones(4), "f": np.float32(2.0)}
    specs = partition.match_partition_rules([(r".*", P("grid"))], tree)
    assert specs["n_assets"] == P() and specs["one"] == P()
    assert specs["f"] == P()
    assert specs["vec"] == P("grid") and specs["arr"] == P("grid")


def test_rule_no_match_error_names_the_leaf_path():
    tree = {"outer": {"mystery_leaf": torch.ones(4, 2)}}
    with pytest.raises(ValueError, match="outer/mystery_leaf"):
        partition.match_partition_rules([(r"^only_this$", P("grid"))], tree)
    # lists and tuples name their indices, as JAX's tree paths do
    with pytest.raises(ValueError, match="layers/1/0"):
        partition.match_partition_rules(
            [(r"^layers/0", P())],
            {"layers": [(torch.ones(2, 2),), (torch.ones(2, 2),)]})


def test_tree_shardings_clips_specs_beyond_leaf_rank():
    m = partition.create_mesh(8, devices=EIGHT)
    sh = partition.tree_shardings(m, {"x": torch.ones(4)},
                                  [(r".*", P(None, None))])
    assert sh["x"].spec == P(None)
    with pytest.raises(ValueError, match="beyond the leaf's rank"):
        partition.tree_shardings(m, {"x": torch.ones(4)},
                                 [(r".*", P(None, "stocks"))])


def test_batch_shardings_layout_matches_jax():
    m = partition.create_mesh(8, devices=EIGHT)
    jm = jpartition.create_mesh(8)
    sh, jsh = partition.batch_shardings(m), jpartition.batch_shardings(jm)
    assert set(sh) == set(jsh) == set(partition.BATCH_KEYS)
    for k in sh:
        assert _same_spec(sh[k].spec, jsh[k].spec), k
    assert sh["individual_t"].spec == P(None, None, "stocks")
    # each device's slices are JAX's, device for device (mesh order)
    shape = (6, 64, 5)
    jmap = jsh["individual"].devices_indices_map(shape)
    for rank, jdev in zip(EIGHT, jm.devices.ravel()):
        assert sh["individual"].index(shape, rank) == jmap[jdev]


def test_stack_tree_shardings_naive_fallback():
    m = partition.grid_slice_mesh(0, 2, devices=EIGHT)  # 4 devices
    tree = {"ok": torch.ones(8, 2), "ragged": torch.ones(6, 2),
            "scalar": torch.tensor(1.0)}
    sh = partition.stack_tree_shardings(m, tree)
    assert sh["ok"].spec == P("grid")
    assert sh["ragged"].spec == P() and sh["scalar"].spec == P()
    local = partition.shard_stack_tree(tree, m, device=2)
    assert torch.equal(local["ok"], torch.ones(2, 2))
    assert local["ragged"].shape == (6, 2)


def test_mesh_config_builds_and_validates():
    m = partition.MeshConfig((("grid", 2), ("stocks", 4)), EIGHT).build()
    assert m.shape == {"grid": 2, "stocks": 4}
    m = partition.MeshConfig((("members", 2), ("stocks", -1)), EIGHT).build()
    assert m.shape["members"] == 2 and m.shape["stocks"] == 4
    with pytest.raises(ValueError, match="at most one -1"):
        partition.MeshConfig((("a", -1), ("b", -1)), EIGHT).build()
    with pytest.raises(ValueError, match="needs 16 devices"):
        partition.MeshConfig((("grid", 16),), EIGHT).build()
    # without devices: the process group's ranks (one without a group)
    assert partition.MeshConfig((("stocks", -1),)).build().shape == {
        "stocks": 1}


@pytest.mark.parametrize("spec,axes", [
    ("stocks=4", (("stocks", 4),)), ("stocks=-1", (("stocks", -1),)),
    ("members=2,stocks=4", (("members", 2), ("stocks", 4))),
    ("4", (("stocks", 4),)), (" members = 2 , stocks = -1 ",
                              (("members", 2), ("stocks", -1)))])
def test_parse_mesh_spec_grammar(spec, axes):
    assert partition.parse_mesh_spec(spec).axes == axes
    assert jpartition.parse_mesh_spec(spec).axes == axes


@pytest.mark.parametrize("bad,match", [
    ("", "empty"), ("stocks=x", "non-integer"), ("stocks=0", ">= 1"),
    ("a=2,a=2", "repeats"), ("=2", "missing a name"), (",", "names no")])
def test_parse_mesh_spec_rejects(bad, match):
    with pytest.raises(ValueError, match=match):
        partition.parse_mesh_spec(bad)
    with pytest.raises(ValueError, match=match):
        jpartition.parse_mesh_spec(bad)


def test_mesh_spec_str_round_trips():
    m = partition.parse_mesh_spec("members=2,stocks=4", EIGHT).build()
    assert partition.mesh_spec_str(m) == "members=2,stocks=4"
    assert jpartition.mesh_spec_str(jpartition.parse_mesh_spec(
        "members=2,stocks=4").build()) == "members=2,stocks=4"


def test_device_slices_are_disjoint_and_validated():
    s0 = partition.slice_devices(0, 2, devices=EIGHT)
    s1 = partition.slice_devices(1, 2, devices=EIGHT)
    assert s0 == (0, 1, 2, 3) and s1 == (4, 5, 6, 7)
    assert [d.id for d in jpartition.slice_devices(1, 2)] == list(s1)
    with pytest.raises(ValueError, match="not in"):
        partition.slice_devices(2, 2, devices=EIGHT)
    with pytest.raises(ValueError, match="exceed"):
        partition.slice_devices(0, 2, width=8, devices=EIGHT)
    m = partition.grid_slice_mesh(1, 2, devices=EIGHT)
    assert m.devices.ravel().tolist() == list(s1) and m.shape == {"grid": 4}


def test_device_mesh_is_the_degenerate_one_device_mesh():
    m = partition.device_mesh()
    assert m.shape == {"stocks": 1} and m.devices.ravel().tolist() == [0]
    sh = partition.replicated(m)
    assert sh.spec == P() and sh.index((4,), 0) == (slice(None),)
    assert partition.device_mesh(3).devices.ravel().tolist() == [3]
    assert partition.device_sharding() == sh


def test_create_meshes_validate():
    assert partition.create_mesh(8, devices=EIGHT).shape == {"stocks": 8}
    m2 = partition.create_2d_mesh(2, 4, devices=EIGHT)
    assert m2.shape == {"batch": 2, "stocks": 4}
    with pytest.raises(ValueError):
        partition.create_2d_mesh(16, devices=EIGHT)
    with pytest.raises(ValueError):
        partition.create_2d_mesh(3, 4, devices=EIGHT)
    with pytest.raises(ValueError, match="requested 9"):
        partition.create_mesh(9, devices=EIGHT)


def test_member_sharding_resolves_stack_axis():
    assert partition.member_sharding(partition.create_2d_mesh(
        2, 4, devices=EIGHT)).spec == P("batch")
    assert partition.member_sharding(partition.grid_slice_mesh(
        0, 2, devices=EIGHT)).spec == P("grid")
    with pytest.raises(ValueError, match="no member-ish axis"):
        partition.member_sharding(partition.create_mesh(8, devices=EIGHT))


def test_shard_tree_gives_each_device_its_contiguous_span():
    """A 2-D mesh: the member axis and the stock axis split together; each
    device's part is a contiguous copy (the kernels refuse a view)."""
    m = partition.create_2d_mesh(2, 4, devices=EIGHT)
    x = torch.arange(2 * 6 * 8, dtype=torch.float32).reshape(2, 6, 8)
    rules = [(r"x$", P("batch", None, "stocks")), (r".*", P())]
    jm = jpartition.create_2d_mesh(2, 4)
    jmap = jpartition.tree_shardings(jm, {"x": jnp.asarray(x.numpy())}, [
        (r"x$", JP("batch", None, "stocks")), (r".*", JP())])[
        "x"].devices_indices_map(tuple(x.shape))
    for rank, jdev in zip(EIGHT, jm.devices.ravel()):
        part = partition.shard_tree({"x": x, "s": torch.tensor(2.0)}, m,
                                    rules, device=rank)
        assert part["x"].is_contiguous()
        assert torch.equal(part["x"], x[jmap[jdev]])
        assert float(part["s"]) == 2.0


def test_mesh_facade_reexports_the_partition_layer():
    m = mesh.create_mesh(2, devices=(0, 1))
    assert mesh.batch_shardings(m)["returns"].spec == P(None, "stocks")
    for name in mesh.__all__:
        assert getattr(mesh, name) is getattr(partition, name)
