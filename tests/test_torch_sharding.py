"""The port's logical-axis sharding rules (``repro_torch/parallel/
sharding.py``) held to the JAX package's ``repro/parallel/sharding.py``
on the CPU.

* ``spec_for`` equals JAX's for every leaf of every arch's abstract
  parameters, caches and batches (both packages' ``input_specs`` at full
  size), under the three rule tables, on the meshes (16, 16),
  (2, 16, 16), (2, 2) and (2, 2, 2). JAX's ``spec_for`` reads only
  ``mesh.shape``, so both take the same ``MeshShape``.
* A Hypothesis case over random shapes, axes and meshes.
* ``tree_specs`` against JAX's ``tree_shardings``' specs, ``num_workers``,
  ``bytes_of``, ``shard_shape`` against JAX's shard shapes, and a
  ``DeviceMesh`` read through its dimension names.
"""
import functools

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402

from repro.configs import ARCH_IDS as J_ARCH_IDS  # noqa: E402
from repro.configs import INPUT_SHAPES as J_SHAPES  # noqa: E402
from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import WASGDConfig as JWASGDConfig  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.launch.specs import input_specs as j_input_specs  # noqa: E402
from repro.parallel import sharding as JS  # noqa: E402
from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.parallel import sharding as S  # noqa: E402

MESHES = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
    "2x2": {"data": 2, "model": 2},
    "2x2x2": {"pod": 2, "data": 2, "model": 2},
}
RULES = {"train": (S.TRAIN_RULES, JS.TRAIN_RULES),
         "serve": (S.SERVE_RULES, JS.SERVE_RULES),
         "serve_long": (S.SERVE_LONG_RULES, JS.SERVE_LONG_RULES)}
LOGICAL = sorted(S.TRAIN_RULES) + [None]


@functools.lru_cache(maxsize=None)
def jax_workload(arch, shape_name):
    """JAX's ``input_specs`` of one full-size combination at 16 workers
    (tau 1, as JAX's matrix test), cached for both test files."""
    shape = next(s for s in J_SHAPES if s.name == shape_name)
    return j_input_specs(j_get_config(arch), shape, 16,
                         JTrainConfig(wasgd=JWASGDConfig(tau=1)))


def jax_leaves(wl):
    """(shape, axes) of every leaf of a JAX workload's arguments."""
    out = []
    for shapes, axes in zip(wl.arg_shapes, wl.arg_axes):
        leaves, treedef = jax.tree.flatten(shapes)
        out += [(tuple(s.shape), tuple(a))
                for s, a in zip(leaves, treedef.flatten_up_to(axes))]
    return out


def test_rule_tables_are_jax_tables():
    for port, ref in RULES.values():
        assert port == ref


def test_arch_lists_agree():
    assert sorted(ARCH_IDS) == sorted(J_ARCH_IDS)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_for_matches_jax_on_every_leaf(arch):
    """Every leaf of the arch's four workloads, 4 meshes x 3 tables."""
    leaves = sorted({leaf for s in J_SHAPES
                     for leaf in jax_leaves(jax_workload(arch, s.name))})
    assert len(leaves) > 10
    n = 0
    for mesh_shape in MESHES.values():
        mesh = S.MeshShape(mesh_shape)
        for port_rules, jax_rules in RULES.values():
            for shape, axes in leaves:
                want = tuple(JS.spec_for(mesh, axes, shape, jax_rules))
                got = S.spec_for(mesh, axes, shape, port_rules)
                assert got == want, (arch, mesh_shape, axes, shape)
                n += 1
    assert n == len(leaves) * 12


@settings(max_examples=200, deadline=None)
@given(st.lists(st.tuples(st.sampled_from(LOGICAL),
                          st.integers(1, 64)), min_size=0, max_size=5),
       st.sampled_from(sorted(MESHES)), st.sampled_from(sorted(RULES)),
       st.booleans())
def test_spec_for_random_axes_match_jax(dims, mesh_name, rules_name,
                                        with_shape):
    axes = tuple(a for a, _ in dims)
    shape = tuple(n for _, n in dims) if with_shape else None
    mesh = S.MeshShape(MESHES[mesh_name])
    port_rules, jax_rules = RULES[rules_name]
    want = tuple(JS.spec_for(mesh, axes, shape, jax_rules))
    assert S.spec_for(mesh, axes, shape, port_rules) == want


@pytest.mark.parametrize("shape_name", ["train_4k", "decode_32k"])
def test_tree_specs_match_jax_tree_shardings(shape_name):
    """``tree_specs`` on the port's own workload against the specs of
    JAX's ``tree_shardings`` on JAX's, leaf for leaf, on the production
    mesh's shape. JAX's extra leaves are the 0-d counters the port keeps
    on the host (``TrainState.step``, the decode ``index``)."""
    from repro_torch.configs import SHAPES_BY_NAME, TrainConfig, WASGDConfig
    from repro_torch.configs import get_config
    from repro_torch.launch.specs import input_specs
    jwl = jax_workload("olmoe-1b-7b", shape_name)
    pwl = input_specs(get_config("olmoe-1b-7b"), SHAPES_BY_NAME[shape_name],
                      16, TrainConfig(wasgd=WASGDConfig(tau=1)))
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    mesh = S.MeshShape(MESHES["16x16"])
    for js, ja, ps, pa in zip(jwl.arg_shapes, jwl.arg_axes, pwl.arg_shapes,
                              pwl.arg_axes):
        # the specs of the 1-device mesh's shardings, re-resolved on the
        # production shape through JAX's spec_for, as tree_shardings does
        leaves, treedef = jax.tree.flatten(js)
        axes = treedef.flatten_up_to(ja)
        assert len(jax.tree.leaves(JS.tree_shardings(jmesh, js, ja,
                                                     jwl.rules))) \
            == len(leaves)
        want = [(tuple(s.shape), tuple(JS.spec_for(mesh, a, s.shape,
                                                   jwl.rules)))
                for s, a in zip(leaves, axes)]
        got = [(tuple(t.shape), spec) for t, spec in S.leaves_with_axes(
            ps, S.tree_specs(mesh, ps, pa, pwl.rules))]
        host = [w for w in want if w not in got]
        assert all(w == ((), ()) for w in host), host
        assert [w for w in want if w != ((), ())] == \
            [g for g in got if g != ((), ())]
        n_host = sum(isinstance(x, int) for x in
                     torch.utils._pytree.tree_flatten(ps)[0])
        assert len(host) == n_host


def test_num_workers_bytes_and_shard_shape_match_jax():
    for mesh_shape in MESHES.values():
        mesh = S.MeshShape(mesh_shape)
        assert S.num_workers(mesh) == JS.num_workers(mesh)
        assert mesh.size == int(np.prod(list(mesh_shape.values())))
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16,
                                                    jnp.bfloat16),
                    (torch.int32, jnp.int32), (torch.bool, jnp.bool_)):
        assert S.bytes_of((3, 5, 7), dt) == JS.bytes_of((3, 5, 7), jdt)
    mesh = S.MeshShape(MESHES["2x16x16"])
    spec = S.spec_for(mesh, ("worker", "embed", "ffn"), (32, 2048, 8192))
    assert spec == (("pod", "data"), None, "model")
    assert S.shard_shape((32, 2048, 8192), spec, mesh) == (1, 2048, 512)
    assert S.shard_shape((3, 5), (), mesh) == (3, 5)
    one = S.MeshShape({"data": 1, "model": 1})
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    sh = NamedSharding(jmesh, JS.spec_for(jmesh, ("embed", "ffn"), (8, 4)))
    assert S.shard_shape((8, 4), S.spec_for(one, ("embed", "ffn"), (8, 4)),
                         one) == sh.shard_shape((8, 4))


def test_tree_bytes_counts_one_device_block():
    mesh = S.MeshShape(MESHES["2x2"])
    tree = {"w": torch.empty((2, 8, 6), device="meta"),
            "b": torch.empty((6,), dtype=torch.bfloat16, device="meta")}
    axes = {"w": ("worker", "embed", "ffn"), "b": ("ffn",)}
    assert S.tree_bytes(tree, axes) == 2 * 8 * 6 * 4 + 6 * 2
    # w: worker over data (2), ffn over model (2); b: ffn over model
    assert S.tree_bytes(tree, axes, mesh) == 1 * 8 * 3 * 4 + 3 * 2


def test_device_mesh_is_read_by_its_dimension_names(tmp_path):
    from test_torch_mesh import world1
    with world1(tmp_path / "store", dims=("data", "model")) as dmesh:
        assert S.mesh_shape(dmesh) == {"data": 1, "model": 1}
        assert S.spec_for(dmesh, ("worker", "heads"), (4, 8)) == \
            ("data", "model")
        assert S.num_workers(dmesh) == 1
