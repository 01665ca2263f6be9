"""The port's registry (``repro_torch.configs.registry``) against the JAX
package's: the same cells and skips, the same ``microbatches``, and for
every one of the cells the port's meta ``abstract_args`` equal to the
reference's ``build_cell`` on a 1x1 CPU mesh (``ShapeDtypeStruct``
leaves), leaf by leaf in shape and dtype, with the same description and
cost multiplier; on the 2-device meshes every LM and recsys cell's
``in_specs`` equal to the reference's ``in_shardings``.
"""

from concurrent.futures import ThreadPoolExecutor

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.launch.mesh import make_compat_mesh  # noqa: E402

from repro_torch import tree  # noqa: E402
from repro_torch.configs import registry  # noqa: E402

import _mesh_specs  # noqa: E402


@pytest.fixture(scope="module")
def jmesh():
    return make_compat_mesh((1, 1), ("data", "model"))


def test_cells_and_skips_match_reference():
    assert registry.all_cells() == jreg.all_cells()
    assert registry.skipped_cells() == jreg.skipped_cells()
    assert len(registry.all_cells()) == 36
    assert len(registry.skipped_cells()) == 4


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_spec_matches_reference(arch):
    got, want = registry.get_spec(arch), jreg.get_spec(arch)
    assert got.microbatches == want.microbatches
    assert got.family == want.family
    assert got.skip_shapes == want.skip_shapes
    assert list(got.shapes) == list(want.shapes)


def test_microbatches_restored():
    mb = {a: registry.get_spec(a).microbatches for a in registry.ARCH_IDS}
    assert mb["qwen3-1.7b"] == 2
    assert mb["gemma2-2b"] == 4
    assert mb["phi3.5-moe-42b-a6.6b"] == 4
    assert sum(v != 1 for v in mb.values()) == 3


def _dtype(t) -> str:
    return str(t.dtype).removeprefix("torch.")


@pytest.mark.parametrize("arch,shape", jreg.all_cells())
def test_abstract_args_match_reference(arch, shape, jmesh):
    """Leaf by leaf (the reference's tree order: dict keys sorted): equal
    shapes and dtypes; every port leaf on ``meta``."""
    got = registry.build_cell(registry.get_spec(arch), shape)
    want = jreg.build_cell(jreg.get_spec(arch), shape, jmesh)
    assert got.description == want.description
    assert got.cost_multiplier == want.cost_multiplier
    assert len(got.abstract_args) == len(want.abstract_args)
    for g_arg, w_arg in zip(got.abstract_args, want.abstract_args):
        g_flat = tree.flatten(g_arg)
        w_flat = jax.tree_util.tree_flatten_with_path(w_arg)[0]
        assert len(g_flat) == len(w_flat)
        for (path, g), (w_path, w) in zip(g_flat, w_flat):
            where = f"{arch} {shape} {tree.path_key(path)} / {w_path}"
            assert g.device.type == "meta", where
            assert tuple(g.shape) == tuple(w.shape), where
            assert _dtype(g) == str(w.dtype), where


class _Mesh:
    """Rank 0's view of a mesh of ``shape`` (what ``build_cell`` reads)."""

    def __init__(self, shape):
        self.shape, self.mesh_dim_names = shape, _mesh_specs.AXES

    def size(self):
        return self.shape[0] * self.shape[1]

    def get_local_rank(self, axis):
        return 0


@pytest.fixture(scope="module")
def reference_layouts():
    """The reference's ``in_shardings`` of the LM and recsys cells on the
    2-device meshes, built in a subprocess with two host devices."""
    shapes = ((2, 1), (1, 2))
    with ThreadPoolExecutor(len(shapes)) as pool:
        return dict(zip(shapes, pool.map(_mesh_specs.run_reference_specs,
                                         shapes)))


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
def test_build_cell_refuses_a_larger_mesh(shape, reference_layouts):
    """Once a refusal (an LM cell ran on one device only); now that the
    layouts are ported, every LM and recsys cell builds on a 2-device
    mesh and its ``in_specs`` (params, opt, batch, cache) equal the
    reference's ``in_shardings`` there."""
    want = reference_layouts[shape]
    assert len(want) == 20
    for (arch, name), layouts in want.items():
        cell = registry.build_cell(registry.get_spec(arch), name,
                                   _Mesh(shape))
        assert _mesh_specs.port_specs(cell) == layouts, (arch, name)
