"""The port's meshes (``repro_torch.launch.mesh``, on ``torch.distributed``)
and ``compressed_psum`` (``repro_torch.optim.compression``) on the CPU
with gloo: a world of one started through a ``HashStore``, the mesh
shapes and axis names of ``plan_mesh`` and of the reference's
``make_mesh_for_devices``, the production meshes refused at a world of
one; ``compressed_psum`` equal to the dequantized ``ef_compress`` in a
world of one, and in a gloo world of two processes (``FileStore``) equal
bit for bit to the reference's ``compressed_psum`` under ``jax.vmap``
with an axis name, mean and each rank's residual, a planted fault (the
residual left out) unequal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.optim import compression  # noqa: E402
from repro_torch.runtime.fault_tolerance import plan_mesh  # noqa: E402

WORLD = 2
SHAPE = (3, 257)


@pytest.fixture(autouse=True)
def no_group():
    if dist.is_initialized():
        dist.destroy_process_group()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_world_of_one_mesh():
    mesh = tmesh.make_compat_mesh((1, 1), ("data", "model"), "cpu")
    assert dist.is_initialized() and dist.get_world_size() == 1
    assert dist.get_backend() == "gloo"
    assert tuple(mesh.shape) == (1, 1)
    assert mesh.mesh_dim_names == ("data", "model")
    assert mesh.size() == 1
    assert dist.get_world_size(mesh.get_group("data")) == 1


@pytest.mark.parametrize("model_axis,pod_axis", [(1, 1)])
def test_mesh_for_devices_matches_plan_mesh(model_axis, pod_axis):
    from repro.launch.mesh import make_mesh_for_devices as jmesh_for
    import jax
    got = tmesh.make_mesh_for_devices(["cpu"], model_axis, pod_axis)
    want = jmesh_for(jax.devices()[:1], model_axis, pod_axis)
    assert tuple(got.shape) == plan_mesh(1, model_axis, pod_axis)
    assert tuple(got.shape) == want.devices.shape
    assert got.mesh_dim_names == tuple(want.axis_names)


@pytest.mark.parametrize("devices,model_axis,match", [
    (["cpu"] * 3, 1, "3 devices; the world has 1"),
    (["cpu"], 2, "cannot sustain model axis 2"),
    ([], 1, "no devices"),
])
def test_mesh_for_devices_refused(devices, model_axis, match):
    with pytest.raises(ValueError, match=match):
        tmesh.make_mesh_for_devices(devices, model_axis)
    assert not dist.is_initialized()


@pytest.mark.parametrize("multi_pod,n", [(False, 256), (True, 512)])
def test_production_mesh_raises_at_world_one(multi_pod, n):
    with pytest.raises(ValueError, match=f"holds {n} devices; the world "
                                         f"has 1 ranks"):
        tmesh.make_production_mesh(multi_pod=multi_pod, device="cpu")
    assert not dist.is_initialized()


def test_mesh_shape_and_axes_must_agree():
    with pytest.raises(ValueError, match="differ in length"):
        tmesh.make_compat_mesh((1, 1), ("data",), "cpu")


def _inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (WORLD,) + SHAPE).astype(np.float32)
    r = rng.normal(0, 0.01, (WORLD,) + SHAPE).astype(np.float32)
    return x, r


def test_compressed_psum_world_of_one_is_dequantized_ef():
    mesh = tmesh.make_compat_mesh((1, 1), ("data", "model"), "cpu")
    x, r = (torch.from_numpy(a[0]) for a in _inputs(1))
    got, res = compression.compressed_psum(x, r, mesh.get_group("data"))
    q, scale, want_res = compression.ef_compress(x, r)
    assert torch.equal(got, compression.dequantize_int8(q, scale))
    assert torch.equal(res, want_res)
    planted = compression.dequantize_int8(
        *compression.ef_compress(x, torch.zeros_like(r))[:2])
    assert not torch.equal(got, planted)


def _rank(rank: int, path: str, out: str) -> None:
    store = dist.FileStore(path, WORLD)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=WORLD)
    try:
        mesh = tmesh.make_compat_mesh((WORLD, 1), ("data", "model"), "cpu")
        x, r = (torch.from_numpy(a[rank]) for a in _inputs())
        mean, res = compression.compressed_psum(x, r, mesh.get_group("data"))
        torch.save({"mean": mean, "res": res}, f"{out}.{rank}")
    finally:
        dist.destroy_process_group()


def test_compressed_psum_gloo_world_of_two_matches_reference(tmp_path):
    import jax
    import jax.numpy as jnp
    from repro.optim.compression import compressed_psum as jpsum
    torch.multiprocessing.spawn(
        _rank, args=(str(tmp_path / "store"), str(tmp_path / "out")),
        nprocs=WORLD, join=True)
    x, r = _inputs()
    want_mean, want_res = jax.vmap(lambda a, b: jpsum(a, b, "data"),
                                   axis_name="data")(jnp.asarray(x),
                                                     jnp.asarray(r))
    planted = jax.vmap(lambda a, b: jpsum(a, b, "data"), axis_name="data")(
        jnp.asarray(x), jnp.zeros_like(jnp.asarray(r)))[0]
    for rank in range(WORLD):
        got = torch.load(tmp_path / f"out.{rank}")
        np.testing.assert_array_equal(got["mean"].numpy(),
                                      np.asarray(want_mean[rank]))
        np.testing.assert_array_equal(got["res"].numpy(),
                                      np.asarray(want_res[rank]))
        assert not np.array_equal(got["mean"].numpy(),
                                  np.asarray(planted[rank]))
    # every rank holds the same mean
    np.testing.assert_array_equal(np.asarray(want_mean[0]),
                                  np.asarray(want_mean[1]))
