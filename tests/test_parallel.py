"""Sharded tracing on the virtual 8-device CPU mesh."""
import jax
import numpy as np
import pytest

from rtk_tpu import build_scene, trace_closest
from rtk_tpu.parallel.shard import (
    default_mesh,
    trace_any_sharded,
    trace_closest_sharded,
)
from rtk_tpu.testing import scenes


def _scene():
    tris = scenes.cornell_box()
    return build_scene(
        (tris.reshape(-1, 3), np.arange(tris.shape[0] * 3).reshape(-1, 3)))


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8


@pytest.mark.smoke
def test_sharded_matches_single_device():
    scene = _scene()
    rays = scenes.cornell_camera(32, 32)  # 1024 rays, divisible by 8
    want = trace_closest(scene, rays)
    got = trace_closest_sharded(scene, rays, default_mesh())
    np.testing.assert_array_equal(np.asarray(got.hit), np.asarray(want.hit))
    np.testing.assert_allclose(np.asarray(got.t), np.asarray(want.t),
                               rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(got.triangle_index),
                                  np.asarray(want.triangle_index))


def test_sharded_ragged_ray_count():
    scene = _scene()
    rays = scenes.cornell_camera(31, 7)  # 217 rays, not divisible by 8
    want = trace_closest(scene, rays)
    got = trace_closest_sharded(scene, rays)
    assert got.t.shape[0] == 217
    np.testing.assert_allclose(np.asarray(got.t), np.asarray(want.t),
                               rtol=1e-6)


def test_sharded_any_hit():
    scene = _scene()
    rays = scenes.cornell_camera(16, 16)
    got = trace_any_sharded(scene, rays)
    assert np.asarray(got.hit).all()


@pytest.mark.smoke
def test_packet_engine_sharded_matches_single():
    """Packet kernel under shard_map on the virtual 8-device mesh."""
    import jax
    import numpy as np

    from rtk_tpu import BuildConfig, build_scene
    from rtk_tpu.parallel.shard import default_mesh, trace_packets_sharded
    from rtk_tpu.ops.pallas_trace import trace_packets
    from rtk_tpu.trace.packed import pack_scene
    from rtk_tpu.testing import scenes

    tris = scenes.cornell_box()
    t = tris.shape[0]
    scene = build_scene((tris.reshape(-1, 3),
                         np.arange(t * 3).reshape(-1, 3)),
                        BuildConfig(leaf_size=8))
    packed = pack_scene(scene)
    rays = scenes.cornell_camera(32, 32)
    mesh = default_mesh(jax.devices()[:8])
    got = trace_packets_sharded(packed, rays, mesh, interpret=True)
    want = trace_packets(packed, rays, interpret=True)
    np.testing.assert_array_equal(np.asarray(got.hit), np.asarray(want.hit))
    np.testing.assert_array_equal(np.asarray(got.t), np.asarray(want.t))
    np.testing.assert_array_equal(np.asarray(got.triangle_index),
                                  np.asarray(want.triangle_index))


def test_scene_sharded_matches_single_device():
    """Scene sharding (v2): spatial partition + ICI hit combine."""
    from rtk_tpu.config import BuildConfig
    from rtk_tpu.parallel.shard import (build_scene_sharded,
                                        trace_any_scene_sharded,
                                        trace_closest_scene_sharded)

    tris = scenes.blob(subdivisions=3)[0]  # 1280 tris over 8 parts
    mesh = default_mesh()
    desc = (tris.reshape(-1, 3), np.arange(tris.shape[0] * 3).reshape(-1, 3))
    sscene = build_scene_sharded(desc, mesh,
                                 BuildConfig(branching=8, leaf_size=8))
    assert sscene.num_parts == 8
    scene = build_scene(desc)
    rays = scenes.camera_rays((0, 0, 3.0), (0, 0, 0), (0, 1, 0), 45, 16, 16)
    want = trace_closest(scene, rays)
    got = trace_closest_scene_sharded(sscene, rays, mesh, interpret=True)
    np.testing.assert_array_equal(np.asarray(got.hit), np.asarray(want.hit))
    np.testing.assert_allclose(np.asarray(got.t), np.asarray(want.t),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(got.u), np.asarray(want.u),
                               rtol=1e-4, atol=1e-5)
    # globalised slots must resolve to the right triangle via the stacked
    # tables (tri_prim here is the original soup triangle index)
    np.testing.assert_array_equal(np.asarray(got.triangle_index),
                                  np.asarray(want.triangle_index))
    occ = trace_any_scene_sharded(sscene, rays, mesh, interpret=True)
    np.testing.assert_array_equal(np.asarray(occ.hit), np.asarray(want.hit))


def test_scene_sharded_any_hit_record_consistent():
    """Scene-sharded any-hit must return a SELF-CONSISTENT record: the
    reported (t, u, v) must reproduce the reported slot's triangle hit
    point (r1 fix: per-field pmax combines produced chimera records
    mixing fields from different chips)."""
    from rtk_tpu.config import BuildConfig
    from rtk_tpu.parallel.shard import (build_scene_sharded,
                                        trace_any_scene_sharded)

    tris = scenes.blob(subdivisions=3)[0]
    mesh = default_mesh()
    desc = (tris.reshape(-1, 3), np.arange(tris.shape[0] * 3).reshape(-1, 3))
    sscene = build_scene_sharded(desc, mesh,
                                 BuildConfig(branching=8, leaf_size=8))
    rays = scenes.camera_rays((0, 0, 3.0), (0, 0, 0), (0, 1, 0), 45, 16, 16)
    occ = trace_any_scene_sharded(sscene, rays, mesh, interpret=True)
    h = np.asarray(occ.hit)
    assert h.any()
    # o + t*d == barycentric(slot triangle, u, v) for every hit ray: only
    # holds when all four fields come from the same chip's intersection.
    slot = np.asarray(occ.slot)[h]
    t = np.asarray(occ.t)[h]
    u = np.asarray(occ.u)[h]
    v = np.asarray(occ.v)[h]
    o = np.asarray(rays.origin)[h]
    d = np.asarray(rays.direction)[h]
    tv = np.asarray(sscene.tri_v.reshape(-1, 3, 3))[slot]
    # Barycentric convention (rtk.c:363-375): u weights v0, v weights v1.
    p_bary = u[:, None] * tv[:, 0] + v[:, None] * tv[:, 1] \
        + (1.0 - u - v)[:, None] * tv[:, 2]
    np.testing.assert_allclose(o + t[:, None] * d, p_bary, atol=5e-3)
    # misses keep the contract: t == max_t, slot == -1
    np.testing.assert_array_equal(np.asarray(occ.slot)[~h], -1)
    np.testing.assert_allclose(np.asarray(occ.t)[~h],
                               np.asarray(rays.max_t)[~h])


def test_hybrid_2d_scene_x_rays_matches_single():
    """Hybrid v3: (2 scene parts) x (4 ray shards) over the 8-device mesh.

    Hit combines ride the scene axis only; the ray axis splits the batch.
    Ragged ray count exercises the ray-axis padding path."""
    from rtk_tpu.config import BuildConfig
    from rtk_tpu.parallel.shard import (build_scene_sharded, hybrid_mesh,
                                        trace_any_scene_sharded,
                                        trace_closest_scene_sharded)

    tris = scenes.blob(subdivisions=3)[0]
    mesh = hybrid_mesh(n_scene=2)
    assert mesh.shape == {"scene": 2, "rays": 4}
    desc = (tris.reshape(-1, 3), np.arange(tris.shape[0] * 3).reshape(-1, 3))
    sscene = build_scene_sharded(desc, mesh,
                                 BuildConfig(branching=8, leaf_size=8))
    assert sscene.num_parts == 2
    scene = build_scene(desc)
    rays = scenes.camera_rays((0, 0, 3.0), (0, 0, 0), (0, 1, 0), 45, 17, 15)
    assert rays.count % 4 != 0  # ragged on the ray axis
    want = trace_closest(scene, rays)
    got = trace_closest_scene_sharded(sscene, rays, mesh, interpret=True)
    assert got.t.shape[0] == rays.count
    np.testing.assert_array_equal(np.asarray(got.hit), np.asarray(want.hit))
    np.testing.assert_allclose(np.asarray(got.t), np.asarray(want.t),
                               rtol=1e-5, atol=1e-6)
    mism = np.asarray(got.triangle_index) != np.asarray(want.triangle_index)
    if mism.any():  # partitions may resolve exact-t ties differently
        dt = np.abs(np.asarray(got.t)[mism] - np.asarray(want.t)[mism])
        assert dt.max() == 0.0, "non-tie triangle mismatch"
    occ = trace_any_scene_sharded(sscene, rays, mesh, interpret=True)
    np.testing.assert_array_equal(np.asarray(occ.hit), np.asarray(want.hit))


def test_partition_soup_rejects_tiny_scenes():
    import pytest

    from rtk_tpu.parallel.shard import partition_soup

    tri_pos = np.zeros((5, 3, 3), np.float32)
    with pytest.raises(ValueError, match="non-empty parts"):
        partition_soup(tri_pos, 8)


def test_instanced_sharded_matches_single():
    """Instanced (TLAS/BLAS) packet tracing under shard_map on the
    virtual 8-device mesh (PackedInstancedScene replicated, rays split;
    the exactness residual runs once on the gathered outputs)."""
    import jax
    import numpy as np

    from rtk_tpu.instancing import (build_instanced, pack_instanced,
                                    trace_closest_instanced_packets)
    from rtk_tpu.parallel.shard import default_mesh, trace_instanced_sharded
    from rtk_tpu.testing import scenes
    from rtk_tpu.types import Rays
    from rtk_tpu import build_scene

    rng = np.random.default_rng(41)
    blob_tris = scenes.blob(subdivisions=2)[0]
    soup = (blob_tris.reshape(-1, 3),
            np.arange(blob_tris.shape[0] * 3).reshape(-1, 3))
    blas = [build_scene(soup)]
    n_inst = 5
    tf = np.zeros((n_inst, 3, 4), np.float32)
    for i in range(n_inst):
        tf[i, :, :3] = np.eye(3, dtype=np.float32) * 0.6
        tf[i, :, 3] = rng.random(3).astype(np.float32) * 4 - 2
    iscene = build_instanced(blas, np.zeros(n_inst, np.int64), tf)
    pscene = pack_instanced(iscene)

    rays = Rays.make(rng.normal(size=(300, 3)).astype(np.float32) * 3.0,
                     rng.normal(size=(300, 3)).astype(np.float32))
    mesh = default_mesh(jax.devices()[:8])
    got, gi = trace_instanced_sharded(pscene, rays, mesh, interpret=True,
                                      max_candidates=3)
    want, wi = trace_closest_instanced_packets(pscene, rays,
                                               max_candidates=3,
                                               interpret=True)
    np.testing.assert_array_equal(np.asarray(got.hit), np.asarray(want.hit))
    np.testing.assert_allclose(np.asarray(got.t), np.asarray(want.t),
                               rtol=1e-6, atol=1e-6)
    hit = np.asarray(want.hit)
    np.testing.assert_array_equal(np.asarray(gi)[hit], np.asarray(wi)[hit])
