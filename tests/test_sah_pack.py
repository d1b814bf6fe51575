"""pack_binary_tree: arbitrary host-built binary BVHs (here the
corrected-rtk C++ oracle's binned SAH, NativeOracle.export_tree) through
the packet kernel — must match the LBVH pack bit-tolerantly (same kernel,
different topology; rtk.c:390-539 semantics are topology-independent)."""
import numpy as np
import pytest

from rtk_tpu.config import BuildConfig
from rtk_tpu.ops.pallas_trace import trace_packets
from rtk_tpu.scene import build_from_soup
from rtk_tpu.testing import scenes
from rtk_tpu.trace.packed import pack_binary_tree, pack_scene
from rtk_tpu.types import Rays


@pytest.fixture(scope="module")
def pair():
    try:
        from rtk_tpu.testing.native_oracle import NativeOracle
    except Exception as e:  # pragma: no cover - no toolchain
        pytest.skip(f"native oracle unavailable: {e}")
    tris = scenes.blob(subdivisions=3)[0]
    cfg = BuildConfig(branching=8, leaf_size=8)
    flat = pack_scene(build_from_soup(tris, config=cfg))
    orc = NativeOracle(tris.reshape(-1, 9), leaf_max=8)
    sah = pack_binary_tree(tris, *orc.export_tree(), leaf_size=8)
    return flat, sah


def _parity(got, ref):
    np.testing.assert_array_equal(np.asarray(got.hit), np.asarray(ref.hit))
    np.testing.assert_allclose(np.asarray(got.t), np.asarray(ref.t),
                               rtol=1e-6, atol=1e-6)
    diff = np.asarray(got.triangle_index) != np.asarray(ref.triangle_index)
    if diff.any():  # exact-t ties may resolve differently across topologies
        dt = np.abs(np.asarray(got.t)[diff] - np.asarray(ref.t)[diff])
        assert dt.max() == 0.0


def test_sah_topology_matches_lbvh(pair):
    flat, sah = pair
    rng = np.random.default_rng(21)
    rays = Rays.make(rng.normal(size=(512, 3)).astype(np.float32) * 0.5,
                     rng.normal(size=(512, 3)).astype(np.float32))
    _parity(trace_packets(sah, rays, interpret=True),
            trace_packets(flat, rays, interpret=True))


def test_sah_topology_any_and_records(pair):
    flat, sah = pair
    cam = scenes.camera_rays((0, 2.5, 3.5), (0, 0, 0), (0, 1, 0), 55,
                             48, 48, order="morton")
    _parity(trace_packets(sah, cam, interpret=True),
            trace_packets(flat, cam, interpret=True))
    ga = trace_packets(sah, cam, interpret=True, mode="any")
    ra = trace_packets(flat, cam, interpret=True, mode="any")
    np.testing.assert_array_equal(np.asarray(ga.hit), np.asarray(ra.hit))
    hit = np.asarray(ga.hit)
    assert (np.asarray(ga.triangle_index)[hit] >= 0).all()


def test_sah_refit_matches_lbvh_of_frame():
    """refit_packed_binary: host-SAH topology refit ON DEVICE to deformed
    vertices must trace the deformed geometry identically to a fresh
    LBVH build of the same frame (modulo exact-t ties) — both in
    step-quantized and classic SAH (in-place partition contiguity must
    hold for the refit aux in both builders)."""
    import rtk_tpu
    from rtk_tpu.trace.packed import refit_packed_binary

    g0 = np.asarray(scenes.deforming_grid(0.0, n=24))
    frame = np.asarray(scenes.deforming_grid(0.3, n=24))
    cam = scenes.camera_rays((0, 3, 4), (0, 0, 0), (0, 1, 0), 50, 32, 32)
    ref = trace_packets(
        pack_scene(build_from_soup(
            frame, config=BuildConfig(branching=8, leaf_size=8))),
        cam, interpret=True)
    for sq in (False, True):
        sah, aux = rtk_tpu.build_sah_packed(
            (g0.reshape(-1, 3), np.arange(g0.shape[0] * 3).reshape(-1, 3)),
            BuildConfig(leaf_size=8), step_quant=sq, refittable=True)
        refitted = refit_packed_binary(sah, aux, frame)
        _parity(trace_packets(refitted, cam, interpret=True), ref)
        # vertex records must reflect the deformed frame
        got = trace_packets(refitted, cam, interpret=True)
        hit = np.asarray(got.hit)
        np.testing.assert_allclose(
            np.asarray(got.position())[hit],
            np.asarray(ref.position())[hit], rtol=1e-6, atol=1e-6)


def test_sah_refit_fused_and_frames_paths():
    """trace_packets_refit / trace_packets_refit_frames accept a
    BinaryRefitAux in place of a Scene and match the manual
    refit_packed_binary + trace pipeline frame by frame."""
    import jax.numpy as jnp

    import rtk_tpu
    from rtk_tpu.ops.pallas_trace import (trace_packets_refit,
                                          trace_packets_refit_frames)
    from rtk_tpu.trace.packed import refit_packed_binary

    g0 = np.asarray(scenes.deforming_grid(0.0, n=24))
    sah, aux = rtk_tpu.build_sah_packed(
        (g0.reshape(-1, 3), np.arange(g0.shape[0] * 3).reshape(-1, 3)),
        BuildConfig(leaf_size=8), step_quant=True, refittable=True)
    cam = scenes.camera_rays((0, 3, 4), (0, 0, 0), (0, 1, 0), 50, 24, 24)
    ts = (0.1, 0.25, 0.4)
    for t in ts:
        frame = jnp.asarray(scenes.deforming_grid(t, n=24))
        got, aux2, packed2 = trace_packets_refit(sah, aux, frame, cam,
                                                 interpret=True)
        want = trace_packets(refit_packed_binary(sah, aux, frame), cam,
                             interpret=True)
        np.testing.assert_array_equal(np.asarray(got.hit),
                                      np.asarray(want.hit))
        np.testing.assert_array_equal(np.asarray(got.t), np.asarray(want.t))
        np.testing.assert_array_equal(np.asarray(got.slot),
                                      np.asarray(want.slot))
    frames = jnp.stack([jnp.asarray(scenes.deforming_grid(t, n=24))
                        for t in ts])
    got = trace_packets_refit_frames(sah, aux, frames, cam, interpret=True,
                                     sort_rays=True)
    assert len(got) == len(ts)
    for f, t in enumerate(ts):
        want = trace_packets(
            refit_packed_binary(sah, aux,
                                jnp.asarray(scenes.deforming_grid(t, n=24))),
            cam, interpret=True, sort_rays=True)
        np.testing.assert_array_equal(np.asarray(got[f].hit),
                                      np.asarray(want.hit))
        np.testing.assert_array_equal(np.asarray(got[f].t),
                                      np.asarray(want.t))
        np.testing.assert_array_equal(np.asarray(got[f].u),
                                      np.asarray(want.u))


def test_refit_trace_perf_flags_parity():
    """defer_uv and the hoisted coherence sort plumbed through the refit
    executors must keep hit/t bit-parity with the default path (they
    are scheduling/laziness knobs, not semantics)."""
    import jax.numpy as jnp

    import rtk_tpu
    from rtk_tpu.ops.pallas_trace import (trace_packets_refit,
                                          trace_packets_refit_frames)

    g0 = np.asarray(scenes.deforming_grid(0.0, n=16))
    sah, aux = rtk_tpu.build_sah_packed(
        (g0.reshape(-1, 3), np.arange(g0.shape[0] * 3).reshape(-1, 3)),
        BuildConfig(leaf_size=8), step_quant=True, refittable=True)
    cam = scenes.camera_rays((0, 3, 4), (0, 0, 0), (0, 1, 0), 50, 16, 16)
    frames = jnp.stack([jnp.asarray(scenes.deforming_grid(t, n=16))
                        for t in (0.1, 0.3)])
    base = trace_packets_refit_frames(sah, aux, frames, cam, interpret=True)
    flag = trace_packets_refit_frames(sah, aux, frames, cam, interpret=True,
                                      defer_uv=True, sort_rays=True)
    for f in range(2):
        np.testing.assert_array_equal(np.asarray(base[f].hit),
                                      np.asarray(flag[f].hit))
        np.testing.assert_array_equal(np.asarray(base[f].t),
                                      np.asarray(flag[f].t))
        # defer_uv: lazy recompute, equal up to rounding
        np.testing.assert_allclose(np.asarray(base[f].u),
                                   np.asarray(flag[f].u), atol=5e-5)
    h1, _, _ = trace_packets_refit(sah, aux, np.asarray(frames[1]), cam,
                                   interpret=True, defer_uv=True)
    np.testing.assert_array_equal(np.asarray(h1.hit),
                                  np.asarray(base[1].hit))
    np.testing.assert_array_equal(np.asarray(h1.t), np.asarray(base[1].t))


def test_build_sah_packed_public_surface():
    """build_sah_packed accepts build_scene-style mesh input and traces
    identically to the LBVH path (modulo exact-t ties)."""
    import rtk_tpu

    tris = scenes.blob(subdivisions=3)[0]
    t = tris.shape[0]
    meshes = (tris.reshape(-1, 3), np.arange(t * 3).reshape(-1, 3))
    sah = rtk_tpu.build_sah_packed(meshes, BuildConfig(leaf_size=8))
    flat = pack_scene(build_from_soup(
        tris, config=BuildConfig(branching=8, leaf_size=8)))
    cam = scenes.camera_rays((0, 0, 3.0), (0, 0, 0), (0, 1, 0), 45, 24, 24)
    _parity(trace_packets(sah, cam, interpret=True),
            trace_packets(flat, cam, interpret=True))
