"""AOT program export (utils/aot.py): serialize the compiled packet-trace
program, reload, and get bit-identical results with no Python retracing.

The data half of the serving story (scene blobs) is tests/test_serialize;
this covers the program half — together they mirror the reference's
"the blob is the runtime format" design (rtk.h:78-89) at the level a GPU
deployment needs it: shapes pinned, tables as arguments, StableHLO on
disk.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from rtk_tpu import BuildConfig
from rtk_tpu.ops.pallas_trace import trace_packets
from rtk_tpu.scene import build_from_soup
from rtk_tpu.testing import scenes
from rtk_tpu.trace.packed import pack_scene
from rtk_tpu.utils.aot import export_packet_trace, load_packet_trace


def _packed(leaf_size=8):
    tris = scenes.cornell_box()
    return pack_scene(build_from_soup(
        jnp.asarray(tris),
        config=BuildConfig(branching=8, leaf_size=leaf_size)))


def test_aot_roundtrip_matches_direct():
    packed = _packed()
    rays = scenes.cornell_camera(32, 32)
    blob = export_packet_trace(packed, rays.count, interpret=True)
    lt = load_packet_trace(blob)
    assert lt.n_rays == rays.count
    got = lt(packed, rays)
    ref = trace_packets(packed, rays, interpret=True)
    np.testing.assert_array_equal(np.asarray(got.hit), np.asarray(ref.hit))
    np.testing.assert_array_equal(np.asarray(got.t), np.asarray(ref.t))
    # Lazy hit assembly works off the caller's packed tables.
    np.testing.assert_array_equal(np.asarray(got.triangle_index),
                                  np.asarray(ref.triangle_index))


def test_aot_artifact_serves_refit_tables():
    """One artifact serves any scene with the same table shapes: trace a
    DEFORMED rebuild of the same topology through an artifact exported
    for the original (the refit-sequence serving pattern)."""
    rng = np.random.default_rng(3)
    base = scenes.cornell_box()
    packed0 = pack_scene(build_from_soup(
        jnp.asarray(base), config=BuildConfig(branching=8, leaf_size=8)))
    jig = base + rng.normal(scale=1e-3, size=base.shape).astype(np.float32)
    packed1 = pack_scene(build_from_soup(
        jnp.asarray(jig), config=BuildConfig(branching=8, leaf_size=8)))
    assert packed1.nodes.shape == packed0.nodes.shape
    rays = scenes.cornell_camera(16, 16)
    lt = load_packet_trace(
        export_packet_trace(packed0, rays.count, interpret=True))
    got = lt(packed1, rays)
    ref = trace_packets(packed1, rays, interpret=True)
    np.testing.assert_array_equal(np.asarray(got.t), np.asarray(ref.t))


def test_aot_refit_trace_roundtrip():
    """export_refit_trace: one artifact animates a deforming mesh — per
    frame one call (refit+repack+trace fused), hit records interpolate the
    DEFORMED geometry via the returned vertex table."""
    from rtk_tpu.scene import build_from_soup as _b
    from rtk_tpu.ops.pallas_trace import trace_packets_refit
    from rtk_tpu.utils.aot import export_refit_trace, load_refit_trace

    grid0 = scenes.deforming_grid(0.0, n=8)  # 128 tris
    scene = _b(jnp.asarray(grid0), config=BuildConfig(branching=8,
                                                      leaf_size=8))
    packed = pack_scene(scene)
    rays = scenes.camera_rays((0, 3, 4), (0, 0, 0), (0, 1, 0), 50, 16, 16)
    lt = load_refit_trace(export_refit_trace(
        packed, scene, rays.count, interpret=True))
    for tphase in (0.2, 0.5):
        frame = jnp.asarray(scenes.deforming_grid(tphase, n=8))
        got = lt(packed, frame, rays)
        ref, _, rp = trace_packets_refit(packed, scene, frame, rays,
                                         interpret=True)
        np.testing.assert_array_equal(np.asarray(got.hit),
                                      np.asarray(ref.hit))
        np.testing.assert_array_equal(np.asarray(got.t), np.asarray(ref.t))
        # the artifact's vertex table is the frame's repacked (deformed) one
        np.testing.assert_array_equal(np.asarray(got.tri_v),
                                      np.asarray(rp.tri_v))


def test_aot_tpu_cross_lowering_serializes():
    """A CUDA-lowered artifact (the compiled Triton kernel) exports from a
    CPU host (deployment: export in CI, run on the serving GPU).  Calling
    it needs a GPU, so this only checks the artifact round-trips the
    serializer and carries the kernel.  The host has no card to size the
    kernel's grid from, so the export names the target's SM count."""
    packed = _packed()
    with pytest.raises(RuntimeError, match="SM count"):
        export_packet_trace(packed, 1024, platforms=["cuda"])
    blob = export_packet_trace(packed, 1024, platforms=["cuda"],
                               sm_count=132)
    lt = load_packet_trace(blob)
    assert lt.n_rays == 1024
    assert lt._exported.platforms == ("cuda",)
