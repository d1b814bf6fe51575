"""Shared scene x mode x leaf-size cases for the traversal-kernel matrix
(tests/test_kernel_lbvh.py, tests/test_kernel_sah.py): the kernel in
Pallas interpret mode against the float64 brute-force oracle and the XLA
stack engine."""
import numpy as np

from rtk_tpu import BuildConfig, Rays, build_scene
from rtk_tpu.oracle import trace_brute
from rtk_tpu.ops.pallas_trace import trace_packets
from rtk_tpu.testing import scenes
from rtk_tpu.trace import stack
from rtk_tpu.trace.packed import pack_scene

SCENES = ("cornell", "blob", "deforming_grid", "degenerate_soup")
MODES = ("closest", "any")
LEAF_SIZES = (4, 8, 16)


def scene_and_rays(name):
    rng = np.random.default_rng(SCENES.index(name))
    if name == "cornell":
        return scenes.cornell_box(), scenes.cornell_camera(16, 16)
    if name == "blob":
        return (scenes.blob(subdivisions=2)[0],
                scenes.camera_rays((0, 0, 3.0), (0, 0, 0), (0, 1, 0), 45,
                                   16, 16))
    if name == "deforming_grid":
        return (scenes.deforming_grid(0.6, n=12),
                scenes.camera_rays((0, 3, 4), (0, 0, 0), (0, 1, 0), 50,
                                   16, 16))
    # Degenerate soup: random triangles plus zero-area, needle and
    # duplicated ones, traced by scattered rays.
    tris = rng.normal(size=(160, 3, 3)).astype(np.float32)
    tris[:20, 1] = tris[:20, 0]  # zero-area (two equal vertices)
    tris[20:40, 2] = tris[20:40, 0] + 1e-7  # needles
    tris[40:60] = tris[60:80]  # exact duplicates
    rays = Rays.make(rng.normal(size=(256, 3)).astype(np.float32) * 3.0,
                     rng.normal(size=(256, 3)).astype(np.float32))
    return tris, rays


def packed_for(tris, leaf_size, topology):
    cfg = BuildConfig(leaf_size=leaf_size)
    soup = (tris.reshape(-1, 3), np.arange(tris.shape[0] * 3).reshape(-1, 3))
    scene = build_scene(soup, cfg)
    if topology == "lbvh":
        return scene, pack_scene(scene)
    from rtk_tpu.builder.sah import build_sah_packed

    return scene, build_sah_packed(soup, cfg)


def check_case(name, mode, leaf_size, topology):
    tris, rays = scene_and_rays(name)
    scene, packed = packed_for(tris, leaf_size, topology)
    got = trace_packets(packed, rays, mode=mode, interpret=True)
    assert not np.asarray(got.overflow).any()
    gh = np.asarray(got.hit)

    # XLA stack engine over the same geometry: identical hit masks (the
    # two share the watertight test and its rounding); closest t equal.
    fn = stack.trace_closest if mode == "closest" else stack.trace_any
    want = fn(scene, rays)
    np.testing.assert_array_equal(gh, np.asarray(want.hit))
    if mode == "closest":
        np.testing.assert_allclose(np.asarray(got.t)[gh],
                                   np.asarray(want.t)[gh], rtol=1e-6)

    # f64 oracle: hit masks agree except at edge grazes; t within f32
    # rounding where both hit; any-hit t is some hit at or beyond the
    # nearest.
    ref = trace_brute(tris, rays)
    rh = np.asarray(ref.hit)
    assert (gh != rh).mean() <= 0.01, (name, int((gh != rh).sum()))
    both = gh & rh
    gt, rt = np.asarray(got.t)[both], np.asarray(ref.t)[both]
    if mode == "closest":
        np.testing.assert_allclose(gt, rt, rtol=1e-4, atol=1e-5)
    else:
        assert (gt >= rt * (1 - 1e-4) - 1e-5).all()
    # records point at a real triangle that the ray hits at t
    slot = np.asarray(got.slot)[gh]
    assert (slot >= 0).all()
    assert (np.asarray(got.triangle_index)[gh] >= 0).all()
