"""Traversal-kernel plumbing on the CPU: per-ray roots, stack-overflow
reporting, launch geometry, batch sizes, and the one backend decision."""
import numpy as np
import pytest

from rtk_tpu import BuildConfig, Rays, Tracer, build_scene
from rtk_tpu.ops import pallas_trace as pt
from rtk_tpu.testing import scenes
from rtk_tpu.trace.packed import pack_forest, pack_scene
from rtk_tpu.tracer import GPU_ENGINE, resolve_engine


def _soup(tris):
    return (tris.reshape(-1, 3), np.arange(tris.shape[0] * 3).reshape(-1, 3))


def _blob_scene():
    return build_scene(_soup(scenes.blob(subdivisions=2)[0]))


def _rays(n=256):
    return scenes.camera_rays((0, 0, 3.0), (0, 0, 0), (0, 1, 0), 45, 16,
                              n // 16)


def test_per_ray_roots_select_each_blas():
    """Per-ray start roots over a two-BLAS forest: each ray sees exactly
    the BLAS its root names (the instanced rounds' contract)."""
    from rtk_tpu.instancing import merge_blas

    a = build_scene(_soup(scenes.blob(subdivisions=2)[0]))
    b = build_scene(_soup(scenes.box([-2, -2, -2], [2, 2, 2])))
    merged, roots = merge_blas([a, b])
    packed, proots = pack_forest(merged, roots)
    rays = _rays()
    n = rays.count
    which = np.arange(n) % 2
    got = pt.trace_packets(packed, rays, roots=np.asarray(proots)[which],
                           interpret=True)
    ref_a = pt.trace_packets(pack_scene(a), rays, interpret=True)
    ref_b = pt.trace_packets(pack_scene(b), rays, interpret=True)
    for blas, ref in ((0, ref_a), (1, ref_b)):
        m = which == blas
        np.testing.assert_array_equal(np.asarray(got.hit)[m],
                                      np.asarray(ref.hit)[m])
        np.testing.assert_array_equal(np.asarray(got.t)[m],
                                      np.asarray(ref.t)[m])
    with pytest.raises(ValueError, match="roots"):
        pt.trace_packets(packed, rays, roots=proots, interpret=True)


def _trace_with_stack(packed, rays, max_stack):
    """The kernel with a given stack depth (the public entry points all
    use MAX_STACK)."""
    n = rays.count
    return pt._trace_impl(
        packed, rays.origin, rays.direction, rays.min_t, rays.max_t,
        np.zeros((n,), np.int32), None, mode="closest", watertight=True,
        interpret=True, sort_rays=False, use_mask=False, stats=False,
        filter_fn=None, defer_uv=False, max_stack=max_stack,
        programs=pt.INTERPRET_PROGRAMS)


def test_stack_overflow_is_reported():
    """A stack too shallow for the tree flags the rays that overflowed;
    a deep enough one flags none and matches the default."""
    tris = scenes.blob(subdivisions=3)[0]
    packed = pack_scene(build_scene(_soup(tris), BuildConfig(leaf_size=1)))
    rays = _rays()
    tiny = _trace_with_stack(packed, rays, 2)
    assert np.asarray(tiny.overflow).any()
    ok = _trace_with_stack(packed, rays, pt.MAX_STACK)
    assert not np.asarray(ok.overflow).any()
    default = pt.trace_packets(packed, rays, interpret=True)
    np.testing.assert_array_equal(np.asarray(ok.t), np.asarray(default.t))
    # slicing keeps the flag aligned with the rays
    assert tiny[:7].overflow.shape == (7,)


H100_PROGRAMS = 132 * pt.PROGRAMS_PER_SM  # an H100 SXM has 132 SMs


@pytest.mark.parametrize("n,programs", [
    (1, pt.INTERPRET_PROGRAMS), (1000, pt.INTERPRET_PROGRAMS),
    (100_000, H100_PROGRAMS), (70_000_000, H100_PROGRAMS)])
def test_launch_geometry_covers_batch(n, programs):
    nprog, per, npad = pt.launch_geometry(n, programs)
    assert npad == nprog * per * pt.BLOCK
    assert npad >= n
    # padding is less than one tile per program
    assert npad - n < nprog * pt.BLOCK
    # persistent grid: stack memory is bounded by the programs, not n
    assert nprog <= programs


def test_grid_needs_the_device_sm_count():
    """The compiled grid is sized from the device's SM count; a device
    that reports none (here the CPU) is an error, not a guess."""
    assert pt.grid_programs(interpret=True) == pt.INTERPRET_PROGRAMS
    with pytest.raises(RuntimeError, match="SM count"):
        pt.grid_programs(interpret=False)
    # lowering for a named card needs no local one
    with pt.target_sm_count(132):
        assert pt.grid_programs(interpret=False) == H100_PROGRAMS
    with pytest.raises(RuntimeError, match="SM count"):
        pt.grid_programs(interpret=False)


@pytest.mark.parametrize("n", [1, 33, 200, 700])
def test_ray_counts_across_tiles_and_programs(n):
    """Batches that fill part of a tile, several tiles per program, and a
    padded last tile all match the XLA stack engine."""
    from rtk_tpu.trace.stack import trace_closest

    scene = _blob_scene()
    rng = np.random.default_rng(n)
    rays = Rays.make(rng.normal(size=(n, 3)).astype(np.float32) * 0.2
                     + np.float32([0, 0, 3]),
                     rng.normal(size=(n, 3)).astype(np.float32)
                     * np.float32([0.3, 0.3, 1]) - np.float32([0, 0, 1]))
    got = pt.trace_packets(pack_scene(scene), rays, interpret=True)
    want = trace_closest(scene, rays)
    np.testing.assert_array_equal(np.asarray(got.hit), np.asarray(want.hit))
    h = np.asarray(want.hit)
    np.testing.assert_allclose(np.asarray(got.t)[h], np.asarray(want.t)[h],
                               rtol=1e-6)


def test_unknown_mode_is_rejected():
    packed = pack_scene(_blob_scene())
    with pytest.raises(ValueError, match="mode"):
        pt.trace_packets(packed, _rays(), mode="nearest", interpret=True)


@pytest.mark.parametrize("platform,want", [
    ("gpu", GPU_ENGINE), ("cpu", "stack"), ("metal", None), ("rocm", None)])
def test_resolve_engine_by_platform(platform, want):
    if want is None:
        with pytest.raises(ValueError, match="platform"):
            resolve_engine("auto", platform)
    else:
        assert resolve_engine("auto", platform) == want
    # an explicit engine is never overridden
    assert resolve_engine("stack", platform) == "stack"
    with pytest.raises(ValueError, match="unknown engine"):
        resolve_engine("grid", platform)


def test_interpreter_is_never_chosen_implicitly():
    """On the CPU, auto picks the XLA engine; the kernel engine stays
    compiled unless the caller asks for the interpreter, so it cannot run
    here without interpret=True."""
    scene = _blob_scene()
    assert Tracer(scene).engine == "stack"
    tr = Tracer(scene, engine="packet")
    assert tr.interpret is False
    with pytest.raises(Exception):
        np.asarray(tr.closest(_rays()).t)
    hits = Tracer(scene, engine="packet", interpret=True).closest(_rays())
    assert np.asarray(hits.hit).any()
