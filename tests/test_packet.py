"""Traversal kernel vs the XLA stack tracer (Pallas interpret mode on CPU)."""
import pytest
import numpy as np

from rtk_tpu import BuildConfig, Rays, build_scene, refit, trace_any, trace_closest
from rtk_tpu.ops.pallas_trace import trace_packets
from rtk_tpu.trace.packed import pack_scene, repack_bounds
from rtk_tpu.testing import scenes


def _soup_of(tris):
    t = tris.shape[0]
    return (tris.reshape(-1, 3), np.arange(t * 3).reshape(-1, 3))


def _check(scene, rays, atol=1e-5, same_frac=0.9):
    packed = pack_scene(scene)
    want = trace_closest(scene, rays)
    got = trace_packets(packed, rays, interpret=True)
    wh = np.asarray(want.hit)
    np.testing.assert_array_equal(np.asarray(got.hit), wh)
    np.testing.assert_allclose(
        np.asarray(got.t)[wh], np.asarray(want.t)[wh], atol=atol)
    same = wh & (np.asarray(got.triangle_index)
                 == np.asarray(want.triangle_index))
    # Ties on shared edges may pick either adjacent primitive (t already
    # verified equal above); small images have proportionally more edges.
    assert same.sum() / max(wh.sum(), 1) > same_frac
    for a, b in ((got.u, want.u), (got.v, want.v)):
        np.testing.assert_allclose(
            np.asarray(a)[same], np.asarray(b)[same], atol=1e-3)
    return packed, got


def test_pack_structure():
    tris = scenes.cornell_box()
    scene = build_scene(_soup_of(tris))
    packed = pack_scene(scene)
    meta = np.asarray(packed.meta)
    # Node 0 is the root; first_child of the root must be 1.
    assert meta[0, 0] == 1
    # Every leaf assigned exactly once: leaf ids 0..L-1 seen once in
    # ascending first_leaf blocks.
    n_leaf = scene.num_leaves
    im = meta[:, 2] & 0xFF
    lm = (meta[:, 2] >> 8) & 0xFF
    total_leaves = sum(bin(int(x)).count("1") for x in lm)
    assert total_leaves == n_leaf
    total_children = sum(bin(int(x)).count("1") for x in im)
    assert total_children == meta.shape[0] - 1  # all non-root nodes


@pytest.mark.smoke
def test_packet_cornell():
    tris = scenes.cornell_box()
    scene = build_scene(_soup_of(tris))
    _, got = _check(scene, scenes.cornell_camera(32, 32))
    assert np.asarray(got.hit).all()


def test_packet_random_soup():
    rng = np.random.default_rng(5)
    tris = rng.normal(size=(300, 3, 3)).astype(np.float32)
    scene = build_scene(_soup_of(tris))
    rays = Rays.make(rng.normal(size=(512, 3)).astype(np.float32) * 3.0,
                     rng.normal(size=(512, 3)).astype(np.float32))
    _check(scene, rays)


def test_packet_leaf_sizes():
    tris = scenes.cornell_box()
    rays = scenes.cornell_camera(16, 16)
    for leaf in (1, 4, 8):
        scene = build_scene(_soup_of(tris), BuildConfig(leaf_size=leaf))
        _check(scene, rays)


def test_packet_anyhit():
    tris = scenes.cornell_box()
    scene = build_scene(_soup_of(tris))
    packed = pack_scene(scene)
    rays = scenes.cornell_camera(16, 16)
    closest = trace_closest(scene, rays)
    got = trace_packets(packed, rays, mode="any", interpret=True)
    np.testing.assert_array_equal(np.asarray(got.hit), np.asarray(closest.hit))
    h = np.asarray(got.hit)
    # any-hit t can never beat closest-hit t (relative tolerance: the two
    # engines may associate the shear-space arithmetic differently)
    ct = np.asarray(closest.t)[h]
    assert (np.asarray(got.t)[h] >= ct - 1e-5 * (1.0 + np.abs(ct))).all()


def test_packet_t_window():
    tri = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], np.float32)
    scene = build_scene(_soup_of(tri))
    packed = pack_scene(scene)
    rays = Rays.make([0.2, 0.2, 1.0], [0.0, 0.0, -1.0], min_t=1.5)
    assert not bool(trace_packets(packed, rays, interpret=True).hit[0])
    rays = Rays.make([0.2, 0.2, 1.0], [0.0, 0.0, -1.0], max_t=0.5)
    assert not bool(trace_packets(packed, rays, interpret=True).hit[0])
    rays = Rays.make([0.2, 0.2, 1.0], [0.0, 0.0, -1.0])
    h = trace_packets(packed, rays, interpret=True)
    assert bool(h.hit[0]) and abs(float(h.t[0]) - 1.0) < 1e-6


def test_packet_refit_repack():
    t0 = scenes.deforming_grid(0.0, n=16)
    t1 = scenes.deforming_grid(0.9, n=16)
    scene = build_scene(_soup_of(t0))
    packed = pack_scene(scene)
    scene2 = refit(scene, t1)
    packed2 = repack_bounds(packed, scene2)
    rays = scenes.camera_rays((0, 3, 4), (0, 0, 0), (0, 1, 0), 50, 16, 16)
    want = trace_closest(scene2, rays)
    got = trace_packets(packed2, rays, interpret=True)
    np.testing.assert_array_equal(np.asarray(got.hit), np.asarray(want.hit))
    wh = np.asarray(want.hit)
    np.testing.assert_allclose(
        np.asarray(got.t)[wh], np.asarray(want.t)[wh], atol=1e-5)


def test_packet_chunked_matches():
    """trace_packets_chunked (bounded-memory host loop over chunk-ray
    slices, dead-ray padded final slice) must be bit-identical to the
    single-dispatch trace, including mesh/triangle record access through
    the shared tables."""
    from rtk_tpu.ops.pallas_trace import trace_packets_chunked

    rng = np.random.default_rng(31)
    tris = rng.normal(size=(300, 3, 3)).astype(np.float32)
    scene = build_scene(_soup_of(tris), BuildConfig(leaf_size=8))
    packed = pack_scene(scene)
    # 700 rays over chunk=256: two full slices + one padded partial.
    rays = Rays.make(rng.normal(size=(700, 3)).astype(np.float32) * 3.0,
                     rng.normal(size=(700, 3)).astype(np.float32))
    a = trace_packets(packed, rays, interpret=True)
    b = trace_packets_chunked(packed, rays, chunk=256, interpret=True)
    assert b.count == rays.count
    np.testing.assert_array_equal(np.asarray(a.hit), np.asarray(b.hit))
    np.testing.assert_array_equal(np.asarray(a.t), np.asarray(b.t))
    np.testing.assert_array_equal(np.asarray(a.triangle_index),
                                  np.asarray(b.triangle_index))
    np.testing.assert_array_equal(np.asarray(a.mesh_index),
                                  np.asarray(b.mesh_index))
    # n <= chunk short-circuits to the plain path
    c = trace_packets_chunked(packed, rays, chunk=4096, interpret=True)
    np.testing.assert_array_equal(np.asarray(a.t), np.asarray(c.t))


def test_packet_hits_lazy_surface():
    """PacketHits: lazy fields match the eager assembly, slicing works."""
    tris = scenes.blob(subdivisions=3)[0]
    rays = scenes.camera_rays((0, 0, 3.0), (0, 0, 0), (0, 1, 0), 45, 16, 16)
    scene = build_scene(_soup_of(tris))
    packed = pack_scene(scene)
    got = trace_packets(packed, rays, interpret=True)
    full = got.full()
    np.testing.assert_array_equal(np.asarray(got.mesh_index),
                                  np.asarray(full.mesh_index))
    np.testing.assert_array_equal(np.asarray(got.vertex_index),
                                  np.asarray(full.vertex_index))
    np.testing.assert_allclose(np.asarray(got.w),
                               1.0 - np.asarray(got.u) - np.asarray(got.v))
    # position(): o + t*d must equal barycentric interpolation of the hit
    # triangle's vertices (same watertight t)
    h = np.asarray(got.hit)
    p_ray = np.asarray(got.position())[h]
    p_bary = np.asarray(full.position())[h]
    np.testing.assert_allclose(p_ray, p_bary, atol=5e-3)
    # slicing keeps the tables intact
    sub = got[:7]
    assert sub.count == 7
    assert sub.tri_v.shape == got.tri_v.shape
    np.testing.assert_array_equal(np.asarray(sub.triangle_index),
                                  np.asarray(full.triangle_index)[:7])


def test_packet_watertight_closed_mesh():
    """Watertightness through the FULL packet engine (BVH + kernel): rays
    from inside a closed icosphere aimed at every edge midpoint, vertex,
    and random edge points must all hit (the property rtk's f64 fallback
    exists to guarantee, rtk.c:294-336)."""
    from rtk_tpu.testing.scenes import icosphere

    verts, faces = icosphere(2)  # 320 tris, closed
    tris = verts[faces].astype(np.float32)
    scene = build_scene(_soup_of(tris))
    packed = pack_scene(scene)

    rng = np.random.default_rng(7)
    edges = np.concatenate(
        [faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]], axis=0)
    lam = rng.uniform(0.0, 1.0, size=(edges.shape[0], 1)).astype(np.float32)
    edge_pts = verts[edges[:, 0]] * (1 - lam) + verts[edges[:, 1]] * lam
    mids = (verts[edges[:, 0]] + verts[edges[:, 1]]) * 0.5
    targets = np.concatenate([mids, edge_pts, verts], axis=0)

    rays = Rays.make(np.zeros_like(targets), targets)  # inside, aimed out
    got = trace_packets(packed, rays, interpret=True)
    leaks = int((~np.asarray(got.hit)).sum())
    assert leaks == 0, f"{leaks}/{rays.count} edge/vertex rays leaked"
    # any-hit must agree (occlusion can never leak either)
    occ = trace_packets(packed, rays, mode="any", interpret=True)
    assert int((~np.asarray(occ.hit)).sum()) == 0


def test_packet_filter_mask_matches_stack_filter():
    """Built-in filter family on the packet fast path (VERDICT r1 item 7):
    (tri_mask & query_mask) != 0 in the leaf phase must agree with an
    equivalent filter callable on the XLA stack engine (rtk.h:117,130)."""
    from rtk_tpu.config import TraceConfig
    from rtk_tpu.trace import stack as _stack

    tris = scenes.blob(subdivisions=3)[0]
    t = tris.shape[0]
    scene = build_scene(_soup_of(tris))
    tri_mask = np.where(np.arange(t) % 2 == 1, 1, 2).astype(np.uint32)
    packed = pack_scene(scene, tri_mask=tri_mask)

    rays = scenes.camera_rays((0, 0, 3.0), (0, 0, 0), (0, 1, 0), 45, 16, 16)
    ref = trace_packets(packed, rays, interpret=True)
    h_all = trace_packets(packed, rays, interpret=True, filter_mask=3)
    np.testing.assert_array_equal(np.asarray(h_all.hit), np.asarray(ref.hit))
    np.testing.assert_array_equal(np.asarray(h_all.t), np.asarray(ref.t))

    h_odd = trace_packets(packed, rays, interpret=True, filter_mask=1)
    hs = _stack.trace_closest(
        scene, rays, filter_fn=lambda cand: cand.triangle_index % 2 == 1,
        config=TraceConfig())
    np.testing.assert_array_equal(np.asarray(h_odd.hit), np.asarray(hs.hit))
    np.testing.assert_allclose(np.asarray(h_odd.t), np.asarray(hs.t),
                               rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(h_odd.triangle_index),
                                  np.asarray(hs.triangle_index))
    # any-hit respects the mask too
    occ = trace_packets(packed, rays, interpret=True, mode="any",
                        filter_mask=1)
    oc = np.asarray(occ.hit)
    ti = np.asarray(occ.triangle_index)
    assert (ti[oc] % 2 == 1).all()
    # refit keeps the mask column
    from rtk_tpu import refit
    from rtk_tpu.trace.packed import repack_bounds

    scene2 = refit(scene, tris + np.float32(0.01))
    packed2 = repack_bounds(packed, scene2)
    h2 = trace_packets(packed2, rays, interpret=True, filter_mask=1)
    assert (np.asarray(h2.triangle_index)[np.asarray(h2.hit)] % 2 == 1).all()


@pytest.mark.smoke
def test_packet_filter_callable_matches_stack():
    """User filter callables IN the packet kernel's leaf phase (VERDICT r2
    item 7, rtk_filter_fn intent rtk.h:117,130): a jax-traceable predicate
    over (mesh, prim, t, u, v, ray) must match the same callable on the
    XLA stack engine — at packet-engine candidate shapes."""
    from rtk_tpu.config import TraceConfig
    from rtk_tpu.trace import stack as _stack

    tris = scenes.blob(subdivisions=3)[0]
    scene = build_scene(_soup_of(tris))
    packed = pack_scene(scene)
    rays = scenes.camera_rays((0, 0, 3.0), (0, 0, 0), (0, 1, 0), 45, 16, 16)

    flt = lambda cand: (cand.triangle_index % 3 == 1) & (cand.t > 2.0)
    got = trace_packets(packed, rays, interpret=True, filter_fn=flt)
    want = _stack.trace_closest(scene, rays, filter_fn=flt,
                                config=TraceConfig())
    np.testing.assert_array_equal(np.asarray(got.hit), np.asarray(want.hit))
    np.testing.assert_allclose(np.asarray(got.t), np.asarray(want.t),
                               rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(got.triangle_index),
                                  np.asarray(want.triangle_index))
    assert np.asarray(got.hit).any()

    # ray-identity filters survive the coherence sort: accept hits only
    # for even caller ray ids.
    flt_ray = lambda cand: cand.ray_index % 2 == 0
    got_r = trace_packets(packed, rays, interpret=True, sort_rays=True,
                          filter_fn=flt_ray)
    base = trace_packets(packed, rays, interpret=True)
    gh = np.asarray(got_r.hit)
    even = np.arange(rays.count) % 2 == 0
    np.testing.assert_array_equal(gh, np.asarray(base.hit) & even)

    # any-hit respects the filter
    occ = trace_packets(packed, rays, interpret=True, mode="any",
                        filter_fn=flt)
    oc = np.asarray(occ.hit)
    ti = np.asarray(occ.triangle_index)
    assert oc.any() and (ti[oc] % 3 == 1).all()

    # mesh_index is visible to the predicate (single mesh here: all 0)
    flt_mesh = lambda cand: cand.mesh_index == 0
    got_m = trace_packets(packed, rays, interpret=True, filter_fn=flt_mesh)
    np.testing.assert_array_equal(np.asarray(got_m.hit),
                                  np.asarray(base.hit))

    # Tracer front-end: jit_filter keeps the callable on the packet path
    from rtk_tpu import Tracer, jit_filter

    tr = Tracer(scene, engine="packet", interpret=True)
    h_tr = tr.closest(rays, filter_fn=jit_filter(flt))
    from rtk_tpu.types import PacketHits

    assert isinstance(h_tr, PacketHits)
    np.testing.assert_array_equal(np.asarray(h_tr.hit),
                                  np.asarray(want.hit))


def test_packet_refit_fused_matches_separate():
    """trace_packets_refit (refit+repack+trace as ONE program) must match
    the separate refit -> repack_bounds -> trace pipeline.  Regression:
    an undefined-name bug in its padding math crashed every call (the
    fused path had no coverage)."""
    import jax.numpy as jnp

    from rtk_tpu.ops.pallas_trace import trace_packets_refit

    g0 = scenes.deforming_grid(0.0, n=24)
    scene = build_scene(_soup_of(np.asarray(g0)), BuildConfig(leaf_size=8))
    packed = pack_scene(scene)
    frame = jnp.asarray(scenes.deforming_grid(0.2, n=24))
    cam = scenes.camera_rays((0, 3, 4), (0, 0, 0), (0, 1, 0), 50, 24, 24)

    got, scene2, packed2 = trace_packets_refit(packed, scene, frame, cam,
                                               interpret=True)
    ref_scene = refit(scene, frame)
    ref_packed = repack_bounds(packed, ref_scene)
    ref = trace_packets(ref_packed, cam, interpret=True)
    np.testing.assert_array_equal(np.asarray(got.hit), np.asarray(ref.hit))
    np.testing.assert_array_equal(np.asarray(got.t), np.asarray(ref.t))
    np.testing.assert_array_equal(np.asarray(got.slot),
                                  np.asarray(ref.slot))
    np.testing.assert_allclose(np.asarray(scene2.node_min),
                               np.asarray(ref_scene.node_min))


def test_packet_refit_frames_scan_matches_per_frame():
    """The scan-based multi-frame executor must match per-frame fused
    refit+trace calls, frame by frame."""
    import jax.numpy as jnp

    from rtk_tpu.ops.pallas_trace import (trace_packets_refit,
                                          trace_packets_refit_frames)

    g0 = scenes.deforming_grid(0.0, n=24)
    scene = build_scene(_soup_of(np.asarray(g0)), BuildConfig(leaf_size=8))
    packed = pack_scene(scene)
    ts = (0.1, 0.25, 0.4)
    frames = jnp.stack([jnp.asarray(scenes.deforming_grid(t, n=24))
                        for t in ts])
    cam = scenes.camera_rays((0, 3, 4), (0, 0, 0), (0, 1, 0), 50, 24, 24)

    # sort_rays=True exercises the hoisted coherence sort (one sort
    # outside the lax.scan + one inverse gather after it) against the
    # per-frame path's in-trace sort.
    for sort in (False, True):
        got = trace_packets_refit_frames(packed, scene, frames, cam,
                                         interpret=True, sort_rays=sort)
        assert len(got) == len(ts)
        for f, t in enumerate(ts):
            ref, _, _ = trace_packets_refit(
                packed, scene, jnp.asarray(scenes.deforming_grid(t, n=24)),
                cam, interpret=True, sort_rays=sort)
            np.testing.assert_array_equal(np.asarray(got[f].hit),
                                          np.asarray(ref.hit))
            np.testing.assert_array_equal(np.asarray(got[f].t),
                                          np.asarray(ref.t))
            np.testing.assert_array_equal(np.asarray(got[f].slot),
                                          np.asarray(ref.slot))
            # u/v ride the scan's un-permute gather (u[:, inv]) — a
            # swapped or missing gather there would pass hit/t/slot.
            np.testing.assert_array_equal(np.asarray(got[f].u),
                                          np.asarray(ref.u))
            np.testing.assert_array_equal(np.asarray(got[f].v),
                                          np.asarray(ref.v))
            # per-frame tri_v: vertex records must reflect that frame
            np.testing.assert_allclose(
                np.asarray(got[f].position())[np.asarray(got[f].hit)],
                np.asarray(ref.position())[np.asarray(ref.hit)], rtol=1e-6)


def test_packet_anyhit_mixed_dead_lanes():
    """Any-hit packets holding both dead rays (max_t<=min_t) and live
    rays must still find every live hit — the early exit (all live
    lanes done) must not fire before slow live lanes finish, and dead
    lanes must not block it (perf) or corrupt records (correctness)."""
    rng = np.random.default_rng(29)
    tris = rng.normal(size=(300, 3, 3)).astype(np.float32)
    scene = build_scene(_soup_of(tris), BuildConfig(leaf_size=8))
    packed = pack_scene(scene)
    n = 256
    o = rng.normal(size=(n, 3)).astype(np.float32) * 3.0
    d = rng.normal(size=(n, 3)).astype(np.float32)
    dead = rng.random(n) < 0.6  # interleaved dead rays, shadow-style
    rays = Rays.make(o, d, min_t=0.0,
                     max_t=np.where(dead, 0.0, 3.0e38).astype(np.float32))
    live_rays = Rays.make(o, d)
    ref = trace_packets(packed, live_rays, interpret=True, mode="any")
    got = trace_packets(packed, rays, interpret=True, mode="any")
    gh = np.asarray(got.hit)
    assert not gh[dead].any()
    np.testing.assert_array_equal(gh[~dead], np.asarray(ref.hit)[~dead])
    # sorting the batch regroups dead and live lanes; nothing changes
    g2 = trace_packets(packed, rays, interpret=True, mode="any",
                       sort_rays=True)
    np.testing.assert_array_equal(np.asarray(g2.hit), gh)


def test_packet_defer_uv_matches():
    """defer_uv drops the u/v hit carries from the kernel (the measured
    noupdv pool, ~9 ms at the 67M headline) and recomputes them lazily in
    PacketHits via the same watertight shear test (rtk.c:181-388).  t and
    slot must be bit-equal; u/v agree up to fma contraction between the
    kernel and the XLA recompute."""
    tris = scenes.blob(subdivisions=3)[0]
    scene = build_scene(_soup_of(tris))
    packed = pack_scene(scene)
    rays = scenes.camera_rays((0, 0, 3.0), (0, 0, 0), (0, 1, 0), 45, 64, 64)
    for sort in (False, True):
        ref = trace_packets(packed, rays, interpret=True, sort_rays=sort)
        got = trace_packets(packed, rays, interpret=True, sort_rays=sort,
                            defer_uv=True)
        assert got.uv_deferred
        np.testing.assert_array_equal(np.asarray(got.hit),
                                      np.asarray(ref.hit))
        np.testing.assert_array_equal(np.asarray(got.t), np.asarray(ref.t))
        np.testing.assert_array_equal(np.asarray(got.slot),
                                      np.asarray(ref.slot))
        m = np.asarray(ref.hit)
        np.testing.assert_allclose(np.asarray(got.u)[m],
                                   np.asarray(ref.u)[m], atol=5e-5)
        np.testing.assert_allclose(np.asarray(got.v)[m],
                                   np.asarray(ref.v)[m], atol=5e-5)
        # w/full()/slicing work on the deferred record
        np.testing.assert_allclose(np.asarray(got.w)[m],
                                   np.asarray(ref.w)[m], atol=1e-4)
        sub = got[:100]
        assert sub.uv_deferred and sub.count == 100
        full = got.full()
        np.testing.assert_allclose(np.asarray(full.u)[m],
                                   np.asarray(ref.u)[m], atol=5e-5)
