"""TLAS/BLAS instancing vs a brute-force transformed-geometry oracle."""
import pytest
import numpy as np

from rtk_tpu import Rays, build_scene
from rtk_tpu.instancing import build_instanced, merge_blas, trace_closest_instanced
from rtk_tpu.oracle import trace_brute
from rtk_tpu.testing import scenes


def _soup_of(tris):
    t = tris.shape[0]
    return (tris.reshape(-1, 3), np.arange(t * 3).reshape(-1, 3))


def _transform(scale, rot_y, tx, ty, tz):
    c, s = np.cos(rot_y), np.sin(rot_y)
    lin = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32) * scale
    return np.concatenate([lin, [[tx], [ty], [tz]]], axis=1).astype(np.float32)


def _setup(n_inst=6, seed=2):
    rng = np.random.default_rng(seed)
    blob_tris = scenes.blob(subdivisions=2)[0]  # 320 tris
    box_tris = scenes.box([-0.5, -0.5, -0.5], [0.5, 0.5, 0.5])
    blas = [build_scene(_soup_of(blob_tris)), build_scene(_soup_of(box_tris))]
    inst_blas = rng.integers(0, 2, n_inst).astype(np.int32)
    tf = np.stack([
        _transform(0.5 + rng.random(), rng.random() * 6.28,
                   *(rng.random(3) * 8 - 4))
        for _ in range(n_inst)
    ])
    iscene = build_instanced(blas, inst_blas, tf)
    # Brute-force reference: transform all geometry to world space.
    srcs = [blob_tris, box_tris]
    world = []
    for b, m in zip(inst_blas, tf):
        g = srcs[b]
        world.append(np.einsum("ab,tvb->tva", m[:, :3], g) + m[:, 3])
    return iscene, np.concatenate(world), inst_blas, srcs


def test_merge_blas_roots():
    tris = scenes.cornell_box()
    a = build_scene(_soup_of(tris))
    b = build_scene(_soup_of(scenes.box([0, 0, 0], [1, 1, 1])))
    merged, roots = merge_blas([a, b])
    assert roots[0] == 0 and roots[1] == a.node_child.shape[0]
    assert merged.tri_v.shape[0] == a.num_padded_tris + b.num_padded_tris


def test_instanced_matches_world_space_brute():
    iscene, world_tris, _, _ = _setup()
    rng = np.random.default_rng(7)
    o = (rng.normal(size=(400, 3)) * 6).astype(np.float32)
    d = rng.normal(size=(400, 3)).astype(np.float32)
    rays = Rays.make(o, d)
    hits, inst = trace_closest_instanced(iscene, rays)
    want = trace_brute(world_tris, rays)
    wh = np.asarray(want.hit)
    np.testing.assert_array_equal(np.asarray(hits.hit), wh)
    np.testing.assert_allclose(
        np.asarray(hits.t)[wh], np.asarray(want.t)[wh], rtol=2e-4, atol=2e-4)
    assert (np.asarray(inst)[wh] >= 0).all()
    assert (np.asarray(inst)[~wh] == -1).all()


def test_instanced_camera_render():
    iscene, world_tris, _, _ = _setup(n_inst=10, seed=5)
    rays = scenes.camera_rays((0, 2, 12), (0, 0, 0), (0, 1, 0), 45, 32, 32)
    hits, inst = trace_closest_instanced(iscene, rays)
    want = trace_brute(world_tris, rays)
    wh = np.asarray(want.hit)
    np.testing.assert_array_equal(np.asarray(hits.hit), wh)
    np.testing.assert_allclose(
        np.asarray(hits.t)[wh], np.asarray(want.t)[wh], rtol=2e-4, atol=2e-4)


def test_instanced_candidate_cap():
    # With fewer candidate slots than overlapping instances the nearest
    # instances still win for most rays (candidates are nearest-first).
    iscene, world_tris, _, _ = _setup(n_inst=12, seed=9)
    rays = scenes.camera_rays((0, 2, 12), (0, 0, 0), (0, 1, 0), 45, 16, 16)
    hits2, _ = trace_closest_instanced(iscene, rays, max_candidates=12)
    hits1, _ = trace_closest_instanced(iscene, rays, max_candidates=4)
    h2 = np.asarray(hits2.hit)
    agree = (np.asarray(hits1.t)[h2] == np.asarray(hits2.t)[h2]).mean()
    assert agree > 0.95


@pytest.mark.smoke
def test_instanced_packet_kernel_matches_brute():
    from rtk_tpu.instancing import pack_instanced, trace_closest_instanced_packets

    iscene, world_tris, _, _ = _setup()
    ps = pack_instanced(iscene)
    rng = np.random.default_rng(7)
    o = (rng.normal(size=(300, 3)) * 6).astype(np.float32)
    d = rng.normal(size=(300, 3)).astype(np.float32)
    rays = Rays.make(o, d)
    hits, inst = trace_closest_instanced_packets(ps, rays, interpret=True)
    want = trace_brute(world_tris, rays)
    wh = np.asarray(want.hit)
    np.testing.assert_array_equal(np.asarray(hits.hit), wh)
    np.testing.assert_allclose(
        np.asarray(hits.t)[wh], np.asarray(want.t)[wh], rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(np.asarray(inst) >= 0, wh)


def test_instanced_packets_perf_flags_parity():
    """The kernel rounds (per-ray BLAS roots, stable instance grouping)
    must match the XLA stack-engine instanced path on a K=8 BLAS set."""
    from rtk_tpu.config import BuildConfig
    from rtk_tpu.instancing import (pack_instanced,
                                    trace_closest_instanced_packets)

    rng = np.random.default_rng(2)
    cfg8 = BuildConfig(branching=8, leaf_size=8)
    blob_tris = scenes.blob(subdivisions=2)[0]
    box_tris = scenes.box([-0.5, -0.5, -0.5], [0.5, 0.5, 0.5])
    blas = [build_scene(_soup_of(blob_tris), cfg8),
            build_scene(_soup_of(box_tris), cfg8)]
    inst_blas = rng.integers(0, 2, 6).astype(np.int32)
    tf = np.stack([
        _transform(0.5 + rng.random(), rng.random() * 6.28,
                   *(rng.random(3) * 8 - 4))
        for _ in range(6)
    ])
    iscene = build_instanced(blas, inst_blas, tf)
    ps = pack_instanced(iscene)
    rng = np.random.default_rng(11)
    o = (rng.normal(size=(200, 3)) * 6).astype(np.float32)
    d = rng.normal(size=(200, 3)).astype(np.float32)
    rays = Rays.make(o, d)
    base, ibase = trace_closest_instanced(iscene, rays, max_candidates=6)
    got, igot = trace_closest_instanced_packets(ps, rays, interpret=True)
    np.testing.assert_array_equal(np.asarray(got.hit), np.asarray(base.hit))
    h = np.asarray(base.hit)
    np.testing.assert_allclose(np.asarray(got.t)[h], np.asarray(base.t)[h],
                               rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(igot)[h], np.asarray(ibase)[h])


def test_instanced_packets_round_caps_parity():
    """Capped rounds (r5: per-round kernel widths sized from candidate
    counts, scatter-merge) must reproduce the full-width results; tiny
    explicit caps must stay exact via the over-cap residual."""
    from rtk_tpu.instancing import (pack_instanced,
                                    trace_closest_instanced_packets)

    iscene, world_tris, _, _ = _setup()
    ps = pack_instanced(iscene)
    rng = np.random.default_rng(13)
    o = (rng.normal(size=(300, 3)) * 6).astype(np.float32)
    d = rng.normal(size=(300, 3)).astype(np.float32)
    rays = Rays.make(o, d)
    base, ibase = trace_closest_instanced_packets(ps, rays, interpret=True)
    auto, iauto = trace_closest_instanced_packets(ps, rays, interpret=True,
                                                  round_caps="auto")
    np.testing.assert_array_equal(np.asarray(base.hit), np.asarray(auto.hit))
    np.testing.assert_array_equal(np.asarray(base.t), np.asarray(auto.t))
    np.testing.assert_array_equal(np.asarray(ibase), np.asarray(iauto))
    # Deliberately starved caps: rounds lose live rows, the over-cap
    # marking must route them into the exactness residual.
    C = min(8, iscene.num_instances)
    tiny, itiny = trace_closest_instanced_packets(
        ps, rays, interpret=True, round_caps=(1024,) + (128,) * (C - 1))
    np.testing.assert_array_equal(np.asarray(base.hit), np.asarray(tiny.hit))
    np.testing.assert_allclose(np.asarray(base.t), np.asarray(tiny.t),
                               rtol=1e-6, atol=1e-6)
    # Calibrated caps (measured per-round liveness) stay exact too, and
    # exercise the slim-sort (2-op sort + cap-row gather) small rounds.
    from rtk_tpu.instancing import calibrate_round_caps
    caps = calibrate_round_caps(ps, rays, interpret=True)
    cal, ical = trace_closest_instanced_packets(ps, rays, interpret=True,
                                                round_caps=caps)
    np.testing.assert_array_equal(np.asarray(base.hit), np.asarray(cal.hit))
    np.testing.assert_allclose(np.asarray(base.t), np.asarray(cal.t),
                               rtol=1e-6, atol=1e-6)


def test_total_triangles_counts_instances():
    """total_triangles = sum over instances of their BLAS's real triangle
    count (r1 fix: it returned the merged count regardless of instances)."""
    import numpy as np

    from rtk_tpu import build_scene
    from rtk_tpu.config import BuildConfig
    from rtk_tpu.instancing import build_instanced
    from rtk_tpu.testing import scenes

    tris_a = scenes.blob(subdivisions=2)[0]  # 320 tris
    tris_b = scenes.cornell_box()
    cfg = BuildConfig(branching=8, leaf_size=8)
    soup = lambda t: (t.reshape(-1, 3),
                      np.arange(t.shape[0] * 3).reshape(-1, 3))
    blas = [build_scene(soup(tris_a), cfg), build_scene(soup(tris_b), cfg)]
    eye = np.concatenate([np.eye(3), np.zeros((3, 1))], axis=1)
    iscene = build_instanced(blas, [0, 0, 1], np.stack([eye] * 3))
    assert iscene.total_triangles == (
        2 * tris_a.shape[0] + tris_b.shape[0])


def test_instanced_packets_exact_with_small_candidate_cap():
    """exact=True: a candidate cap far below the overlap depth must still
    return the true nearest hit (overflow residual re-traces unproven
    rays exhaustively)."""
    import numpy as np

    from rtk_tpu.instancing import (pack_instanced,
                                    trace_closest_instanced_packets)

    iscene, world_tris, _, _ = _setup(n_inst=12, seed=9)
    pscene = pack_instanced(iscene)
    rays = scenes.camera_rays((0, 2, 12), (0, 0, 0), (0, 1, 0), 45, 16, 16)
    ref, iref = trace_closest_instanced_packets(pscene, rays,
                                                max_candidates=12,
                                                interpret=True)
    got, igot = trace_closest_instanced_packets(pscene, rays,
                                                max_candidates=1,
                                                interpret=True)
    np.testing.assert_array_equal(np.asarray(got.hit), np.asarray(ref.hit))
    np.testing.assert_allclose(np.asarray(got.t), np.asarray(ref.t),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(igot), np.asarray(iref))


def test_instanced_sah_forest_matches_lbvh_pack():
    """SAH BLAS tables (build_sah_forest -> pack_instanced override) must
    trace identically to the merged-LBVH pack (same kernel, different
    per-BLAS topology; exact-t ties may resolve differently)."""
    from rtk_tpu.builder.sah import build_sah_forest
    from rtk_tpu.config import BuildConfig
    from rtk_tpu.instancing import (pack_instanced,
                                    trace_closest_instanced_packets)

    try:
        import rtk_tpu.utils.native_sah as ns

        ns._load()
    except Exception as e:  # pragma: no cover - no toolchain
        pytest.skip(f"native builder unavailable: {e}")

    rng = np.random.default_rng(5)
    blob_tris = scenes.blob(subdivisions=2)[0]
    box_tris = scenes.box([-0.5, -0.5, -0.5], [0.5, 0.5, 0.5])
    cfg = BuildConfig(branching=8, leaf_size=8)
    blas = [build_scene(_soup_of(blob_tris), cfg),
            build_scene(_soup_of(box_tris), cfg)]
    inst_blas = rng.integers(0, 2, 5).astype(np.int32)
    tf = np.stack([
        _transform(0.5 + rng.random(), rng.random() * 6.28,
                   *(rng.random(3) * 6 - 3))
        for _ in range(5)
    ])
    iscene = build_instanced(blas, inst_blas, tf)
    ps_lbvh = pack_instanced(iscene)
    pk, roots = build_sah_forest([blob_tris, box_tris], cfg)
    ps_sah = pack_instanced(iscene, packed=pk, packed_roots=roots)

    o = (rng.normal(size=(300, 3)) * 5).astype(np.float32)
    d = rng.normal(size=(300, 3)).astype(np.float32)
    rays = Rays.make(o, d)
    ha, ia = trace_closest_instanced_packets(ps_lbvh, rays, interpret=True)
    hb, ib = trace_closest_instanced_packets(ps_sah, rays, interpret=True)
    np.testing.assert_array_equal(np.asarray(ha.hit), np.asarray(hb.hit))
    np.testing.assert_allclose(np.asarray(ha.t), np.asarray(hb.t),
                               rtol=1e-5, atol=1e-5)
    same_t = np.isclose(np.asarray(ha.t), np.asarray(hb.t))
    diff = (np.asarray(ia) != np.asarray(ib)) & np.asarray(ha.hit)
    # instance/record divergence only allowed at exact-t ties
    assert (same_t | ~diff).all()
