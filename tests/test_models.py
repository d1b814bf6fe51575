"""Renderer-level tests (path tracer, direct lighting, AO)."""
import jax
import numpy as np

from rtk_tpu import build_scene
from rtk_tpu.mesh import build_soup
from rtk_tpu.models.path import Materials, render_ao, render_direct, render_path
from rtk_tpu.testing import scenes
from rtk_tpu.tracer import Tracer


def _cornell_tracer():
    walls = scenes.cornell_box()[:10]
    boxes = scenes.cornell_box()[10:]
    # emissive "light" quad just below the ceiling
    light = scenes.quad(
        np.array([0.35, 0.998, 0.35], np.float32),
        np.array([0.65, 0.998, 0.35], np.float32),
        np.array([0.65, 0.998, 0.65], np.float32),
        np.array([0.35, 0.998, 0.65], np.float32),
    )
    soup = build_soup([
        (walls.reshape(-1, 3), np.arange(walls.size // 3).reshape(-1, 3)),
        (boxes.reshape(-1, 3), np.arange(boxes.size // 3).reshape(-1, 3)),
        (light.reshape(-1, 3), np.arange(light.size // 3).reshape(-1, 3)),
    ])
    scene = build_scene(soup)
    mats = Materials.make(
        albedo=[[0.7, 0.7, 0.7], [0.6, 0.3, 0.3], [0.0, 0.0, 0.0]],
        emission=[[0, 0, 0], [0, 0, 0], [15.0, 15.0, 15.0]],
    )
    return Tracer(scene), mats


def test_path_tracer_converges_sane():
    tracer, mats = _cornell_tracer()
    rays = scenes.cornell_camera(24, 24)
    key = jax.random.PRNGKey(0)
    img = np.zeros((rays.count, 3), np.float32)
    spp = 4
    for s in range(spp):
        key, k = jax.random.split(key)
        img += np.asarray(render_path(tracer, rays, mats, k, bounces=3))
    img /= spp
    assert np.isfinite(img).all()
    assert img.max() > 0.01  # light reaches the camera
    assert (img >= 0).all()
    # Some pixels found light paths (brute-force PT with a small light and
    # few samples is sparse by nature).
    assert (img.max(axis=1) > 1e-4).mean() > 0.03


def test_path_compaction_matches_no_compaction():
    tracer, mats = _cornell_tracer()
    rays = scenes.cornell_camera(16, 16)
    key = jax.random.PRNGKey(3)
    a = np.asarray(render_path(tracer, rays, mats, key, bounces=2,
                               compact=False))
    b = np.asarray(render_path(tracer, rays, mats, key, bounces=2,
                               compact=True, sort_rays=False))
    # Same RNG key stream per bounce, compaction permutes lanes so
    # per-ray samples differ; compare aggregate statistics instead.
    assert abs(a.mean() - b.mean()) / max(a.mean(), 1e-9) < 0.35
    assert np.isfinite(b).all()


def test_render_direct_shadows():
    tracer, mats = _cornell_tracer()
    rays = scenes.cornell_camera(32, 32)
    img = np.asarray(render_direct(
        tracer, rays, mats, light_pos=(0.5, 0.95, 0.5),
        light_color=(1.0, 1.0, 1.0)))
    assert np.isfinite(img).all()
    assert img.max() > 0.01
    # Some pixels must be shadowed (boxes cast shadows)
    lum = img.max(axis=1)
    assert (lum < 1e-6).sum() > 10


def test_render_ao():
    tracer, _ = _cornell_tracer()
    rays = scenes.cornell_camera(16, 16)
    ao = np.asarray(render_ao(tracer, rays, jax.random.PRNGKey(1),
                              samples=4, max_dist=0.5))
    assert np.isfinite(ao).all()
    assert (ao >= 0).all() and (ao <= 1).all()
    assert 0.05 < ao.mean() < 0.99  # interior partially occluded


def test_render_path_bounce_tracer_matches():
    """bounce_tracer (a second engine for incoherent bounces) must not
    change radiance: same scene, exact engines, same RNG stream."""
    tris = scenes.cornell_box()
    scene = build_scene(
        (tris.reshape(-1, 3), np.arange(tris.shape[0] * 3).reshape(-1, 3)))
    tracer = Tracer(scene)
    bt = Tracer(scene, engine="packet", interpret=True)
    mats = Materials.make(albedo=[[0.7, 0.7, 0.7]])
    rays = scenes.cornell_camera(12, 12)
    key = jax.random.PRNGKey(3)
    a = np.asarray(render_path(tracer, rays, mats, key, bounces=2,
                               background=(1.0, 1.0, 1.0)))
    b = np.asarray(render_path(tracer, rays, mats, key, bounces=2,
                               background=(1.0, 1.0, 1.0),
                               bounce_tracer=bt))
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
