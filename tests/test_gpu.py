"""The compiled traversal kernel on a GPU against its interpreted self and
the XLA stack engine, over every kernel option.  Skips where JAX finds no
GPU (the `gpu_device` fixture)."""
import numpy as np
import pytest

from rtk_tpu import Tracer, build_scene
from rtk_tpu.ops.pallas_trace import trace_packets
from rtk_tpu.testing import scenes
from rtk_tpu.trace.packed import pack_scene

VARIANTS = {
    "closest": dict(mode="closest"),
    "any": dict(mode="any"),
    "filter_mask": dict(filter_mask=1),
    "filter_fn": dict(filter_fn=lambda c: c.triangle_index % 3 != 0),
    "defer_uv": dict(defer_uv=True),
    "sorted": dict(sort_rays=True),
}


def _scene():
    tris = scenes.blob(subdivisions=3)[0]
    return tris, build_scene(
        (tris.reshape(-1, 3), np.arange(tris.shape[0] * 3).reshape(-1, 3)))


@pytest.mark.gpu
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_compiled_kernel_matches_interpreted(gpu_device, variant):
    tris, scene = _scene()
    mask = (np.arange(tris.shape[0]) % 2).astype(np.uint32)
    packed = pack_scene(scene, tri_mask=mask)
    rays = scenes.camera_rays((0, 0, 3.0), (0, 0, 0), (0, 1, 0), 45, 64, 64)
    kw = VARIANTS[variant]
    got = trace_packets(packed, rays, **kw)
    want = trace_packets(packed, rays, interpret=True, **kw)
    assert not np.asarray(got.overflow).any()
    np.testing.assert_array_equal(np.asarray(got.hit), np.asarray(want.hit))
    if kw.get("mode", "closest") == "closest":
        np.testing.assert_allclose(np.asarray(got.t), np.asarray(want.t),
                                   rtol=1e-6)
        # u on the same triangle (an exact-t tie may pick its neighbour)
        same = np.asarray(got.slot) == np.asarray(want.slot)
        np.testing.assert_allclose(np.asarray(got.u)[same],
                                   np.asarray(want.u)[same], atol=1e-5)


@pytest.mark.gpu
def test_compiled_stats_and_auto_engine(gpu_device):
    _, scene = _scene()
    rays = scenes.camera_rays((0, 0, 3.0), (0, 0, 0), (0, 1, 0), 45, 64, 64)
    hits, steps = trace_packets(pack_scene(scene), rays, stats=True)
    assert (np.asarray(steps)[np.asarray(hits.hit)] > 0).all()
    tracer = Tracer(scene)
    assert tracer.engine == "packet"
    xla = Tracer(scene, engine="stack").closest(rays)
    np.testing.assert_array_equal(np.asarray(tracer.closest(rays).hit),
                                  np.asarray(xla.hit))
