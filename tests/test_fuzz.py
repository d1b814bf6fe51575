"""Seeded cross-engine fuzz: adversarial soups (degenerate triangles,
duplicates, axis-aligned fans, shared edges, mixed scales) traced through
every engine must agree with the float64 brute-force oracle.

The reference's only comparable guarantee is the watertight intersector
(rtk.c:181-388); this widens it to whole-engine agreement on geometry a
builder or kernel could mishandle (zero-area rows, identical centroids ->
duplicate Morton keys, denormal-scale coordinates)."""
import numpy as np
import pytest

from rtk_tpu.config import BuildConfig, TraceConfig
from rtk_tpu.oracle import trace_brute
from rtk_tpu.ops.pallas_trace import trace_packets
from rtk_tpu.scene import build_from_soup
from rtk_tpu.trace import stack as _stack
from rtk_tpu.trace.packed import pack_scene
from rtk_tpu.types import Rays


def _adversarial_soup(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    tris = []
    # random cloud
    base = rng.normal(size=(40, 3, 3)).astype(np.float32)
    tris.append(base)
    # exact duplicates (duplicate Morton keys)
    tris.append(base[:8].copy())
    # degenerate: zero-area (collinear + repeated vertex)
    t = rng.normal(size=(6, 3, 3)).astype(np.float32)
    t[:, 2] = t[:, 0]  # v2 == v0
    tris.append(t)
    # axis-aligned fan sharing one vertex (shared-edge crossings)
    apex = np.zeros(3, np.float32)
    ring = [(np.cos(a), np.sin(a)) for a in np.linspace(0, 2 * np.pi, 9)]
    fan = np.stack([
        np.stack([apex,
                  np.array([x0, y0, 0.5], np.float32),
                  np.array([x1, y1, 0.5], np.float32)])
        for (x0, y0), (x1, y1) in zip(ring[:-1], ring[1:])
    ])
    tris.append(fan.astype(np.float32))
    # tiny-scale cluster far from origin (precision stress)
    tiny = rng.normal(size=(10, 3, 3)).astype(np.float32) * 1e-3 + \
        np.float32([5, 5, 5])
    tris.append(tiny)
    return np.concatenate(tris)


@pytest.mark.parametrize("seed", [11, 29])
def test_fuzz_engines_agree_with_oracle(seed):
    import jax.numpy as jnp

    tris = _adversarial_soup(seed)
    rng = np.random.default_rng(seed + 1)
    n = 256
    rays = Rays.make(
        rng.normal(size=(n, 3)).astype(np.float32) * 2.0,
        rng.normal(size=(n, 3)).astype(np.float32),
        min_t=1e-4)

    ref = trace_brute(jnp.asarray(tris), rays)
    rh = np.asarray(ref.hit)
    rt = np.asarray(ref.t)

    for cfg in (BuildConfig(branching=8, leaf_size=4),
                BuildConfig(branching=8, leaf_size=8),
                BuildConfig(branching=8, leaf_size=16)):
        scene = build_from_soup(jnp.asarray(tris), config=cfg)
        packed = pack_scene(scene)
        got_s = _stack.trace_closest(scene, rays, config=TraceConfig())
        got_p = trace_packets(packed, rays, interpret=True)
        engines = [("stack", got_s), ("packet", got_p)]
        for tag, got in engines:
            gh = np.asarray(got.hit)
            gt = np.asarray(got.t)
            # hit set must match the f64 oracle except where the oracle
            # itself sits within float noise of the t-window edge
            mism = gh != rh
            assert mism.mean() < 0.02, (tag, cfg.leaf_size, mism.sum())
            both = gh & rh
            np.testing.assert_allclose(gt[both], rt[both],
                                       rtol=1e-4, atol=1e-5,
                                       err_msg=f"{tag} k={cfg.leaf_size}")


def test_fuzz_degenerate_only_scene_never_hits():
    """A scene of ONLY zero-area triangles: builds, traces, hits nothing
    (NaN-padding rows and degenerate geometry must not fake hits)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    t = rng.normal(size=(16, 3, 3)).astype(np.float32)
    t[:, 1] = t[:, 0]
    scene = build_from_soup(jnp.asarray(t),
                            config=BuildConfig(branching=8, leaf_size=4))
    rays = Rays.make(rng.normal(size=(64, 3)).astype(np.float32),
                     rng.normal(size=(64, 3)).astype(np.float32))
    got = trace_packets(pack_scene(scene), rays, interpret=True)
    assert not np.asarray(got.hit).any()
