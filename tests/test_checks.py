"""Debug validation paths (testing/checks.py)."""
import dataclasses
import numpy as np
import pytest

from rtk_tpu import build_scene
from rtk_tpu.testing import scenes
from rtk_tpu.testing.checks import (ValidationError, checkify_trace,
                                    validate_rays, validate_scene)
from rtk_tpu.types import Rays


def test_validate_rays_catches_nan_and_zero():
    good = Rays.make(np.zeros((4, 3), np.float32),
                     np.ones((4, 3), np.float32))
    validate_rays(good)
    bad_o = dataclasses.replace(good, origin=good.origin.at[1, 0].set(np.nan))
    with pytest.raises(ValidationError, match="origin"):
        validate_rays(bad_o)
    bad_d = dataclasses.replace(good, direction=good.direction.at[2].set(0.0))
    with pytest.raises(ValidationError, match="all-zero"):
        validate_rays(bad_d)


def test_validate_scene_passes_on_built_scene():
    tris = scenes.cornell_box()
    scene = build_scene(
        (tris.reshape(-1, 3), np.arange(tris.shape[0] * 3).reshape(-1, 3)))
    validate_scene(scene)


def test_checkify_trace_surfaces_nan():
    import jax.numpy as jnp

    def f(x):
        return jnp.log(x)  # NaN for negative input

    wrapped = checkify_trace(f)
    err, _ = wrapped(jnp.array([-1.0]))
    with pytest.raises(Exception):
        err.throw()


def test_profiler_trace_smoke(tmp_path):
    import jax.numpy as jnp

    from rtk_tpu.utils.stats import profiler_trace

    with profiler_trace(str(tmp_path), annotation="smoke"):
        jnp.ones((8, 8)).sum().block_until_ready()
    # a trace directory must have been produced
    import os

    assert any(os.scandir(str(tmp_path)))


def test_log_build_emits_per_level_lines():
    from rtk_tpu.utils.stats import BuildLogger, log_build

    tris = scenes.blob(subdivisions=3)[0]
    scene = build_scene(
        (tris.reshape(-1, 3), np.arange(tris.shape[0] * 3).reshape(-1, 3)))
    lines = []
    st = log_build(scene, BuildLogger(lambda u, b, m: lines.append(m)))
    assert any("level 1:" in l for l in lines)
    assert st.num_tris == tris.shape[0]
    assert sum("level" in l for l in lines) == st.max_depth


def test_measure_trace_with_steps():
    # measure_trace's step-count path runs the kernel's stats output.
    from rtk_tpu.tracer import Tracer
    from rtk_tpu.utils.stats import measure_trace

    tris = scenes.blob(subdivisions=3)[0]
    scene = build_scene(
        (tris.reshape(-1, 3), np.arange(tris.shape[0] * 3).reshape(-1, 3)))
    tracer = Tracer(scene, engine="packet", interpret=True)
    rays = scenes.camera_rays((0, 0, 3.0), (0, 0, 0), (0, 1, 0), 45, 32, 32)
    st = measure_trace(tracer, rays, iters=1, with_steps=True)
    assert st.rays == rays.count
    assert st.steps_per_ray and st.steps_per_ray > 0


def test_log_build_per_node_mode():
    from rtk_tpu.utils.stats import BuildLogger, log_build

    tris = scenes.blob(subdivisions=3)[0]
    scene = build_scene(
        (tris.reshape(-1, 3), np.arange(tris.shape[0] * 3).reshape(-1, 3)))
    lines = []
    st = log_build(scene, BuildLogger(lambda u, b, m: lines.append(m)),
                   per_node=True)
    # one line per reachable wide node, rtk.c:1426 frequency
    assert sum("node " in l for l in lines) == st.num_wide_nodes
    assert any("depth 1:" in l for l in lines)
