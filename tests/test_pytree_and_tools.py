"""Pytree dataclasses, compile-cache placement, and the GPU-only entry
scripts' refusal to run without a GPU."""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rtk_tpu import Rays, build_scene
from rtk_tpu.testing import scenes
from rtk_tpu.trace.packed import pack_scene
from rtk_tpu.types import Hits, PacketHits, miss_hits
from rtk_tpu.utils import cache

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _packed():
    tris = scenes.blob(subdivisions=1)[0]
    return pack_scene(build_scene(
        (tris.reshape(-1, 3), np.arange(tris.shape[0] * 3).reshape(-1, 3))))


def test_rays_flatten_replace_roundtrip():
    r = Rays.make(np.zeros((4, 3)), np.ones((4, 3)), max_t=5.0)
    leaves, tree = jax.tree.flatten(r)
    assert len(leaves) == 4
    r2 = jax.tree.unflatten(tree, leaves)
    np.testing.assert_array_equal(r2.max_t, r.max_t)
    r3 = dataclasses.replace(r, min_t=r.min_t + 1)
    assert float(r3.min_t[0]) == 1.0 and float(r.min_t[0]) == 0.0
    with pytest.raises(dataclasses.FrozenInstanceError):
        r.min_t = r.max_t


def test_hits_through_jit_and_tree_map():
    h = miss_hits(3)
    out = jax.jit(lambda h: jax.tree.map(lambda a: a, h))(h)
    assert isinstance(out, Hits)
    assert out[1:].count == 2


def test_static_fields_are_tree_metadata():
    """PackedScene's sizes are static: they live in the treedef, not the
    leaves, and a jitted function sees them as Python ints."""
    packed = _packed()
    leaves, tree = jax.tree.flatten(packed)
    assert all(hasattr(l, "shape") for l in leaves)
    seen = jax.jit(lambda p: jnp.int32(p.leaf_size * 10 + p.num_tris))(
        packed)
    assert int(seen) == packed.leaf_size * 10 + packed.num_tris
    moved = dataclasses.replace(packed, nodes=packed.nodes + 0)
    assert jax.tree.structure(moved) == tree


def test_packet_hits_optional_overflow_leaf():
    n, tp = 5, 4
    z = jnp.zeros((n,), jnp.float32)
    base = dict(hit=z > 0, t=z, u_k=z, v_k=z,
                slot=jnp.full((n,), -1, jnp.int32),
                origin=jnp.zeros((n, 3)), direction=jnp.ones((n, 3)),
                tri_v=jnp.zeros((tp, 3, 3)),
                tri_vidx=jnp.zeros((tp, 3), jnp.int32),
                tri_mesh=jnp.zeros((tp,), jnp.int32),
                tri_prim=jnp.zeros((tp,), jnp.int32))
    without = PacketHits(**base)
    with_flag = PacketHits(**base, overflow=z > 0)
    assert len(jax.tree.leaves(with_flag)) == len(
        jax.tree.leaves(without)) + 1
    assert without[:2].overflow is None
    assert with_flag[:2].overflow.shape == (2,)
    assert with_flag.full().count == n


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_placement(env_set, monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    if env_set:
        monkeypatch.setenv(cache.ENV, str(tmp_path / "elsewhere"))
    else:
        monkeypatch.delenv(cache.ENV, raising=False)
    try:
        path = cache.configure_compile_cache(str(tmp_path))
        if env_set:
            assert path == str(tmp_path / "elsewhere")
            # JAX reads the variable itself; nothing else is set
            assert jax.config.jax_compilation_cache_dir == before
        else:
            assert path == str(tmp_path / ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def _run(args, cwd, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _no_json(stdout):
    for line in stdout.splitlines():
        try:
            json.loads(line)
        except ValueError:
            continue
        return False
    return True


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_refuses_without_gpu(where, tmp_path):
    src = ROOT / "chip_smoke.py"
    if where == "alone":
        (tmp_path / "chip_smoke.py").write_text(src.read_text())
        cwd, script = tmp_path, "chip_smoke.py"
    else:
        cwd, script = ROOT, str(src)
    out = _run([script], cwd)
    assert out.returncode != 0
    assert _no_json(out.stdout)


def test_bench_refuses_without_gpu():
    out = _run(["bench.py", "--config", "cornell"], ROOT,
               {"JAX_COMPILATION_CACHE_DIR": ""})
    assert out.returncode == 2
    assert _no_json(out.stdout)
