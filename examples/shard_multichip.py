"""Multi-device scaling demo: every sharding mode on one script.

Covers the full scaling matrix (rtk itself scales queries only via host
threads over one shared blob, rtk.c:543-577; each mode here generalises
that over a jax.sharding.Mesh):

  1. ray sharding        — scene replicated, rays split
  2. scene sharding      — spatial partition per device, pmin hit combine
  3. hybrid 2D           — scene parts x ray shards on one 2-axis mesh

Runs compiled on the GPUs of one host:

    PYTHONPATH=. python examples/shard_multichip.py

or as a rehearsal on a virtual CPU mesh, with the kernel interpreted:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        PYTHONPATH=. python examples/shard_multichip.py --interpret
"""
from __future__ import annotations

import numpy as np

import rtk_tpu
from rtk_tpu.config import BuildConfig
from rtk_tpu.parallel.shard import (
    build_scene_sharded,
    default_mesh,
    hybrid_mesh,
    trace_closest_scene_sharded,
    trace_packets_sharded,
)
from rtk_tpu.testing import scenes
from rtk_tpu.trace.packed import pack_scene


def main(interp=False):
    import jax

    devs = jax.devices()
    print(f"{len(devs)} device(s) on {jax.default_backend()}")

    tris = scenes.blob(subdivisions=4)[0]  # 5,120 tris
    desc = (tris.reshape(-1, 3), np.arange(tris.shape[0] * 3).reshape(-1, 3))
    rays = scenes.camera_rays((0, 0, 3.0), (0, 0, 0), (0, 1, 0), 45, 64, 64)

    # single-device reference
    scene = rtk_tpu.build_scene(desc, BuildConfig(branching=8, leaf_size=8))
    want = rtk_tpu.trace_closest(scene, rays)
    n_hit = int(np.asarray(want.hit).sum())
    print(f"single device: {n_hit}/{rays.count} hits")

    # 1. ray sharding: the kernel under shard_map, scene replicated
    mesh = default_mesh()
    packed = pack_scene(scene)
    h1 = trace_packets_sharded(packed, rays, mesh, interpret=interp)
    assert (np.asarray(h1.hit) == np.asarray(want.hit)).all()
    print(f"ray-sharded over {mesh.devices.size}: match")

    # 2. scene sharding: one spatial part per device, hits combined by
    #    collectives (NCCL over NVLink on GPUs)
    sscene = build_scene_sharded(desc, mesh,
                                 BuildConfig(branching=8, leaf_size=8))
    h2 = trace_closest_scene_sharded(sscene, rays, mesh, interpret=interp)
    assert (np.asarray(h2.hit) == np.asarray(want.hit)).all()
    print(f"scene-sharded into {sscene.num_parts} parts: match")

    # 3. hybrid 2D: scene rows x ray columns on a ("scene", "rays") mesh
    if len(devs) >= 4:
        m2 = hybrid_mesh(n_scene=2)
        ss2 = build_scene_sharded(desc, m2,
                                  BuildConfig(branching=8, leaf_size=8))
        h3 = trace_closest_scene_sharded(ss2, rays, m2, interpret=interp)
        assert (np.asarray(h3.hit) == np.asarray(want.hit)).all()
        ny, nx = m2.shape["scene"], m2.shape["rays"]
        print(f"hybrid 2D ({ny} scene rows x {nx} ray cols): match")
    else:
        print("hybrid 2D: skipped (needs >= 4 devices)")


if __name__ == "__main__":
    import sys

    main(interp="--interpret" in sys.argv)
