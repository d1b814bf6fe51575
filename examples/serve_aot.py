"""Serving with zero Python warmup: scene blob + AOT program artifact.

The reference's deployment story is "the blob is the runtime format" —
mmap the scene and call rtk_trace_ray (rtk.h:78-89).  The equivalent here
needs TWO artifacts, because the expensive startup cost is compilation,
not just data loading:

  1. the packed-scene blob  (utils/serialize.save_packed_scene)
  2. the compiled trace program (utils/aot.export_packet_trace)

This example builds+exports in one "CI" process, then re-execs itself as
a fresh "server" process that only reads the two files and traces.

Run: python examples/serve_aot.py               (GPU: the compiled kernel)
     JAX_PLATFORMS=cpu python examples/serve_aot.py --interpret
"""
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from rtk_tpu import BuildConfig
from rtk_tpu.scene import build_from_soup
from rtk_tpu.testing import scenes
from rtk_tpu.trace.packed import pack_scene
from rtk_tpu.utils.aot import export_packet_trace, load_packet_trace
from rtk_tpu.utils.serialize import load_packed_scene, save_packed_scene

N_RAYS = 64 * 64
INTERPRET = "--interpret" in sys.argv


def ci_export(out_dir):
    """Build once, write both artifacts (the deploy step)."""
    scene_blob = os.path.join(out_dir, "scene.rtk")
    program_blob = os.path.join(out_dir, "trace.stablehlo")
    tris = scenes.cornell_box()
    packed = pack_scene(build_from_soup(
        jnp.asarray(tris), config=BuildConfig(branching=8, leaf_size=8)))
    save_packed_scene(packed, scene_blob)
    blob = export_packet_trace(packed, N_RAYS, interpret=INTERPRET)
    with open(program_blob, "wb") as f:
        f.write(blob)
    print(f"[ci] wrote {scene_blob} + {program_blob} ({len(blob)} B)")


def serve(out_dir):
    """Fresh process: two file reads, no build, no retracing."""
    t0 = time.perf_counter()
    packed = load_packed_scene(os.path.join(out_dir, "scene.rtk"))
    with open(os.path.join(out_dir, "trace.stablehlo"), "rb") as f:
        trace = load_packet_trace(f.read())
    rays = scenes.cornell_camera(64, 64)
    hits = trace(packed, rays)
    jax.block_until_ready(hits.t)
    print(f"[serve] load+first trace: {time.perf_counter()-t0:.2f}s, "
          f"hit rate {float(np.asarray(hits.hit).mean()):.2f}")
    t0 = time.perf_counter()
    hits = trace(packed, rays)
    jax.block_until_ready(hits.t)
    print(f"[serve] steady-state: {(time.perf_counter()-t0)*1e3:.1f} ms "
          f"for {rays.count} rays")


if __name__ == "__main__":
    if "--serve" in sys.argv:
        serve(sys.argv[sys.argv.index("--serve") + 1])
    else:
        with tempfile.TemporaryDirectory() as out_dir:
            ci_export(out_dir)
            subprocess.run([sys.executable, __file__, "--serve", out_dir]
                           + (["--interpret"] if INTERPRET else []),
                           check=True, env=os.environ)
