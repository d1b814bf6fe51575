"""Deforming-scene demo: one LBVH topology, per-frame on-device refit,
and the scan executor that traces a whole clip in ONE device program.

The reference rebuilds from scratch for dynamic scenes (rtk has no
refit); rtk-tpu keeps the topology and refits bounds on device, and for
clips of frames amortises the fixed per-dispatch cost with
``trace_packets_refit_frames`` (lax.scan over frames).

    PYTHONPATH=. python examples/animate_deform.py [frames] [size]

On a GPU the kernel runs compiled.  `--interpret` runs it in Pallas' CPU
interpreter instead (with JAX_PLATFORMS=cpu and a small size).
"""
from __future__ import annotations

import sys
import time

import numpy as np

import rtk_tpu
from rtk_tpu.testing import scenes


def main(n_frames=8, size=128, interpret=False):
    import jax
    import jax.numpy as jnp

    from rtk_tpu.ops.pallas_trace import (trace_packets_refit,
                                          trace_packets_refit_frames)
    from rtk_tpu.trace.packed import pack_scene

    grid0 = scenes.deforming_grid(0.0, n=64)
    scene = rtk_tpu.build_scene(
        (grid0.reshape(-1, 3),
         np.arange(grid0.shape[0] * 3).reshape(-1, 3)))
    packed = pack_scene(scene)
    cam = scenes.camera_rays((0, 3, 4), (0, 0, 0), (0, 1, 0), 50,
                             size, size, order="morton")

    # Per-frame: refit + repack + trace fused into one program each.
    t0 = time.perf_counter()
    for i in range(n_frames):
        pos = jnp.asarray(scenes.deforming_grid(0.05 * i, n=64))
        hits, _, _ = trace_packets_refit(packed, scene, pos, cam,
                                         interpret=interpret)
        jax.block_until_ready(hits.t)
    per_frame = (time.perf_counter() - t0) / n_frames
    print(f"per-frame fused refit+trace: {per_frame*1e3:.1f} ms/frame")

    # Whole clip: ONE dispatch via lax.scan.
    clip = jnp.stack([jnp.asarray(scenes.deforming_grid(0.05 * i, n=64))
                      for i in range(n_frames)])
    frames = trace_packets_refit_frames(packed, scene, clip, cam,
                                        interpret=interpret)
    jax.block_until_ready(frames[-1].t)
    t0 = time.perf_counter()
    frames = trace_packets_refit_frames(packed, scene, clip, cam,
                                        interpret=interpret)
    jax.block_until_ready(frames[-1].t)
    per_frame = (time.perf_counter() - t0) / n_frames
    print(f"{n_frames}-frame scan executor: {per_frame*1e3:.1f} ms/frame "
          f"amortised")
    for i, h in enumerate(frames):
        print(f"  frame {i}: hit rate "
              f"{float(np.asarray(h.hit).mean()):.3f}")


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--interpret"]
    main(*(int(a) for a in args[:2]), interpret="--interpret" in sys.argv)
