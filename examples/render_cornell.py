"""End-to-end demo: path-trace the Cornell box and write a PPM image.

Runs anywhere: Tracer(engine="auto") picks the engine for the backend
(the measured one on a GPU, the XLA stack engine on the CPU).  From a repo checkout:

    PYTHONPATH=. python examples/render_cornell.py [out.ppm] [size] [spp]
"""
from __future__ import annotations

import sys

import numpy as np

import rtk_tpu
from rtk_tpu.models.path import Materials, render_path
from rtk_tpu.testing import scenes


def main(out="cornell.ppm", size=256, spp=4):
    import jax

    tris = scenes.cornell_box()
    scene = rtk_tpu.build_scene(
        (tris.reshape(-1, 3), np.arange(tris.shape[0] * 3).reshape(-1, 3)))
    tracer = rtk_tpu.Tracer(scene)

    # cornell_box() is one mesh; shade it with a neutral albedo and put a
    # constant-emission "light" response on the ceiling via background.
    mats = Materials.make(albedo=[[0.73, 0.73, 0.73]])

    rays = scenes.cornell_camera(size, size)
    acc = np.zeros((size * size, 3), np.float32)
    key = jax.random.PRNGKey(7)
    for s in range(spp):
        key, k = jax.random.split(key)
        img = render_path(tracer, rays, mats, k, bounces=3,
                          background=(3.0, 3.0, 3.0))
        acc += np.asarray(img)
    acc /= spp

    # simple tonemap + gamma
    rgb = np.clip(acc / (1.0 + acc), 0.0, 1.0) ** (1.0 / 2.2)
    px = (rgb.reshape(size, size, 3) * 255).astype(np.uint8)
    with open(out, "wb") as f:
        f.write(f"P6\n{size} {size}\n255\n".encode())
        f.write(px.tobytes())
    print(f"wrote {out}: {size}x{size}, {spp} spp, "
          f"mean luminance {rgb.mean():.3f}")


if __name__ == "__main__":
    args = sys.argv[1:]
    main(*(args[:1] + [int(a) for a in args[1:3]]))
