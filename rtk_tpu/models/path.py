"""Wavefront path tracing on top of the ray-query engine.

The BASELINE north star's rendering workloads: incoherent bounce batches,
stream-compacted and re-sorted between bounces so the packet kernel stays
fed with coherent work (the reference is a pure ray-query kit; these are
the driving applications its API exists for).

Structure: a host-driven wavefront loop.  Each bounce is one fused device
program (trace + shade + sample); between bounces rays are compacted to the
live prefix (dropping finished rays shrinks the next kernel launch — ray
counts are bucketed to powers of two to bound recompiles) and optionally
sorted by a Morton key of origin+direction octant to restore coherence.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from rtk_tpu.pytree import pytree_dataclass

from rtk_tpu.ops.morton import morton3d
from rtk_tpu.tracer import Tracer
from rtk_tpu.types import Hits, Rays

Array = jax.Array


@pytree_dataclass
class Materials:
    """Per-mesh lambertian materials (indexed by Hits.mesh_index)."""

    albedo: Array  # (M, 3) f32
    emission: Array  # (M, 3) f32

    @staticmethod
    def make(albedo, emission=None) -> "Materials":
        albedo = jnp.asarray(albedo, jnp.float32).reshape(-1, 3)
        if emission is None:
            emission = jnp.zeros_like(albedo)
        else:
            emission = jnp.asarray(emission, jnp.float32).reshape(-1, 3)
        return Materials(albedo=albedo, emission=emission)


def geometric_normal(hits: Hits, direction: Array) -> Array:
    """Unit geometric normal, flipped to face the incoming ray. (N, 3)."""
    v = hits.vertex_position
    n = jnp.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    n = n / jnp.maximum(jnp.linalg.norm(n, axis=1, keepdims=True), 1e-20)
    flip = jnp.sum(n * direction, axis=1, keepdims=True) > 0
    return jnp.where(flip, -n, n)


def cosine_sample(key, normal: Array) -> Array:
    """Cosine-weighted hemisphere directions around unit normals. (N, 3)."""
    n = normal.shape[0]
    k1, k2 = jax.random.split(key)
    u1 = jax.random.uniform(k1, (n,), jnp.float32)
    u2 = jax.random.uniform(k2, (n,), jnp.float32)
    r = jnp.sqrt(u1)
    phi = 2.0 * jnp.pi * u2
    x = r * jnp.cos(phi)
    y = r * jnp.sin(phi)
    z = jnp.sqrt(jnp.maximum(1.0 - u1, 0.0))
    # Orthonormal basis around the normal (branchless Frisvad-style).
    sign = jnp.where(normal[:, 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + normal[:, 2])
    b = normal[:, 0] * normal[:, 1] * a
    t1 = jnp.stack(
        [1.0 + sign * normal[:, 0] ** 2 * a, sign * b, -sign * normal[:, 0]],
        axis=1)
    t2 = jnp.stack([b, sign + normal[:, 1] ** 2 * a, -normal[:, 1]], axis=1)
    return (x[:, None] * t1 + y[:, None] * t2
            + z[:, None] * normal).astype(jnp.float32)


def _ray_sort_key(rays: Rays, lo, hi) -> Array:
    """Coherence key: direction octant (3 bits) above a Morton code of the
    origin — the bounce-ray reordering of the wavefront design."""
    code = morton3d(rays.origin, lo, hi, bits=8)  # 24 bits
    octant = (
        (rays.direction[:, 0] >= 0).astype(jnp.uint32)
        | ((rays.direction[:, 1] >= 0).astype(jnp.uint32) << 1)
        | ((rays.direction[:, 2] >= 0).astype(jnp.uint32) << 2)
    )
    return (octant << 24) | code


def _round_up_bucket(n: int, minimum: int) -> int:
    """Next power-of-two bucket (bounds the number of jit recompiles)."""
    return max(minimum, 1 << max(0, math.ceil(math.log2(max(n, 1)))))


@functools.partial(jax.jit, static_argnames=("epsilon", "sort_rays", "last"))
def _shade_sample(hits, cur, throughput, index, radiance, materials, k_dir,
                  bg, lo, hi, *, epsilon, sort_rays, last):
    """Shade + importance-sample + build the sort permutation for one
    bounce as a single device program (per-op dispatch is expensive on
    this runtime once Pallas is in play)."""
    hit = hits.hit
    mesh = jnp.clip(hits.mesh_index, 0, materials.albedo.shape[0] - 1)
    emis = jnp.where(hit[:, None], materials.emission[mesh], 0.0)
    miss_rad = jnp.where(hit[:, None], 0.0, bg[None, :])
    radiance = radiance.at[index].add(throughput * (emis + miss_rad))
    if last:
        return radiance

    normal = geometric_normal(hits, cur.direction)
    new_dir = cosine_sample(k_dir, normal)
    origin = hits.position() + epsilon * normal
    throughput = throughput * jnp.where(
        hit[:, None], materials.albedo[mesh], 0.0)
    alive = hit & (jnp.max(throughput, axis=1) > 1e-5)
    nxt = Rays(
        origin=origin,
        direction=new_dir,
        min_t=jnp.full((cur.count,), epsilon, jnp.float32),
        max_t=jnp.where(alive, np.float32(3.4e38), 0.0),
    )
    # Dead rays to the back; optionally Morton-sorted within the live run.
    order_key = (~alive).astype(jnp.uint32)
    if sort_rays:
        order_key = (order_key << 28) | (_ray_sort_key(nxt, lo, hi) >> 4)
    perm = jnp.argsort(order_key, stable=True)
    return radiance, nxt, throughput, perm, jnp.sum(alive)


@functools.partial(jax.jit, static_argnames=("m",))
def _compact_take(cur, throughput, index, perm, *, m):
    take = lambda a: jnp.take(a, perm, axis=0)[:m]
    nxt = Rays(origin=take(cur.origin), direction=take(cur.direction),
               min_t=take(cur.min_t), max_t=take(cur.max_t))
    return nxt, take(throughput), take(index)


def render_path(
    tracer: Tracer,
    rays: Rays,
    materials: Materials,
    key,
    bounces: int = 4,
    background: tuple = (0.0, 0.0, 0.0),
    epsilon: float = 1e-4,
    sort_rays: bool = True,
    compact: bool = True,
    bounce_tracer: Tracer | None = None,
) -> Array:
    """Path-trace a ray batch; returns (N, 3) linear radiance.

    Lambertian BRDF with cosine importance sampling; emission accumulated at
    every hit; constant background radiance on miss.  Each bounce is a
    handful of device programs: trace, fused shade/sample/sort, compaction
    gather (ray counts bucketed to powers of two to bound recompiles).

    bounce_tracer: optional engine for the incoherent bounce batches
    (e.g. Tracer(scene, engine="stack")); primaries always go through
    `tracer`.
    """
    n = rays.count
    radiance = jnp.zeros((n, 3), jnp.float32)
    throughput = jnp.ones((n, 3), jnp.float32)
    index = jnp.arange(n, dtype=jnp.int32)  # slot -> original ray id
    cur = rays
    bg = jnp.asarray(background, jnp.float32)
    lo = tracer.scene.bounds_min
    hi = tracer.scene.bounds_max

    for bounce in range(bounces + 1):
        # Bounce batches are incoherent even after Morton re-sorting.
        src = tracer if (bounce == 0 or bounce_tracer is None) \
            else bounce_tracer
        hits = src.closest(cur)
        key, k_dir = jax.random.split(key)
        last = bounce == bounces
        out = _shade_sample(hits, cur, throughput, index, radiance,
                            materials, k_dir, bg, lo, hi, epsilon=epsilon,
                            sort_rays=sort_rays, last=last)
        if last:
            radiance = out
            break
        radiance, nxt, throughput, perm, n_alive_dev = out

        if compact:
            n_alive = int(n_alive_dev)  # one host sync per bounce
            if n_alive == 0:
                break
            m = min(cur.count, _round_up_bucket(n_alive, 1024))
            cur, throughput, index = _compact_take(
                nxt, throughput, index, perm, m=m)
        else:
            cur = nxt

    return radiance


def render_direct(
    tracer: Tracer,
    rays: Rays,
    materials: Materials,
    light_pos,
    light_color,
    key=None,
    epsilon: float = 1e-4,
) -> Array:
    """One-bounce direct lighting with point light + any-hit shadow rays
    (the Sponza "1-bounce diffuse" and bunny "primary + shadow" configs)."""
    hits = tracer.closest(rays)
    hit = hits.hit
    mesh = jnp.clip(hits.mesh_index, 0, materials.albedo.shape[0] - 1)
    normal = geometric_normal(hits, rays.direction)
    p = hits.position() + epsilon * normal
    lp = jnp.asarray(light_pos, jnp.float32)
    lvec = lp[None, :] - p
    ldist = jnp.linalg.norm(lvec, axis=1)
    ldir = lvec / jnp.maximum(ldist[:, None], 1e-20)
    ndotl = jnp.maximum(jnp.sum(normal * ldir, axis=1), 0.0)

    shadow = Rays(
        origin=p,
        direction=ldir,
        min_t=jnp.full_like(ldist, epsilon),
        max_t=jnp.where(hit, ldist * (1.0 - 1e-3), 0.0),
    )
    occluded = tracer.any(shadow).hit
    lc = jnp.asarray(light_color, jnp.float32)
    direct = (
        materials.albedo[mesh]
        * lc[None, :]
        * (ndotl * ~occluded / jnp.maximum(ldist * ldist, 1e-8))[:, None]
    )
    return jnp.where(hit[:, None], direct + materials.emission[mesh], 0.0)


def render_ao(
    tracer: Tracer,
    rays: Rays,
    key,
    samples: int = 8,
    max_dist: float = 1.0,
    epsilon: float = 1e-4,
) -> Array:
    """Ambient occlusion: fraction of unoccluded cosine samples. (N,)."""
    hits = tracer.closest(rays)
    normal = geometric_normal(hits, rays.direction)
    p = hits.position() + epsilon * normal
    n = rays.count
    occ = jnp.zeros((n,), jnp.float32)
    for s in range(samples):
        key, k = jax.random.split(key)
        d = cosine_sample(k, normal)
        probe = Rays(
            origin=p,
            direction=d,
            min_t=jnp.full((n,), epsilon, jnp.float32),
            max_t=jnp.where(hits.hit, max_dist, 0.0),
        )
        occ = occ + tracer.any(probe).hit.astype(jnp.float32)
    return jnp.where(hits.hit, 1.0 - occ / samples, 0.0)
