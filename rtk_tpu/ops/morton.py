"""Morton (Z-order) codes for LBVH construction.

The reference builds a SAH BVH with recursive CPU tasks (rtk.c:867-1019);
the on-device builder replaces it with sort-based LBVH: quantise triangle
centroids to a grid over the scene bounds, interleave bits into Morton codes,
sort, and derive the hierarchy from the sorted codes (builder/lbvh.py).
Everything here is dense, branch-free vector code.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jax.Array


def expand_bits10(v: Array) -> Array:
    """Spread the low 10 bits of each uint32 lane to every 3rd bit."""
    v = jnp.asarray(v, jnp.uint32)
    v = (v | (v << 16)) & jnp.uint32(0x030000FF)
    v = (v | (v << 8)) & jnp.uint32(0x0300F00F)
    v = (v | (v << 4)) & jnp.uint32(0x030C30C3)
    v = (v | (v << 2)) & jnp.uint32(0x09249249)
    return v


def morton3d(points: Array, lo: Array, hi: Array, bits: int = 10) -> Array:
    """Morton codes of points (..., 3) quantised inside [lo, hi] bounds.

    Returns uint32 codes with 3*bits significant bits.
    """
    points = jnp.asarray(points, jnp.float32)
    scale = jnp.float32((1 << bits) - 1)
    extent = jnp.maximum(hi - lo, jnp.float32(1e-30))
    q = (points - lo) / extent
    q = jnp.clip(q * scale, 0.0, scale)
    qi = q.astype(jnp.uint32)
    shift = 10 - bits
    ex = expand_bits10(qi << shift if shift else qi)
    return (ex[..., 0] << 2) | (ex[..., 1] << 1) | ex[..., 2]


def scene_bounds(tri_pos: Array):
    """(min, max) over all triangle vertices. tri_pos: (T, 3, 3)."""
    p = tri_pos.reshape(-1, 3)
    return jnp.min(p, axis=0), jnp.max(p, axis=0)


def sort_by_morton(codes: Array):
    """Sort Morton codes, returning (sorted_codes, permutation).

    Ties are broken by index so the order is total — required by the Karras
    topology's duplicate-code handling (builder/lbvh.py).
    """
    n = codes.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    sorted_codes, perm = jax.lax.sort((codes, idx), num_keys=2)
    return sorted_codes, perm


def ray_coherence_key(origin: Array, direction: Array) -> Array:
    """Spatial-coherence sort key for a ray batch (uint32, 30 bits).

    Morton code of a probe point pushed along each ray: for shared-origin
    batches (camera primaries) the probes spread over a sphere patch, so
    the key orders rays by direction; for scattered origins (bounce
    batches) origin locality dominates and direction refines it.  Packets
    of sort-adjacent rays then traverse nearly identical BVH node sets,
    which is what the packet kernel's union traversal wants.
    """
    o = jnp.asarray(origin, jnp.float32)
    d = jnp.asarray(direction, jnp.float32)
    dn = d / jnp.maximum(
        jnp.linalg.norm(d, axis=1, keepdims=True), jnp.float32(1e-30))
    o_lo = jnp.min(o, axis=0)
    o_hi = jnp.max(o, axis=0)
    diag = jnp.linalg.norm(o_hi - o_lo)
    scale = jnp.maximum(
        0.5 * diag, 1e-2 * (1.0 + jnp.max(jnp.abs(o_hi))))
    probe = o + dn * scale
    p_lo = jnp.min(probe, axis=0)
    p_hi = jnp.max(probe, axis=0)
    return morton3d(probe, p_lo, p_hi, bits=10)
