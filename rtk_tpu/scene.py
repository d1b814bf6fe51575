"""Scene: the device-resident acceleration structure (a pytree of SoA arrays).

The reference's scene is a single relocatable blob of BVH4 nodes + packed
leaves + deduped vertices (rtk.h:78-89, rtk.c:64-106).  Here it is
a pytree of dense arrays: wide SoA nodes, plus triangle data laid out in
traversal (Morton-sorted) order so every leaf is a contiguous slice — the
functional analogue of rtk's 64-byte-aligned leaf records.  Serialization to
an rtk-style versioned container lives in rtk_tpu/utils/serialize.py.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from rtk_tpu.pytree import pytree_dataclass, static_field

from rtk_tpu.builder.collapse import collapse_wide, gather_slot_bounds
from rtk_tpu.builder.lbvh import (karras_topology_scan, leaf_code,
                                  refit_ranges_flat)
from rtk_tpu.config import BuildConfig

Array = jax.Array


@pytree_dataclass
class Scene:
    """Built acceleration structure + geometry, all device arrays."""

    # Wide BVH (SoA). Row 0 is the root. Child encoding: >=0 wide node id,
    # -1 empty, <=-2 leaf id -(c)-2. Leaves are contiguous triangle ranges
    # [id*leaf_size, id*leaf_size + count).
    # node_child slot values are *binary* node ids (rows are binary-indexed,
    # see builder/collapse.py), so node_child doubles as the refit source.
    node_child: Array  # (Nn, W) i32
    node_min: Array  # (Nn, W, 3) f32
    node_max: Array  # (Nn, W, 3) f32
    # Binary topology + bounds kept for refit and for kernel-table packing
    # (leaf bounds -> binary refit -> wide/packed regather).
    bin_left: Array  # (Li,) i32
    bin_right: Array  # (Li,) i32
    bin_lo: Array  # (Li,) i32 first leaf of the node's contiguous range
    bin_hi: Array  # (Li,) i32 last leaf (refit runs as RMQ over these)
    bin_min: Array  # (Li, 3) f32
    bin_max: Array  # (Li, 3) f32
    leaf_min: Array  # (L, 3) f32
    leaf_max: Array  # (L, 3) f32
    # Triangles in traversal (Morton-sorted) order, padded to L*leaf_size.
    tri_v: Array  # (Tp, 3, 3) f32
    tri_vidx: Array  # (Tp, 3) i32 original vertex indices
    tri_mesh: Array  # (Tp,) i32
    tri_prim: Array  # (Tp,) i32
    perm: Array  # (Tp,) i32 sorted slot -> original soup index (-1 pad)
    bounds_min: Array  # (3,) f32
    bounds_max: Array  # (3,) f32
    # Static metadata.
    num_tris: int = static_field()
    leaf_size: int = static_field()
    branching: int = static_field()
    num_leaves: int = static_field()
    # BuildConfig(wide_nodes=False) skips the wide collapse (the packet
    # kernel derives its tables from the binary topology); node_child/
    # node_min/node_max are then 1-row dummies and the XLA stack engines
    # refuse the scene (trace/stack.py guard).
    has_wide: bool = static_field(default=True)

    @property
    def num_padded_tris(self) -> int:
        return self.tri_v.shape[0]


def _leaf_bounds(tri_v: Array, num_tris: int, leaf_size: int):
    """Masked per-leaf AABBs over chunks of sorted triangles.

    Reduces per component over (n_leaf, leaf_size*3) tiles, component-major
    (the reduced axis is the wide one)."""
    tp = tri_v.shape[0]
    n_leaf = tp // leaf_size
    valid = (jnp.arange(tp) < num_tris)[:, None]
    mins, maxs = [], []
    for c in range(3):
        comp = tri_v[:, :, c]  # (Tp, 3)
        lo = jnp.where(valid, comp, jnp.inf).reshape(n_leaf, leaf_size * 3)
        hi = jnp.where(valid, comp, -jnp.inf).reshape(n_leaf, leaf_size * 3)
        mins.append(jnp.min(lo, axis=1))
        maxs.append(jnp.max(hi, axis=1))
    return jnp.stack(mins, axis=1), jnp.stack(maxs, axis=1)


@functools.partial(jax.jit, static_argnames=("num_tris", "leaf_size", "branching", "morton_bits", "wide"))
def _build_impl(tri_pos, tri_vidx, tri_mesh, tri_prim, codes=None, *,
                num_tris, leaf_size, branching, morton_bits, wide=True):
    # SoA internals: every stage below runs on flat (T,) component
    # arrays, and the payload rides the ONE lax.sort as extra operands
    # instead of post-sort gathers.  Whether that split suits the GPU
    # (where gathers are cheap) is not measured yet.
    t = num_tris
    # Default metadata (vidx = arange pattern, mesh = 0, prim = arange)
    # NEVER rides the sort: it is a pure function of the permutation, so
    # the sorted forms derive elementwise from perm afterwards — 5 fewer
    # sort operands (~20 ms at 5.24M).  Custom metadata still sorts.
    defaults = tri_vidx is None and tri_mesh is None and tri_prim is None
    if not defaults:
        if tri_vidx is None:
            tri_vidx = (jnp.arange(t, dtype=jnp.int32)[:, None] * 3
                        + jnp.arange(3, dtype=jnp.int32)[None, :])
        if tri_mesh is None:
            tri_mesh = jnp.zeros((t,), jnp.int32)
        if tri_prim is None:
            tri_prim = jnp.arange(t, dtype=jnp.int32)
    n_leaf = max(1, -(-t // leaf_size))
    tp = n_leaf * leaf_size

    comps = [tri_pos[:, a, c] for a in range(3) for c in range(3)]
    los = [jnp.min(jnp.minimum(jnp.minimum(comps[c], comps[3 + c]),
                               comps[6 + c])) for c in range(3)]
    his = [jnp.max(jnp.maximum(jnp.maximum(comps[c], comps[3 + c]),
                               comps[6 + c])) for c in range(3)]
    lo = jnp.stack(los)
    hi = jnp.stack(his)
    if codes is None:
        # Default spatial keys; callers may pass custom sort keys instead
        # (e.g. the macro-grid engine's cell-prefixed local Morton codes,
        # trace/grid.py, which make every cell an exact Karras subtree).
        from rtk_tpu.ops.morton import expand_bits10
        scale = jnp.float32((1 << morton_bits) - 1)
        shift = 10 - morton_bits
        exs = []
        for c in range(3):
            cc = (comps[c] + comps[3 + c] + comps[6 + c]) * (1.0 / 3.0)
            ext = jnp.maximum(his[c] - los[c], jnp.float32(1e-30))
            q = jnp.clip((cc - los[c]) / ext * scale, 0.0, scale)
            qi = q.astype(jnp.uint32)
            exs.append(expand_bits10(qi << shift if shift else qi))
        codes = (exs[0] << 2) | (exs[1] << 1) | exs[2]

    idx = jnp.arange(t, dtype=jnp.int32)
    if defaults:
        sorted_ops = jax.lax.sort((codes, idx, *comps), num_keys=2)
        sort_codes, perm = sorted_ops[0], sorted_ops[1]
        scomps = list(sorted_ops[2:11])
    else:
        sorted_ops = jax.lax.sort(
            (codes, idx, *comps, tri_vidx[:, 0], tri_vidx[:, 1],
             tri_vidx[:, 2], tri_mesh, tri_prim), num_keys=2)
        sort_codes, perm = sorted_ops[0], sorted_ops[1]
        scomps = list(sorted_ops[2:11])
        svidx = list(sorted_ops[11:14])
        smesh, sprim = sorted_ops[14], sorted_ops[15]

    pad = tp - t
    if pad:
        zpad = jnp.zeros((pad,), jnp.float32)
        mpad = jnp.full((pad,), -1, jnp.int32)
        scomps = [jnp.concatenate([c, zpad]) for c in scomps]
        if not defaults:
            svidx = [jnp.concatenate([v, mpad]) for v in svidx]
            smesh = jnp.concatenate([smesh, mpad])
            sprim = jnp.concatenate([sprim, mpad])
        perm = jnp.concatenate([perm, mpad])
    if defaults:
        valid_row = perm >= 0
        sprim = jnp.where(valid_row, perm, -1)
        smesh = jnp.where(valid_row, 0, -1)
        svidx = [jnp.where(valid_row, perm * 3 + j, -1) for j in range(3)]

    # Per-leaf AABBs from the sorted components: a (L, K) reshape-reduce
    # per component (no gathers, no padded tiles).
    valid = jnp.arange(tp) < t
    lmins, lmaxs = [], []
    for c in range(3):
        m = jnp.minimum(jnp.minimum(scomps[c], scomps[3 + c]),
                        scomps[6 + c])
        M = jnp.maximum(jnp.maximum(scomps[c], scomps[3 + c]),
                        scomps[6 + c])
        m = jnp.where(valid, m, jnp.inf)
        M = jnp.where(valid, M, -jnp.inf)
        lmins.append(jnp.min(m.reshape(n_leaf, leaf_size), axis=1))
        lmaxs.append(jnp.max(M.reshape(n_leaf, leaf_size), axis=1))
    leaf_min = jnp.stack(lmins, axis=1)
    leaf_max = jnp.stack(lmaxs, axis=1)

    sort_v = jnp.stack([jnp.stack(scomps[3 * a:3 * a + 3], axis=1)
                        for a in range(3)], axis=1)
    sort_vidx = jnp.stack(list(svidx), axis=1)
    sort_mesh = smesh
    sort_prim = sprim

    if n_leaf == 1:
        # Degenerate scene: a single wide root with one leaf child.
        w = branching
        node_child = jnp.full((1, w), -1, jnp.int32).at[0, 0].set(leaf_code(0))
        node_min = jnp.full((1, w, 3), 1.0, jnp.float32).at[0, 0].set(leaf_min[0])
        node_max = jnp.full((1, w, 3), -1.0, jnp.float32).at[0, 0].set(leaf_max[0])
        bin_left = jnp.full((1,), leaf_code(0), jnp.int32)
        bin_right = jnp.full((1,), -1, jnp.int32)  # empty slot
        bin_lo = jnp.zeros((1,), jnp.int32)
        bin_hi = jnp.zeros((1,), jnp.int32)
        bmin, bmax = leaf_min, leaf_max
    else:
        cluster_codes = sort_codes[::leaf_size] if leaf_size > 1 else sort_codes
        bin_left, bin_right, bin_lo, bin_hi = karras_topology_scan(
            cluster_codes)
        bmin, bmax = refit_ranges_flat(bin_lo, bin_hi, leaf_min, leaf_max)
        if wide:
            node_child, node_min, node_max = collapse_wide(
                bin_left, bin_right, bmin, bmax, leaf_min, leaf_max,
                branching)
        else:
            # Dummy 1-row wide arrays; Scene.has_wide=False gates users.
            node_child = jnp.full((1, branching), -1, jnp.int32)
            node_min = jnp.full((1, branching, 3), 1.0, jnp.float32)
            node_max = jnp.full((1, branching, 3), -1.0, jnp.float32)

    return dict(
        node_child=node_child,
        node_min=node_min,
        node_max=node_max,
        bin_left=bin_left,
        bin_right=bin_right,
        bin_lo=bin_lo,
        bin_hi=bin_hi,
        bin_min=bmin,
        bin_max=bmax,
        leaf_min=leaf_min,
        leaf_max=leaf_max,
        tri_v=sort_v,
        tri_vidx=sort_vidx,
        tri_mesh=sort_mesh,
        tri_prim=sort_prim,
        perm=perm,
        bounds_min=lo,
        bounds_max=hi,
    )


def build_from_soup(tri_pos, tri_vidx=None, tri_mesh=None, tri_prim=None,
                    config: BuildConfig = BuildConfig(),
                    codes=None) -> Scene:
    """Build a Scene from canonical triangle-soup arrays (device build).

    codes: optional (T,) uint32 custom sort keys replacing the default
    Morton codes (the Karras topology then reflects THEIR prefix
    hierarchy — used by the macro-grid engine's cell-major builds)."""
    tri_pos = jnp.asarray(tri_pos, jnp.float32)
    t = tri_pos.shape[0]
    if t == 0:
        raise ValueError("cannot build an empty scene")
    cvt = lambda a, dt: None if a is None else jnp.asarray(a, dt)
    arrays = _build_impl(
        tri_pos,
        cvt(tri_vidx, jnp.int32),
        cvt(tri_mesh, jnp.int32),
        cvt(tri_prim, jnp.int32),
        cvt(codes, jnp.uint32),
        num_tris=t,
        leaf_size=config.leaf_size,
        branching=config.branching,
        morton_bits=config.morton_bits,
        wide=config.wide_nodes,
    )
    n_leaf = max(1, -(-t // config.leaf_size))
    return Scene(
        num_tris=t,
        leaf_size=config.leaf_size,
        branching=config.branching,
        num_leaves=n_leaf,
        has_wide=config.wide_nodes or n_leaf == 1,
        **arrays,
    )


@functools.partial(jax.jit, static_argnames=("num_tris", "leaf_size", "has_wide"))
def _refit_impl(scene_arrays, new_tri_pos, *, num_tris, leaf_size,
                has_wide=True):
    """Re-gather vertices in sorted order and refit all bounds, keeping the
    topology. The reference has no refit (it rebuilds); this is the dynamic
    -scene entry the BASELINE deforming-mesh config requires."""
    perm = scene_arrays["perm"]
    safe = jnp.clip(perm, 0, num_tris - 1)
    gathered = jnp.take(new_tri_pos, safe, axis=0)
    sort_v = jnp.where((perm >= 0)[:, None, None], gathered, 0.0)
    leaf_min, leaf_max = _leaf_bounds(sort_v, num_tris, leaf_size)
    n_leaf = leaf_min.shape[0]
    if n_leaf == 1:
        node_min = scene_arrays["node_min"].at[0, 0].set(leaf_min[0])
        node_max = scene_arrays["node_max"].at[0, 0].set(leaf_max[0])
        bmin, bmax = leaf_min, leaf_max
    else:
        bmin, bmax = refit_ranges_flat(
            scene_arrays["bin_lo"], scene_arrays["bin_hi"],
            leaf_min, leaf_max)
        if has_wide:
            node_min, node_max = gather_slot_bounds(
                scene_arrays["node_child"], bmin, bmax, leaf_min,
                leaf_max)
        else:
            node_min = scene_arrays["node_min"]
            node_max = scene_arrays["node_max"]
    lo = jnp.min(leaf_min, axis=0)
    hi = jnp.max(leaf_max, axis=0)
    return dict(node_min=node_min, node_max=node_max,
                tri_v=sort_v, bounds_min=lo, bounds_max=hi,
                bin_min=bmin, bin_max=bmax,
                leaf_min=leaf_min, leaf_max=leaf_max)


def refit(scene: Scene, new_tri_pos) -> Scene:
    """Refit an existing Scene to deformed geometry (same topology).

    new_tri_pos: (T, 3, 3) triangle vertices in the *original soup order*
    (same order as passed to build_from_soup).
    """
    new_tri_pos = jnp.asarray(new_tri_pos, jnp.float32)
    updates = _refit_impl(
        dict(
            perm=scene.perm,
            bin_lo=scene.bin_lo,
            bin_hi=scene.bin_hi,
            node_child=scene.node_child,
            node_min=scene.node_min,
            node_max=scene.node_max,
        ),
        new_tri_pos,
        num_tris=scene.num_tris,
        leaf_size=scene.leaf_size,
        has_wide=scene.has_wide,
    )
    return dataclasses.replace(scene, **updates)
