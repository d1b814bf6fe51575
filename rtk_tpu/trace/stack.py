"""Batched ordered BVH traversal (closest-hit and any-hit).

The reference traces one ray at a time with a recursive-style stack loop
(rtk.c:390-539).  Here a whole ray batch steps in lockstep through a
`lax.while_loop`; every ray carries its own short stack in a (N, D) array.
Each iteration performs, per ray:

  1. a pop phase: rays whose current node is consumed (-1) or culled
     (entry t >= closest hit t, the pop-cull of rtk.c:432-437) pop their
     stack; rays with empty stacks finish;
  2. a leaf phase: rays at a leaf intersect its <=K contiguous triangles
     with the watertight kernel (the analogue of rtk.c:181-388, but K
     triangles per ray across N rays = dense vector work);
  3. an internal phase: rays at a wide node slab-test all W children at
     once (rtk.c:449-473 does 4; we do W in {2,4,8}), sort the hits
     near-to-far with a compare-exchange network (the in-register sorting
     network of rtk.c:489-536, vectorised across rays), descend to the
     nearest child and push the rest with their entry t for pop-culling.

The loop ends when every ray has finished (plus an optional safety bound).
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from rtk_tpu.pytree import pytree_dataclass

from rtk_tpu.config import TraceConfig
from rtk_tpu.ops.intersect import (
    intersect_triangles,
    ray_shear,
    rcp_direction,
    slab_test,
)
from rtk_tpu.scene import Scene
from rtk_tpu.types import Hits, Rays

Array = jax.Array

import numpy as np

F32_INF = np.float32(np.inf)  # host-side: avoid device-resident constants

# Batcher odd-even merge sorting networks (ascending).
_NETWORKS = {
    2: [(0, 1)],
    4: [(0, 1), (2, 3), (0, 2), (1, 3), (1, 2)],
    8: [
        (0, 1), (2, 3), (4, 5), (6, 7),
        (0, 2), (1, 3), (4, 6), (5, 7),
        (1, 2), (5, 6),
        (0, 4), (1, 5), (2, 6), (3, 7),
        (2, 4), (3, 5),
        (1, 2), (3, 4), (5, 6),
    ],
}


@pytree_dataclass
class HitCandidate:
    """Per-lane candidate passed to any-hit filter callables.

    The functional analogue of rtk_filter_fn (rtk.h:117): the filter sees the
    candidate hit and returns True to accept it.  All fields are (N, K).
    """

    t: Array
    u: Array
    v: Array
    mesh_index: Array
    triangle_index: Array
    ray_index: Array


def _sort_w(ts, children, w):
    """Sort W (t, child) pairs per ray ascending by t (vector comparators)."""
    t_cols = [ts[:, i] for i in range(w)]
    c_cols = [children[:, i] for i in range(w)]
    for (a, b) in _NETWORKS[w]:
        swap = t_cols[a] > t_cols[b]
        ta = jnp.where(swap, t_cols[b], t_cols[a])
        tb = jnp.where(swap, t_cols[a], t_cols[b])
        ca = jnp.where(swap, c_cols[b], c_cols[a])
        cb = jnp.where(swap, c_cols[a], c_cols[b])
        t_cols[a], t_cols[b] = ta, tb
        c_cols[a], c_cols[b] = ca, cb
    return t_cols, c_cols


def _trace_loop(scene: Scene, rays: Rays, *, mode: str,
                filter_fn: Optional[Callable], config: TraceConfig,
                start_node=None, init_hit_t=None, return_slot=False):
    if not scene.has_wide:
        raise ValueError(
            "scene was built with BuildConfig(wide_nodes=False); the XLA "
            "stack engine needs the wide node arrays — rebuild with "
            "wide_nodes=True (the packet engine works either way)")
    n = rays.count
    w = scene.branching
    d = config.max_stack
    t_count = scene.num_tris
    k = scene.leaf_size
    tp = scene.num_padded_tris
    n_nodes = scene.node_child.shape[0]

    origin = rays.origin
    min_t = rays.min_t
    shear = ray_shear(rays.direction)
    rcp = rcp_direction(rays.direction)
    rows = jnp.arange(n, dtype=jnp.int32)
    lane = jnp.arange(k, dtype=jnp.int32)

    if start_node is None:
        start_node = jnp.zeros((n,), jnp.int32)  # root = wide node 0
    state = dict(
        cur=jnp.asarray(start_node, jnp.int32),
        cur_t=jnp.full((n,), -jnp.inf, jnp.float32),  # rtk.c:399
        sp=jnp.zeros((n,), jnp.int32),
        stack_node=jnp.zeros((n, d), jnp.int32),
        stack_t=jnp.zeros((n, d), jnp.float32),
        hit_t=rays.max_t if init_hit_t is None else init_hit_t,  # rtk.c:548
        hit_u=jnp.zeros((n,), jnp.float32),
        hit_v=jnp.zeros((n,), jnp.float32),
        hit_slot=jnp.full((n,), -1, jnp.int32),
        finished=jnp.zeros((n,), bool),
        steps=jnp.int32(0),
    )

    def cond(st):
        go = jnp.any(~st["finished"])
        if config.max_steps:
            go = go & (st["steps"] < config.max_steps)
        return go

    def body(st):
        cur, cur_t, sp = st["cur"], st["cur_t"], st["sp"]
        stack_node, stack_t = st["stack_node"], st["stack_t"]
        hit_t = st["hit_t"]
        finished = st["finished"]

        # ---- pop phase (rtk.c:432-437 including pop-culling) ----
        need = (cur == -1) | (cur_t >= hit_t)
        can = sp > 0
        do_pop = need & can
        finished = finished | (need & ~can)
        spm1 = jnp.maximum(sp - 1, 0)
        popped_n = stack_node[rows, spm1]
        popped_t = stack_t[rows, spm1]
        cur = jnp.where(do_pop, popped_n, jnp.where(need, -1, cur))
        cur_t = jnp.where(do_pop, popped_t, jnp.where(need, F32_INF, cur_t))
        sp = jnp.where(do_pop, spm1, sp)

        active = (cur_t < hit_t) & ~finished
        is_leaf = active & (cur <= -2)
        is_int = active & (cur >= 0)

        # ---- leaf phase (rtk.c:181-388) ----
        lid = -cur - 2
        start = jnp.where(is_leaf, lid * k, 0)
        count = jnp.clip(t_count - start, 0, k)
        tidx = jnp.clip(start[:, None] + lane[None, :], 0, tp - 1)
        tv = jnp.take(scene.tri_v, tidx, axis=0)  # (N, K, 3, 3)
        t, u, v, valid = intersect_triangles(
            origin, shear, tv, min_t, hit_t, watertight=config.watertight)
        valid = valid & (lane[None, :] < count[:, None]) & is_leaf[:, None]
        if filter_fn is not None:
            cand = HitCandidate(
                t=t, u=u, v=v,
                mesh_index=jnp.take(scene.tri_mesh, tidx, axis=0),
                triangle_index=jnp.take(scene.tri_prim, tidx, axis=0),
                ray_index=jnp.broadcast_to(rows[:, None], (n, k)),
            )
            valid = valid & filter_fn(cand)
        tl = jnp.where(valid, t, F32_INF)
        kb = jnp.argmin(tl, axis=1)  # ties: first lane, like rtk.c:366-385
        tb = jnp.take_along_axis(tl, kb[:, None], axis=1)[:, 0]
        improved = tb < hit_t  # strict (rtk.c:371)
        hit_t = jnp.where(improved, tb, hit_t)
        pick = lambda a: jnp.take_along_axis(a, kb[:, None], axis=1)[:, 0]
        hit_u = jnp.where(improved, pick(u), st["hit_u"])
        hit_v = jnp.where(improved, pick(v), st["hit_v"])
        hit_slot = jnp.where(improved, pick(tidx), st["hit_slot"])
        cur = jnp.where(is_leaf, -1, cur)  # consume leaf (rtk.c:443)
        if mode == "any":
            # First accepted hit terminates the ray.
            finished = finished | improved
            sp = jnp.where(improved, 0, sp)
            cur = jnp.where(improved, -1, cur)

        # ---- internal phase (rtk.c:449-536) ----
        nid = jnp.clip(cur, 0, n_nodes - 1)
        cmin = jnp.take(scene.node_min, nid, axis=0)  # (N, W, 3)
        cmax = jnp.take(scene.node_max, nid, axis=0)
        cch = jnp.take(scene.node_child, nid, axis=0)  # (N, W)
        ts, hitm = slab_test(cmin, cmax, origin, rcp, min_t, hit_t)
        kcount = jnp.sum(hitm, axis=1).astype(jnp.int32)
        t_cols, c_cols = _sort_w(ts, cch, w)
        has = is_int & (kcount > 0)
        new_cur = jnp.where(has, c_cols[0], -1)
        new_cur_t = jnp.where(has, t_cols[0], F32_INF)
        # Push children 1..kcount-1 far-to-near so nearest pops first.
        for i in range(1, w):
            wmask = is_int & (i < kcount)
            pos = sp + (kcount - 1 - i)
            col = jnp.where(wmask, pos, d)  # out of range -> dropped
            stack_node = stack_node.at[rows, col].set(c_cols[i], mode="drop")
            stack_t = stack_t.at[rows, col].set(t_cols[i], mode="drop")
        sp = jnp.where(is_int, sp + jnp.maximum(kcount - 1, 0), sp)
        cur = jnp.where(is_int, new_cur, cur)
        cur_t = jnp.where(is_int, new_cur_t, cur_t)

        return dict(
            cur=cur, cur_t=cur_t, sp=sp,
            stack_node=stack_node, stack_t=stack_t,
            hit_t=hit_t, hit_u=hit_u, hit_v=hit_v, hit_slot=hit_slot,
            finished=finished, steps=st["steps"] + 1,
        )

    st = jax.lax.while_loop(cond, body, state)

    hit = st["hit_slot"] >= 0
    safe = jnp.clip(st["hit_slot"], 0, tp - 1)
    hits = Hits(
        hit=hit,
        t=st["hit_t"],  # == ray.max_t when no hit (only ever decreases)
        u=jnp.where(hit, st["hit_u"], 0.0),
        v=jnp.where(hit, st["hit_v"], 0.0),
        mesh_index=jnp.where(hit, jnp.take(scene.tri_mesh, safe), -1),
        triangle_index=jnp.where(hit, jnp.take(scene.tri_prim, safe), -1),
        vertex_position=jnp.where(
            hit[:, None, None], jnp.take(scene.tri_v, safe, axis=0), 0.0),
        vertex_index=jnp.where(
            hit[:, None], jnp.take(scene.tri_vidx, safe, axis=0), -1),
    )
    if return_slot:
        # internal sorted-scene slot (consumers map it onwards, e.g. the
        # instanced residual path -> packed slot)
        return hits, st["hit_slot"]
    return hits


@functools.partial(
    jax.jit,
    static_argnames=("mode", "filter_fn", "max_stack", "watertight",
                     "max_steps"),
)
def _trace_jit(scene, rays, mode, filter_fn, max_stack, watertight, max_steps):
    cfg = TraceConfig(max_stack=max_stack, watertight=watertight,
                      max_steps=max_steps)
    return _trace_loop(scene, rays, mode=mode, filter_fn=filter_fn, config=cfg)


def trace_closest(scene: Scene, rays: Rays,
                  filter_fn: Optional[Callable] = None,
                  config: TraceConfig = TraceConfig()) -> Hits:
    """Nearest-hit trace (parity: rtk_trace_ray, rtk.c:543-577)."""
    return _trace_jit(scene, rays, "closest", filter_fn,
                      config.max_stack, config.watertight, config.max_steps)


def trace_any(scene: Scene, rays: Rays,
              filter_fn: Optional[Callable] = None,
              config: TraceConfig = TraceConfig()) -> Hits:
    """Any-hit trace: stops at the first accepted hit per ray.

    Implements the semantics rtk_trace_ray_filter promises but stubs out
    (rtk.c:579-582 returns true unconditionally — SURVEY §2.9.1)."""
    return _trace_jit(scene, rays, "any", filter_fn,
                      config.max_stack, config.watertight, config.max_steps)
