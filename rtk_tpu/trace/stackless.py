"""Stackless skip-link traversal — the incoherent-ray engine.

An XLA engine in which every ray advances independently through a
linearised tree, so total work is proportional to the sum of per-ray
visits, at the cost of per-ray gathers.  It needs no stack.

Layout: the binary LBVH is linearised in DFS preorder into one entity
table.  An entity is either an internal node (child AABB + skip link) or an
inline triangle (vertices + hit slot).  Traversal per step:

    hit internal node  -> next = cur + 1   (first child is adjacent)
    missed internal    -> next = skip      (jump over the subtree)
    triangle           -> test, next = cur + 1
    cur == E           -> done

This is rtk's stack traversal turned inside-out: instead of pushing the
far child (rtk.c:519-536), the DFS order plus skip links encode the whole
control flow in data, so the per-ray state is a single int.  t-culling
still happens at every box test against the running closest hit.

The preorder/skip computation runs on device as fixpoint sweeps (build and
refit stay jittable end to end).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from rtk_tpu.pytree import pytree_dataclass, static_field

from rtk_tpu.scene import Scene
from rtk_tpu.types import Hits, Rays

Array = jax.Array

ROW_I32 = 16  # internal: [min(3) max(3) skip kind 0...]; tri: [v0 v1 v2 (9) slot kind ...]
KIND_COL = 10
SKIP_COL = 6
SLOT_COL = 9


@pytree_dataclass
class StacklessScene:
    entities: Array  # (E, 16) i32 rows (f32 payloads bitcast)
    # Hit assembly uses the Scene's sorted tri arrays (slot indexes them).
    tri_v: Array
    tri_vidx: Array
    tri_mesh: Array
    tri_prim: Array
    num_tris: int = static_field()

    @property
    def num_entities(self) -> int:
        return self.entities.shape[0]


@functools.partial(jax.jit, static_argnames=("n_leaf", "leaf_size"))
def _linearise(bin_left, bin_right, bin_min, bin_max, tri_v, *, n_leaf,
               leaf_size):
    """DFS-preorder entity table from the binary topology (all on device)."""
    n_int = bin_left.shape[0]
    k = leaf_size

    def child_size(child, sizes):
        leaf = child <= -2
        ni = jnp.clip(child, 0, n_int - 1)
        return jnp.where(leaf, k, jnp.take(sizes, ni)), (child >= 0)

    # Subtree sizes (in entities), bottom-up fixpoint: passes == height.
    def size_body(state):
        sizes, valid = state
        ls, l_int = child_size(bin_left, sizes)
        rs, r_int = child_size(bin_right, sizes)
        lv = jnp.where(l_int, jnp.take(valid, jnp.clip(bin_left, 0, n_int - 1)),
                       True)
        rv = jnp.where(r_int, jnp.take(valid, jnp.clip(bin_right, 0, n_int - 1)),
                       True)
        ok = lv & rv
        new = 1 + ls + jnp.where(bin_right == -1, 0, rs)
        sizes = jnp.where(ok, new, sizes)
        return sizes, valid | ok

    sizes, _ = jax.lax.while_loop(
        lambda s: ~s[1][0],
        size_body,
        (jnp.zeros((n_int,), jnp.int32), jnp.zeros((n_int,), bool)),
    )

    # Preorder index, top-down fixpoint: idx(left) = idx+1,
    # idx(right) = idx + 1 + size(left).
    def idx_body(state):
        idx, valid = state
        lsz, _ = child_size(bin_left, sizes)
        li = jnp.where(bin_left >= 0, bin_left, n_int)
        ri = jnp.where(bin_right >= 0, bin_right, n_int)
        src_ok = valid
        idx = idx.at[li].set(jnp.where(src_ok, idx + 1, 0), mode="drop")
        idx = idx.at[ri].set(jnp.where(src_ok, idx + 1 + lsz, 0), mode="drop")
        valid = valid.at[li].set(src_ok, mode="drop") | valid
        valid = valid.at[ri].set(src_ok, mode="drop") | valid
        return idx, valid

    def idx_cond(state):
        return ~jnp.all(state[1])

    idx0 = jnp.zeros((n_int,), jnp.int32)
    valid0 = jnp.zeros((n_int,), bool).at[0].set(True)
    idx, _ = jax.lax.while_loop(idx_cond, idx_body, (idx0, valid0))

    total = 1 + sizes[0] - 1 + 0  # size of root subtree == all entities
    e_count = n_leaf * k + n_int  # static

    # Internal entity rows.
    skip = idx + sizes
    bmin_i = jax.lax.bitcast_convert_type(bin_min, jnp.int32)
    bmax_i = jax.lax.bitcast_convert_type(bin_max, jnp.int32)
    int_rows = jnp.concatenate(
        [bmin_i, bmax_i, skip[:, None], jnp.zeros((n_int, 1), jnp.int32),
         jnp.zeros((n_int, ROW_I32 - 8), jnp.int32)],
        axis=1)

    # Triangle entity rows: leaf at binary child -> entities idx..idx+k-1.
    # Leaf preorder index: gather from whichever parent references it.
    leaf_idx = jnp.zeros((n_leaf,), jnp.int32)
    for child, extra in ((bin_left, 1), (bin_right, None)):
        is_leaf = child <= -2
        lid = jnp.where(is_leaf, -child - 2, n_leaf)
        lsz, _ = child_size(bin_left, sizes)
        if extra is None:
            pos = idx + 1 + lsz  # right child position
        else:
            pos = idx + 1
        leaf_idx = leaf_idx.at[lid].set(jnp.where(is_leaf, pos, 0),
                                        mode="drop")
    if n_leaf == 1 and True:
        # Single-leaf scenes: root's left child is the leaf at position 1...
        # handled by the general code only when n_int >= 1; for the L==1
        # Scene the binary arrays are (leaf_code(0), -1) so the loop above
        # already set leaf_idx[0] = 1.
        pass

    tp = tri_v.shape[0]
    flat = tri_v.reshape(tp, 9)
    tri_i = jax.lax.bitcast_convert_type(flat, jnp.int32)
    slots = jnp.arange(tp, dtype=jnp.int32)
    tri_rows = jnp.concatenate(
        [tri_i, slots[:, None], jnp.ones((tp, 1), jnp.int32),
         jnp.zeros((tp, ROW_I32 - 11), jnp.int32)],
        axis=1)

    entities = jnp.zeros((e_count, ROW_I32), jnp.int32)
    entities = entities.at[idx].set(int_rows, mode="drop")
    tri_pos = (leaf_idx[:, None]
               + jnp.arange(k, dtype=jnp.int32)[None, :]).reshape(-1)
    entities = entities.at[tri_pos].set(tri_rows, mode="drop")
    return entities


def build_stackless(scene: Scene) -> StacklessScene:
    """Linearise a built Scene for stackless traversal."""
    if scene.num_leaves == 1:
        # One leaf, no internal node: synthesise a root box entity.
        k = scene.leaf_size
        tp = scene.tri_v.shape[0]
        bmin = jax.lax.bitcast_convert_type(scene.bounds_min, jnp.int32)
        bmax = jax.lax.bitcast_convert_type(scene.bounds_max, jnp.int32)
        root = jnp.concatenate(
            [bmin, bmax, jnp.asarray([1 + k, 0], jnp.int32),
             jnp.zeros((ROW_I32 - 8,), jnp.int32)])[None]
        flat = scene.tri_v.reshape(tp, 9)
        tri_i = jax.lax.bitcast_convert_type(flat, jnp.int32)
        slots = jnp.arange(tp, dtype=jnp.int32)
        tri_rows = jnp.concatenate(
            [tri_i, slots[:, None], jnp.ones((tp, 1), jnp.int32),
             jnp.zeros((tp, ROW_I32 - 11), jnp.int32)], axis=1)
        entities = jnp.concatenate([root, tri_rows], axis=0)
    else:
        entities = _linearise(
            scene.bin_left, scene.bin_right, scene.bin_min, scene.bin_max,
            scene.tri_v, n_leaf=scene.num_leaves, leaf_size=scene.leaf_size)
    return StacklessScene(
        entities=entities,
        tri_v=scene.tri_v,
        tri_vidx=scene.tri_vidx,
        tri_mesh=scene.tri_mesh,
        tri_prim=scene.tri_prim,
        num_tris=scene.num_tris,
    )


@functools.partial(jax.jit, static_argnames=("mode", "watertight",
                                             "compact_every"))
def _trace_stackless_impl(entities, rays_o, rays_d, min_t, max_t, *,
                          mode="closest", watertight=True, compact_every=0):
    from rtk_tpu.ops.intersect import ray_shear, watertight_uvw

    n = rays_o.shape[0]
    e_count = entities.shape[0]

    shear = ray_shear(rays_d)
    rcp_raw = 1.0 / rays_d
    big = jnp.where(rays_d >= 0, 3.0e38, -3.0e38).astype(jnp.float32)
    rcp = jnp.where(rays_d == 0.0, big, rcp_raw)

    def axis_sel(kidx, a):
        return jnp.where(kidx == 0, a[:, 0],
                         jnp.where(kidx == 1, a[:, 1], a[:, 2]))

    o_kx = axis_sel(shear.kx, rays_o)
    o_ky = axis_sel(shear.ky, rays_o)
    o_kz = axis_sel(shear.kz, rays_o)

    state = dict(
        cur=jnp.zeros((n,), jnp.int32),
        hit_t=max_t,
        hit_u=jnp.zeros((n,), jnp.float32),
        hit_v=jnp.zeros((n,), jnp.float32),
        hit_slot=jnp.full((n,), -1, jnp.int32),
    )

    def cond(st):
        return jnp.any(st["cur"] < e_count)

    def body(st):
        cur = st["cur"]
        hit_t = st["hit_t"]
        safe = jnp.clip(cur, 0, e_count - 1)
        rows = jnp.take(entities, safe, axis=0)  # (N, 16) i32
        fr = jax.lax.bitcast_convert_type(rows[:, :9], jnp.float32)
        kind = rows[:, KIND_COL]
        done = cur >= e_count
        is_tri = (kind == 1) & ~done
        is_node = (kind == 0) & ~done

        # --- internal: single-slab test (sign-selected planes) ---
        pos = rcp >= 0
        lo = fr[:, 0:3]
        hi = fr[:, 3:6]
        near = (jnp.where(pos, lo, hi) - rays_o) * rcp
        far = (jnp.where(pos, hi, lo) - rays_o) * rcp
        enter = jnp.maximum(jnp.maximum(near[:, 0], near[:, 1]),
                            jnp.maximum(near[:, 2], min_t))
        exit_ = jnp.minimum(jnp.minimum(far[:, 0], far[:, 1]),
                            jnp.minimum(far[:, 2], hit_t))
        box_hit = enter <= exit_

        # --- triangle: watertight shear-space test ---
        xs, ys, zs = [], [], []
        for j in range(3):
            v = fr[:, 3 * j:3 * j + 3] - rays_o
            px = axis_sel(shear.kx, v)
            py = axis_sel(shear.ky, v)
            pz = axis_sel(shear.kz, v)
            xs.append(px + shear.sx * pz)
            ys.append(py + shear.sy * pz)
            zs.append(shear.sz * pz)
        u, v_, w = watertight_uvw(xs[0], ys[0], xs[1], ys[1], xs[2], ys[2],
                                  watertight=watertight)
        lo_uvw = jnp.minimum(jnp.minimum(u, v_), w)
        hi_uvw = jnp.maximum(jnp.maximum(u, v_), w)
        det = u + v_ + w
        rcp_det = 1.0 / det
        t = (u * zs[0] + v_ * zs[1] + w * zs[2]) * rcp_det
        ok = (is_tri & ~((lo_uvw < 0.0) & (hi_uvw > 0.0))
              & (t > min_t) & (t < hit_t))
        hit_t = jnp.where(ok, t, hit_t)
        hit_u = jnp.where(ok, u * rcp_det, st["hit_u"])
        hit_v = jnp.where(ok, v_ * rcp_det, st["hit_v"])
        hit_slot = jnp.where(ok, rows[:, SLOT_COL], st["hit_slot"])

        nxt = jnp.where(
            is_node, jnp.where(box_hit, cur + 1, rows[:, SKIP_COL]), cur + 1)
        if mode == "any":
            nxt = jnp.where(ok, e_count, nxt)  # first hit terminates
        cur = jnp.where(done, cur, nxt)
        return dict(cur=cur, hit_t=hit_t, hit_u=hit_u, hit_v=hit_v,
                    hit_slot=hit_slot)

    st = jax.lax.while_loop(cond, body, state)
    return st["hit_t"], st["hit_u"], st["hit_v"], st["hit_slot"]


def trace_stackless(sl: StacklessScene, rays: Rays, mode: str = "closest",
                    watertight: bool = True, sort_rays: bool = False) -> Hits:
    """Trace rays with the stackless engine (best for incoherent batches)."""
    n = rays.count
    perm = inv = None
    o, d, mn, mx = rays.origin, rays.direction, rays.min_t, rays.max_t
    if sort_rays:
        from rtk_tpu.models.path import _ray_sort_key

        lo = jnp.min(sl.tri_v.reshape(-1, 3), axis=0)
        hi = jnp.max(sl.tri_v.reshape(-1, 3), axis=0)
        key = _ray_sort_key(rays, lo, hi)
        perm = jnp.argsort(key)
        inv = jnp.argsort(perm)
        o, d, mn, mx = o[perm], d[perm], mn[perm], mx[perm]
    t, u, v, slot = _trace_stackless_impl(
        sl.entities, o, d, mn, mx, mode=mode, watertight=watertight)
    if inv is not None:
        t, u, v, slot = t[inv], u[inv], v[inv], slot[inv]
    hit = slot >= 0
    safe = jnp.clip(slot, 0, sl.tri_v.shape[0] - 1)
    return Hits(
        hit=hit,
        t=t,
        u=jnp.where(hit, u, 0.0),
        v=jnp.where(hit, v, 0.0),
        mesh_index=jnp.where(hit, jnp.take(sl.tri_mesh, safe), -1),
        triangle_index=jnp.where(hit, jnp.take(sl.tri_prim, safe), -1),
        vertex_position=jnp.where(
            hit[:, None, None], jnp.take(sl.tri_v, safe, axis=0), 0.0),
        vertex_index=jnp.where(
            hit[:, None], jnp.take(sl.tri_vidx, safe, axis=0), -1),
    )
