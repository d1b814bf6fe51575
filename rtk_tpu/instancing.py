"""Two-level TLAS/BLAS instancing.

The reference is single-level (one scene blob, no instancing); this is the
scale-out path the BASELINE 10M-tri config requires.  Design:

  * All BLAS scenes are merged into ONE concatenated node/triangle space
    (child ids and leaf ids offset per BLAS), so a single traversal program
    serves every instance — the per-ray BLAS root is just a start node.
  * The top level is not a pointer-chasing tree walk: instance candidates
    are found by testing rays against ALL instance world AABBs as one dense
    (rays x instances) slab computation, keeping the nearest `C` candidates
    per ray.  For the instance counts the config targets (tens to
    thousands) this is one dense data-parallel pass instead of a divergent
    TLAS descent, and it is trivially batchable/shardable.
  * Phase two walks candidates nearest-first: each round transforms rays
    into the candidate's object space (affine inverse, direction left
    unnormalised so object-space t == world-space t) and traces the merged
    BLAS from that instance's root with the current best t as the upper
    bound — instance-level early-out exactly like rtk's node pop-culling
    (rtk.c:432-437), lifted to the instance level.
"""
from __future__ import annotations

import functools
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from rtk_tpu.pytree import pytree_dataclass, static_field

from rtk_tpu.config import TraceConfig
from rtk_tpu.scene import Scene
from rtk_tpu.trace import stack as _stack
from rtk_tpu.types import Hits, Rays

Array = jax.Array


@pytree_dataclass
class InstancedScene:
    """Merged BLAS forest + instance table."""

    merged: Scene  # concatenated BLAS scenes (multi-root)
    roots: Array  # (B,) i32 wide-root node id per BLAS
    instance_blas: Array  # (I,) i32
    world_from_object: Array  # (I, 3, 4) affine
    object_from_world: Array  # (I, 3, 4) affine inverse
    inst_lo: Array  # (I, 3) world AABB of each instance
    inst_hi: Array  # (I, 3)
    # Real (unpadded) triangle count per unique BLAS, static host-side.
    blas_tris: tuple = static_field(default=())

    @property
    def num_instances(self) -> int:
        return self.instance_blas.shape[0]

    @property
    def total_triangles(self) -> int:
        """Effective triangle count: sum over instances of their BLAS size."""
        if not self.blas_tris:
            return 0
        counts = np.asarray(self.blas_tris)
        return int(counts[np.asarray(self.instance_blas)].sum())


def _affine_inverse(m: np.ndarray) -> np.ndarray:
    """(3,4) world-from-object -> (3,4) object-from-world."""
    lin = m[:, :3]
    t = m[:, 3]
    inv = np.linalg.inv(lin)
    return np.concatenate([inv, (-inv @ t)[:, None]], axis=1)


def merge_blas(scenes: Sequence[Scene]) -> tuple[Scene, np.ndarray]:
    """Concatenate BLAS Scenes into one multi-root Scene.

    All scenes must share leaf_size and branching.  Returns (merged, roots).
    """
    k = scenes[0].leaf_size
    w = scenes[0].branching
    for s in scenes:
        if s.leaf_size != k or s.branching != w:
            raise ValueError("BLAS scenes must share leaf_size/branching")
        if not s.has_wide:
            # The merge offsets binary AND wide ids by node_child row
            # counts (equal only when the wide arrays are real), and the
            # instanced exactness residual traverses the merged scene
            # through the XLA stack engine, which needs them.
            raise ValueError(
                "BLAS scenes must be built with wide_nodes=True "
                "(the instanced path's stack-engine residual and the "
                "merge offsets need the wide node arrays)")

    node_off = np.cumsum([0] + [s.node_child.shape[0] for s in scenes])
    leaf_off = np.cumsum([0] + [s.num_padded_tris // k for s in scenes])
    tri_off = np.cumsum([0] + [s.num_padded_tris for s in scenes])

    def shift_child(child, b):
        # internal ids += node_off[b]; leaf codes shift by leaf_off[b]
        # (python-int offsets: numpy scalars would promote to int64 when
        # jax_enable_x64 is on)
        internal = child >= 0
        leaf = child <= -2
        shifted_leaf = -((-child - 2) + int(leaf_off[b])) - 2
        return jnp.where(internal, child + int(node_off[b]),
                         jnp.where(leaf, shifted_leaf, child)).astype(jnp.int32)

    merged = Scene(
        node_child=jnp.concatenate(
            [shift_child(s.node_child, b) for b, s in enumerate(scenes)]),
        node_min=jnp.concatenate([s.node_min for s in scenes]),
        node_max=jnp.concatenate([s.node_max for s in scenes]),
        bin_left=jnp.concatenate(
            [shift_child(s.bin_left, b) for b, s in enumerate(scenes)]),
        bin_right=jnp.concatenate(
            [shift_child(s.bin_right, b) for b, s in enumerate(scenes)]),
        bin_lo=jnp.concatenate(
            [s.bin_lo + int(leaf_off[b]) for b, s in enumerate(scenes)]),
        bin_hi=jnp.concatenate(
            [s.bin_hi + int(leaf_off[b]) for b, s in enumerate(scenes)]),
        bin_min=jnp.concatenate([s.bin_min for s in scenes]),
        bin_max=jnp.concatenate([s.bin_max for s in scenes]),
        leaf_min=jnp.concatenate([s.leaf_min for s in scenes]),
        leaf_max=jnp.concatenate([s.leaf_max for s in scenes]),
        tri_v=jnp.concatenate([s.tri_v for s in scenes]),
        tri_vidx=jnp.concatenate([s.tri_vidx for s in scenes]),
        tri_mesh=jnp.concatenate([s.tri_mesh for s in scenes]),
        tri_prim=jnp.concatenate([s.tri_prim for s in scenes]),
        perm=jnp.concatenate(
            [jnp.where(s.perm >= 0, s.perm + int(tri_off[b]), -1)
             for b, s in enumerate(scenes)]).astype(jnp.int32),
        bounds_min=functools.reduce(
            jnp.minimum, [s.bounds_min for s in scenes]),
        bounds_max=functools.reduce(
            jnp.maximum, [s.bounds_max for s in scenes]),
        num_tris=int(tri_off[-1]),  # padding rows are degenerate -> harmless
        leaf_size=k,
        branching=w,
        num_leaves=int(leaf_off[-1]),
    )
    return merged, node_off[:-1].astype(np.int32)


def build_instanced(
    blas: Sequence[Scene],
    instance_blas,
    transforms,
) -> InstancedScene:
    """Assemble an InstancedScene.

    Args:
      blas: unique BLAS Scenes.
      instance_blas: (I,) int — BLAS index per instance.
      transforms: (I, 3, 4) world-from-object affine per instance.
    """
    merged, roots = merge_blas(blas)
    instance_blas = np.asarray(instance_blas, np.int32)
    transforms = np.asarray(transforms, np.float32).reshape(-1, 3, 4)
    inv = np.stack([_affine_inverse(m) for m in transforms]).astype(np.float32)

    # World AABB per instance: transform the 8 corners of the BLAS bounds.
    lo = np.stack([np.asarray(blas[b].bounds_min) for b in instance_blas])
    hi = np.stack([np.asarray(blas[b].bounds_max) for b in instance_blas])
    corners = np.stack(
        [np.where([(c >> a) & 1 for a in range(3)], hi_i, lo_i)
         for lo_i, hi_i in zip(lo, hi)
         for c in range(8)]).reshape(-1, 8, 3)  # (I, 8, 3)
    world = (np.einsum("iab,icb->ica", transforms[:, :, :3], corners)
             + transforms[:, None, :, 3])
    return InstancedScene(
        merged=merged,
        roots=jnp.asarray(roots),
        instance_blas=jnp.asarray(instance_blas),
        world_from_object=jnp.asarray(transforms),
        object_from_world=jnp.asarray(inv),
        inst_lo=jnp.asarray(world.min(axis=1), jnp.float32),
        inst_hi=jnp.asarray(world.max(axis=1), jnp.float32),
        blas_tris=tuple(int(s.num_tris) for s in blas),
    )


@functools.partial(jax.jit, static_argnames=("c", "chunk"))
def _instance_candidates_impl(inst_lo, inst_hi, origin, direction, min_t,
                              max_t, *, c, chunk):
    def block(args):
        o, d, mint, maxt = args
        # NaN-free clamped reciprocal (finite huge instead of inf): a
        # zero direction component against a touching plane would give
        # 0 * inf = NaN through the slab test otherwise.
        big = jnp.where(d >= 0, 3.0e38, -3.0e38)
        rcp = jnp.where(d == 0.0, big, jnp.float32(1.0) / d)  # (chunk, 3)
        t0 = (inst_lo[None] - o[:, None]) * rcp[:, None]
        t1 = (inst_hi[None] - o[:, None]) * rcp[:, None]
        near = jnp.fmin(t0, t1)
        far = jnp.fmax(t0, t1)
        enter = jnp.fmax(jnp.fmax(near[..., 0], near[..., 1]),
                         jnp.fmax(near[..., 2], mint[:, None]))
        exit_ = jnp.fmin(jnp.fmin(far[..., 0], far[..., 1]),
                         jnp.fmin(far[..., 2], maxt[:, None]))
        hit = enter <= exit_  # (chunk, I)
        score = jnp.where(hit, enter, jnp.inf)
        iota = jax.lax.broadcasted_iota(jnp.int32, score.shape, 1)
        idxs, ts = [], []
        # C passes of masked argmin instead of a full sort over the
        # instance axis.
        for _ in range(c):
            j = jnp.argmin(score, axis=1)
            v = jnp.min(score, axis=1)
            ok = jnp.isfinite(v)
            idxs.append(jnp.where(ok, j, -1).astype(jnp.int32))
            ts.append(v)
            score = jnp.where(iota == j[:, None], jnp.inf, score)
        # (c+1)-th entry distance: the exactness bound for the candidate
        # cap (rays whose best hit is farther must re-trace exhaustively).
        overflow = jnp.min(score, axis=1)
        return jnp.stack(idxs, axis=1), jnp.stack(ts, axis=1), overflow

    n = origin.shape[0]
    sh = (n // chunk, chunk)
    ci, ct, ov = jax.lax.map(block, (origin.reshape(sh + (3,)),
                                     direction.reshape(sh + (3,)),
                                     min_t.reshape(sh), max_t.reshape(sh)))
    return ci.reshape(n, -1), ct.reshape(n, -1), ov.reshape(n)


def _instance_candidates(iscene: InstancedScene, rays: Rays, c: int,
                         chunk: int = 16384):
    """Nearest-C instance candidates per ray by AABB entry distance.

    The top level is not a pointer-chasing tree walk: a dense
    (rays x instances) slab pass in one fused dispatch (lax.map over ray
    chunks bounds the live (chunk, I) temporaries).

    Returns (cand_idx (N, C) i32 [-1 = none], cand_t (N, C) f32).
    """
    n = rays.count
    c = min(c, iscene.num_instances)
    chunk = min(chunk, max(1, n))
    pad = (-n) % chunk
    pad_one = lambda a, fill: (jnp.concatenate(
        [a, jnp.full((pad,) + a.shape[1:], fill, a.dtype)]) if pad else a)
    ci, ct, ov = _instance_candidates_impl(
        iscene.inst_lo, iscene.inst_hi,
        pad_one(jnp.asarray(rays.origin), 0.0),
        pad_one(jnp.asarray(rays.direction), 1.0),
        pad_one(jnp.asarray(rays.min_t), 0.0),
        pad_one(jnp.asarray(rays.max_t), 0.0),
        c=c, chunk=chunk)
    return ci[:n], ct[:n], ov[:n]


def _to_object(inv, origin, direction):
    """World rays into object space by per-ray (3, 4) affine inverses.

    HIGHEST precision: a float32 product may otherwise run in TF32 on the
    GPU, which moves object-space rays by ~1e-3 relative."""
    hi = jax.lax.Precision.HIGHEST
    o = (jnp.einsum("nab,nb->na", inv[:, :, :3], origin, precision=hi)
         + inv[:, :, 3])
    d = jnp.einsum("nab,nb->na", inv[:, :, :3], direction, precision=hi)
    return o, d


def trace_closest_instanced(
    iscene: InstancedScene,
    rays: Rays,
    max_candidates: int = 8,
    config: TraceConfig = TraceConfig(),
) -> tuple[Hits, Array]:
    """Closest-hit over an instanced scene.

    Returns (hits, instance_index (N,) i32, -1 on miss).  Hit vertex
    positions are in *object* space of the hit instance (use the instance
    transform for world-space shading); t/u/v/mesh/triangle follow the
    usual contract and t is a world-space distance.
    """
    n = rays.count
    cand_idx, cand_t, _ = _instance_candidates(iscene, rays,
                                               max_candidates)

    best = Hits(  # running best, start as all-miss
        hit=jnp.zeros((n,), bool),
        t=rays.max_t,
        u=jnp.zeros((n,), jnp.float32),
        v=jnp.zeros((n,), jnp.float32),
        mesh_index=jnp.full((n,), -1, jnp.int32),
        triangle_index=jnp.full((n,), -1, jnp.int32),
        vertex_position=jnp.zeros((n, 3, 3), jnp.float32),
        vertex_index=jnp.full((n, 3), -1, jnp.int32),
    )
    best_inst = jnp.full((n,), -1, jnp.int32)

    for slot in range(cand_idx.shape[1]):
        inst = cand_idx[:, slot]
        live = (inst >= 0) & (cand_t[:, slot] < best.t)
        if not bool(jnp.any(live)):
            break
        safe = jnp.clip(inst, 0, iscene.num_instances - 1)
        inv = jnp.take(iscene.object_from_world, safe, axis=0)  # (N,3,4)
        o, d = _to_object(inv, rays.origin, rays.direction)
        start = jnp.take(iscene.roots, jnp.take(iscene.instance_blas, safe))
        obj_rays = Rays(
            origin=o,
            direction=d,
            min_t=rays.min_t,
            max_t=jnp.where(live, best.t, 0.0),  # inactive rays do no work
        )
        h = _stack._trace_loop(
            iscene.merged, obj_rays, mode="closest", filter_fn=None,
            config=config, start_node=start)
        better = h.hit & (h.t < best.t) & live
        best = jax.tree.map(
            lambda new, old: jnp.where(
                better.reshape((-1,) + (1,) * (old.ndim - 1)), new, old),
            h, best)
        best_inst = jnp.where(better, inst, best_inst)

    return best, best_inst


# ---------------------------------------------------------------------------
# Kernel instanced tracing: each candidate round traces every live ray from
# its candidate instance's BLAS root, in that instance's object space.
# ---------------------------------------------------------------------------

@pytree_dataclass
class PackedInstancedScene:
    iscene: InstancedScene
    packed: "object"  # PackedScene of the merged forest
    packed_roots: Array  # (B,) i32 packed node id per BLAS


def pack_instanced(iscene: InstancedScene, packed=None,
                   packed_roots=None) -> PackedInstancedScene:
    """Pack the merged BLAS forest for the traversal kernel.

    packed/packed_roots: optional override tables (e.g. the host-SAH
    forest from builder.sah.build_sah_forest — static BLAS geometry
    traced many times benefits from the higher-quality topology exactly
    like flat static scenes do).  Must cover the same BLAS list in the
    same order; record contract (per-BLAS tri ids) is unchanged."""
    from rtk_tpu.trace.packed import pack_forest

    if packed is None:
        packed, packed_roots = pack_forest(iscene.merged,
                                           np.asarray(iscene.roots))
    elif packed_roots is None:
        raise ValueError("pack_instanced(packed=...) needs packed_roots")
    return PackedInstancedScene(
        iscene=iscene, packed=packed,
        packed_roots=jnp.asarray(np.asarray(packed_roots, np.int64),
                                 jnp.int32))


CAP_QUANTUM = 256  # round caps are powers of two times this many rows


def _instanced_kernel_impl(packed, object_from_world, packed_roots,
                           inst_blas, inst_lo, inst_hi, origin, direction,
                           min_t, max_t, *, C, n_inst, chunk, interpret,
                           caps=None):
    """Candidates + all rounds as ONE device program.

    Round s sorts the rays by their rank-s candidate instance (a stable
    sort: rays of one instance stay in camera order, and rays with no live
    candidate sink to the end), transforms them into object space, traces
    them with per-ray roots and scatters improvements back by ray id.

    caps (static, optional): per-round row capacities.  Round s traces
    only the first caps[s] sorted rows.  A live row beyond its cap is
    marked unproven and lands in the caller's exactness residual — a cap
    never drops a hit."""
    from rtk_tpu.ops.pallas_trace import trace_packets

    cand_idx, cand_t, overflow = _instance_candidates_impl(
        inst_lo, inst_hi, origin, direction, min_t, max_t, c=C,
        chunk=chunk)
    n = origin.shape[0]
    best = {
        "t": max_t,
        "u": jnp.zeros((n,), jnp.float32),
        "v": jnp.zeros((n,), jnp.float32),
        "slot": jnp.full((n,), -1, jnp.int32),
    }
    best_inst = jnp.full((n,), -1, jnp.int32)
    over_cap = jnp.zeros((n,), bool)
    live_counts = []  # per-round live rays (calibrate_round_caps)

    def round_body(s, best, best_inst, over_cap, cap):
        live0 = cand_t[:, s] < best["t"]
        bin_r = jnp.where(live0, cand_idx[:, s], n_inst).astype(jnp.int32)
        bin_s, idx_s = jax.lax.sort(
            (bin_r, jnp.arange(n, dtype=jnp.int32)), num_keys=1,
            is_stable=True)
        if cap is not None and cap < n:
            # A live row past the cap loses its trace: route it to the
            # residual (live rows sort before the dead tail, so a large
            # enough cap never cuts one).
            over_cap = over_cap.at[
                jnp.where(bin_s[cap:] < n_inst, idx_s[cap:], n)].set(
                    True, mode="drop")
            bin_s, idx_s = bin_s[:cap], idx_s[:cap]
        live = bin_s < n_inst
        inst = jnp.minimum(bin_s, n_inst - 1)
        o, d = _to_object(jnp.take(object_from_world, inst, axis=0),
                          jnp.take(origin, idx_s, axis=0),
                          jnp.take(direction, idx_s, axis=0))
        bt = jnp.take(best["t"], idx_s)
        grouped = Rays(origin=o, direction=d,
                       min_t=jnp.take(min_t, idx_s),
                       max_t=jnp.where(live, bt, 0.0))
        roots = jnp.take(packed_roots, jnp.take(inst_blas, inst))
        h = trace_packets(packed, grouped, roots=roots, sort_rays=False,
                          interpret=interpret)
        improved = h.hit & (h.t < bt) & live
        tgt = jnp.where(improved, idx_s, n)
        best = {k: best[k].at[tgt].set(v, mode="drop")
                for k, v in (("t", h.t), ("u", h.u), ("v", h.v),
                             ("slot", h.slot))}
        best_inst = best_inst.at[tgt].set(bin_s, mode="drop")
        # A stack overflow leaves that ray's round unproven.
        over_cap = over_cap.at[jnp.where(h.overflow & live, idx_s, n)].set(
            True, mode="drop")
        return best, best_inst, over_cap

    for s in range(C):
        # Rounds with no live candidate skip at run time: most rays prove
        # within their first one or two candidates.
        cap = None if caps is None else min(int(caps[s]), n)
        n_live = jnp.sum((cand_t[:, s] < best["t"]).astype(jnp.int32))
        live_counts.append(n_live)
        best, best_inst, over_cap = jax.lax.cond(
            n_live > 0,
            lambda b, bi, oc, s=s, cap=cap: round_body(s, b, bi, oc, cap),
            lambda b, bi, oc: (b, bi, oc),
            best, best_inst, over_cap)
    # A ray whose (C+1)-th instance-AABB entry is still closer than its
    # best hit is unproven; the caller re-traces those exhaustively.
    unproven = (overflow < best["t"]) | over_cap
    return best, best_inst, unproven, jnp.stack(live_counts)


@functools.lru_cache(maxsize=None)
def _instanced_kernel_jit(interpret: bool, C: int, n_inst: int, chunk: int,
                          caps=None):
    return jax.jit(functools.partial(
        _instanced_kernel_impl, C=C, n_inst=n_inst, chunk=chunk,
        interpret=interpret, caps=caps))


def _residual_exhaustive(pscene, rays, best, best_inst, unproven):
    """Exhaustive candidate rounds over ALL instances for unproven rays,
    via the XLA stack engine (eager, early-breaking python loop — the
    residual batch is small by construction)."""
    iscene = pscene.iscene
    packed = pscene.packed
    n = rays.count
    n_inst = iscene.num_instances
    cand_idx, cand_t, _ = _instance_candidates(iscene, rays, n_inst)
    inv = jnp.zeros((packed.tri_perm.shape[0],), jnp.int32).at[
        packed.tri_perm].set(jnp.arange(packed.tri_perm.shape[0],
                                        dtype=jnp.int32))
    cfg = TraceConfig()
    best_t = best["t"]
    for s_ in range(cand_idx.shape[1]):
        inst = cand_idx[:, s_]
        live = unproven & (inst >= 0) & (cand_t[:, s_] < best_t)
        if not bool(jnp.any(live)):
            break
        safe = jnp.clip(inst, 0, n_inst - 1)
        inv_m = jnp.take(iscene.object_from_world, safe, axis=0)
        o, d = _to_object(inv_m, rays.origin, rays.direction)
        start = jnp.take(iscene.roots, jnp.take(iscene.instance_blas, safe))
        obj_rays = Rays(origin=o, direction=d, min_t=rays.min_t,
                        max_t=jnp.where(live, best_t, 0.0))
        h, sorted_slot = _stack._trace_loop(
            iscene.merged, obj_rays, mode="closest", filter_fn=None,
            config=cfg, start_node=start, return_slot=True)
        better = h.hit & (h.t < best_t) & live
        best_t = jnp.where(better, h.t, best_t)
        best["u"] = jnp.where(better, h.u, best["u"])
        best["v"] = jnp.where(better, h.v, best["v"])
        pslot = jnp.take(inv, jnp.clip(sorted_slot, 0,
                                       inv.shape[0] - 1))
        best["slot"] = jnp.where(better, pslot, best["slot"])
        best_inst = jnp.where(better, inst, best_inst)
    best["t"] = best_t
    return best, best_inst


def _quantize_cap(need: int, n: int) -> int:
    q = CAP_QUANTUM
    while q < need:
        q *= 2
    return min(q, n)


def trace_closest_instanced_packets(
    pscene: PackedInstancedScene,
    rays: Rays,
    max_candidates: int = 8,
    interpret: bool = False,
    exact: bool = True,
    round_caps=None,
    return_live_counts: bool = False,
) -> tuple[Hits, Array]:
    """Closest-hit over an instanced scene using the traversal kernel.

    Per candidate round, live rays are grouped by instance on device,
    transformed to object space, and traced from their instance's BLAS
    root (per-ray roots).  Candidates and all rounds fuse into one device
    program with no host syncs; the exactness residual is one more.

    round_caps: None, "auto" (bound each round by its candidate-rank
    population) or a tuple of C row capacities (calibrate_round_caps).
    """
    from rtk_tpu.types import PacketHits

    iscene = pscene.iscene
    n = rays.count
    n_inst = iscene.num_instances
    C = min(max_candidates, n_inst)
    chunk = min(16384, max(1, n))
    pad = (-n) % chunk
    np_ = n + pad

    def padded(a, fill):
        if pad == 0:
            return jnp.asarray(a)
        a = jnp.asarray(a)
        return jnp.concatenate(
            [a, jnp.full((pad,) + a.shape[1:], fill, a.dtype)])

    if round_caps == "auto":
        ci, ct, _ = _instance_candidates(pscene.iscene, rays, C)
        cnt = np.asarray(jnp.sum(
            (ci >= 0) & (ct < jnp.asarray(rays.max_t)[:, None]), axis=0))
        round_caps = tuple(_quantize_cap(int(c), np_) for c in cnt)
    elif round_caps is not None:
        round_caps = tuple(int(c_) for c_ in round_caps)
        if len(round_caps) != C:
            raise ValueError(f"round_caps needs {C} entries")

    fn = _instanced_kernel_jit(interpret, C, n_inst, chunk, caps=round_caps)
    best, best_inst, unproven, live_counts = fn(
        pscene.packed, iscene.object_from_world, pscene.packed_roots,
        iscene.instance_blas, iscene.inst_lo, iscene.inst_hi,
        padded(rays.origin, 0.0), padded(rays.direction, 1.0),
        padded(rays.min_t, 0.0), padded(rays.max_t, 0.0))
    if pad:
        best = {k: v[:n] for k, v in best.items()}
        best_inst = best_inst[:n]
        unproven = unproven[:n]

    if exact:
        # Exactness residual: rays the C-candidate cap cannot prove get an
        # exhaustive re-trace (all-instance candidates through the XLA
        # stack path, which exposes its internal sorted slot -> mapped to
        # a packed slot so the lazy PacketHits record stays consistent).
        # One scalar host sync.  The residual is compacted first: the
        # stack engine's per-round cost scales with the batch width.
        unp = np.asarray(unproven)
        idx = np.flatnonzero(unp)
        n_res = idx.size
        if n_res:
            # Pad to a power of two (one compiled residual per bucket),
            # capped at the batch width.  Pad rays are dead (max_t=0);
            # their indices are out of bounds, so scatters drop them.
            m_res = min(max(256, 1 << (n_res - 1).bit_length()), max(n, 256))
            pad_idx = np.full(m_res, n, np.int64)
            pad_idx[:n_res] = idx
            idxj = jnp.asarray(pad_idx, jnp.int32)
            livep = jnp.asarray(np.arange(m_res) < n_res)
            gat = lambda a: jnp.asarray(a)[jnp.minimum(idxj, n - 1)]
            rays_r = Rays(origin=gat(rays.origin),
                          direction=gat(rays.direction),
                          min_t=gat(rays.min_t),
                          max_t=jnp.where(livep, gat(rays.max_t), 0.0))
            best_r = {k: gat(v) for k, v in best.items()}
            best_r, bi_r = _residual_exhaustive(
                pscene, rays_r, best_r, gat(best_inst), livep)
            best = {k: v.at[idxj].set(best_r[k], mode="drop")
                    for k, v in best.items()}
            best_inst = best_inst.at[idxj].set(bi_r, mode="drop")

    packed = pscene.packed
    hits = PacketHits(
        hit=best["slot"] >= 0,
        t=best["t"],
        u_k=best["u"],
        v_k=best["v"],
        slot=best["slot"],
        # World rays: position() yields the world-space hit point (t is a
        # world-space distance).  vertex_position stays in the hit
        # instance's object space — see the docstring.
        origin=jnp.asarray(rays.origin),
        direction=jnp.asarray(rays.direction),
        tri_v=packed.tri_v,
        tri_vidx=packed.tri_vidx,
        tri_mesh=packed.tri_mesh,
        tri_prim=packed.tri_prim,
    )
    if return_live_counts:
        # (hits, inst, per-round live counts): calibration callers need
        # the hits too (e.g. a wavefront generating its bounce batches
        # while collecting counts for a shared caps tuple).
        return hits, best_inst, live_counts
    return hits, best_inst


def calibrate_round_caps(pscene: PackedInstancedScene, rays: Rays,
                         max_candidates: int = 8, margin: float = 1.5,
                         **kw):
    """Measure per-round live rays on a sample batch and derive round_caps
    for later traces: margin x measured, quantised to powers of two.  A
    hotter later batch only loses rows to the exactness residual, never
    hits."""
    _, _, counts = trace_closest_instanced_packets(
        pscene, rays, max_candidates=max_candidates,
        return_live_counts=True, **kw)
    return caps_from_counts(np.asarray(counts), rays.count, margin=margin)


def caps_from_counts(counts, n: int, margin: float = 1.5):
    """round_caps tuple from measured per-round live counts (callers that
    pool counts across several batches take an elementwise max first)."""
    chunk = min(16384, max(1, n))
    np_ = n + ((-n) % chunk)
    return tuple(_quantize_cap(int(int(c) * margin), np_) for c in counts)
