"""Multi-device scaling: rays data-parallel, or the scene itself sharded.

The reference scales queries only via host threads over a shared immutable
scene blob (rtk.c:543-577 is pure w.r.t. the scene; SURVEY §2 parallelism
table).  Three modes over a `jax.sharding.Mesh` of GPUs:

  * **Ray sharding** (`trace_*_sharded`): the scene pytree is replicated
    across devices, rays are split along their batch axis with
    `shard_map`, each device traverses independently — no collectives on
    the hot path (the analogue of rtk's zero-synchronisation host threads).
  * **Scene sharding** (`build_scene_sharded` +
    `trace_closest_scene_sharded`): for scenes larger than one device's
    memory, the triangle soup is spatially partitioned (recursive median
    split) into one sub-scene per device; rays are REPLICATED, every
    device traces against its local subtree (foreign rays die at the
    sub-scene root box), and the nearest hit is combined with a pmin on
    t plus a rank tie-break — a few small collectives per trace, which
    XLA hands to NCCL over NVLink.
  * **Hybrid 2D** (`hybrid_mesh` + the same scene-sharded entry points
    over a ("scene", "rays") mesh): the scene splits over one mesh axis
    and the ray batch over the other.  Hit combines run over the scene
    axis only; the ray axis stays collective-free.  Every GPU of a host
    reaches every other at the same NVLink rate, so the mesh shape
    follows the algorithm alone.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from jax.sharding import Mesh, PartitionSpec as P

from rtk_tpu.pytree import pytree_dataclass, static_field

from rtk_tpu.config import TraceConfig
from rtk_tpu.scene import Scene
from rtk_tpu.trace import stack as _stack
from rtk_tpu.types import Hits, PacketHits, Rays


def default_mesh(devices=None, axis_name: str = "rays") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def hybrid_mesh(n_scene: int, devices=None) -> Mesh:
    """2D ("scene", "rays") mesh: scene parts x ray shards.

    The device list folds into an (n_scene, n_dev // n_scene) grid; pass
    the result to build_scene_sharded / trace_*_scene_sharded to split
    BOTH the scene (axis 0) and the ray batch (axis 1).
    """
    devices = devices if devices is not None else jax.devices()
    devices = np.asarray(devices)
    if devices.size % n_scene != 0:
        raise ValueError(
            f"hybrid_mesh: {devices.size} devices do not fold into "
            f"{n_scene} scene rows")
    return Mesh(devices.reshape(n_scene, -1), ("scene", "rays"))


def _pad_rays(rays: Rays, multiple: int):
    n = rays.count
    pad = (-n) % multiple
    if pad == 0:
        return rays, n
    padded = Rays(
        origin=jnp.concatenate(
            [rays.origin, jnp.zeros((pad, 3), jnp.float32)], axis=0),
        direction=jnp.concatenate(
            [rays.direction, jnp.ones((pad, 3), jnp.float32)], axis=0),
        min_t=jnp.concatenate(
            [rays.min_t, jnp.zeros((pad,), jnp.float32)], axis=0),
        max_t=jnp.concatenate(
            [rays.max_t, jnp.zeros((pad,), jnp.float32)], axis=0),
    )
    return padded, n


def trace_sharded(
    scene: Scene,
    rays: Rays,
    mesh: Optional[Mesh] = None,
    mode: str = "closest",
    filter_fn: Optional[Callable] = None,
    config: TraceConfig = TraceConfig(),
) -> Hits:
    """Trace a ray batch sharded across the device mesh (scene replicated).

    Rays are padded to a multiple of the mesh size (padding rays get
    max_t = 0 so they immediately finish), traced independently per device
    under shard_map, and the Hits are returned in the caller's layout.
    """
    if mesh is None:
        mesh = default_mesh()
    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    padded, n = _pad_rays(rays, n_dev)

    def local_trace(scene_local, rays_local):
        return _stack._trace_loop(
            scene_local, rays_local, mode=mode, filter_fn=filter_fn,
            config=config)

    sharded = jax.shard_map(
        local_trace,
        mesh=mesh,
        in_specs=(P(), P(axis)),
        out_specs=P(axis),
        check_vma=False,
    )
    hits = jax.jit(sharded)(scene, padded)
    if padded.count != n:
        hits = jax.tree.map(lambda a: a[:n], hits)
    return hits


def trace_closest_sharded(scene, rays, mesh=None, filter_fn=None,
                          config=TraceConfig()):
    return trace_sharded(scene, rays, mesh, "closest", filter_fn, config)


def trace_any_sharded(scene, rays, mesh=None, filter_fn=None,
                      config=TraceConfig()):
    return trace_sharded(scene, rays, mesh, "any", filter_fn, config)


def trace_packets_sharded(
    packed,
    rays: Rays,
    mesh: Optional[Mesh] = None,
    mode: str = "closest",
    watertight: bool = True,
    interpret: bool = False,
    sort_rays: Optional[bool] = None,
    filter_mask: Optional[int] = None,
) -> PacketHits:
    """Sharded trace on the traversal kernel (PackedScene replicated).

    The per-device program is the same sort->kernel->unsort program as
    trace_packets; shard_map only splits the ray batch, so scaling is
    embarrassingly parallel, like host-thread query parallelism in the
    reference (rtk.c:543-577 purity).
    """
    from rtk_tpu.ops.pallas_trace import trace_packets

    if mesh is None:
        mesh = default_mesh()
    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    padded, n = _pad_rays(rays, n_dev)

    def local_trace(packed_local, rays_local):
        return trace_packets(
            packed_local, rays_local, mode=mode, watertight=watertight,
            interpret=interpret, sort_rays=sort_rays,
            filter_mask=filter_mask)

    # PacketHits is lazy: per-ray leaves shard over the ray axis, the packed
    # triangle tables it carries stay replicated (identical on every device).
    out_specs = PacketHits(
        hit=P(axis), t=P(axis), u_k=P(axis), v_k=P(axis), slot=P(axis),
        origin=P(axis), direction=P(axis),
        tri_v=P(), tri_vidx=P(), tri_mesh=P(), tri_prim=P(),
        overflow=P(axis))
    sharded = jax.shard_map(
        local_trace,
        mesh=mesh,
        in_specs=(P(), P(axis)),
        out_specs=out_specs,
        check_vma=False,
    )
    hits = jax.jit(sharded)(packed, padded)
    if padded.count != n:
        hits = hits[:n]
    return hits


def trace_instanced_sharded(
    pscene,
    rays: Rays,
    mesh: Optional[Mesh] = None,
    max_candidates: int = 8,
    interpret: bool = False,
    exact: bool = True,
):
    """Sharded closest-hit over an instanced (TLAS/BLAS) scene — the
    PackedInstancedScene replicated, the ray batch split over the mesh.

    Each device runs the fused candidates+rounds program on its ray slice.
    The exactness residual — the one host-synced step — runs ONCE on the
    gathered outputs, covering unproven rays from every device in a single
    exhaustive pass.
    """
    from rtk_tpu.instancing import (_instanced_kernel_impl,
                                    _residual_exhaustive)

    if mesh is None:
        mesh = default_mesh()
    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    iscene = pscene.iscene
    n_inst = iscene.num_instances
    C = min(max_candidates, n_inst)
    # Per-shard static shapes (mirrors trace_closest_instanced_packets).
    n = rays.count
    per0 = -(-n // n_dev)
    chunk = min(16384, max(1, per0))
    per = -(-per0 // chunk) * chunk
    padded, _ = _pad_rays(rays, per * n_dev)
    impl = functools.partial(_instanced_kernel_impl, C=C, n_inst=n_inst,
                             chunk=chunk, interpret=interpret)

    def local_trace(packed, ofw, roots, iblas, ilo, ihi, o, d, mn, mx):
        best, best_inst, unproven, _ = impl(packed, ofw, roots, iblas,
                                            ilo, ihi, o, d, mn, mx)
        return (best["t"], best["u"], best["v"], best["slot"], best_inst,
                unproven)

    sharded = jax.shard_map(
        local_trace,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(), P(),
                  P(axis), P(axis), P(axis), P(axis)),
        out_specs=(P(axis),) * 6,
        check_vma=False,
    )
    t, u, v, slot, best_inst, unproven = jax.jit(sharded)(
        pscene.packed, iscene.object_from_world, pscene.packed_roots,
        iscene.instance_blas, iscene.inst_lo, iscene.inst_hi,
        padded.origin, padded.direction, padded.min_t, padded.max_t)
    best = {"t": t[:n], "u": u[:n], "v": v[:n], "slot": slot[:n]}
    best_inst = best_inst[:n]
    unproven = unproven[:n]

    if exact and int(jnp.sum(unproven)):
        best, best_inst = _residual_exhaustive(
            pscene, rays, best, best_inst, unproven)

    packed = pscene.packed
    hits = PacketHits(
        hit=best["slot"] >= 0, t=best["t"], u_k=best["u"], v_k=best["v"],
        slot=best["slot"], origin=jnp.asarray(rays.origin),
        direction=jnp.asarray(rays.direction), tri_v=packed.tri_v,
        tri_vidx=packed.tri_vidx, tri_mesh=packed.tri_mesh,
        tri_prim=packed.tri_prim)
    return hits, best_inst


# ---------------------------------------------------------------------------
# Scene sharding: spatial partition, one sub-scene per device.
# ---------------------------------------------------------------------------

@pytree_dataclass
class ShardedScene:
    """Per-device packed sub-scenes, stacked on a leading device axis.

    Leaves are padded to common shapes so the stack is rectangular; padding
    triangles are NaN rows (never hit) and padding nodes are never reached
    (every sub-scene's root is its node 0).
    """

    nodes: "jax.Array"  # (D, NdMax*8, 8) i32 (8 child rows per node)
    tris: "jax.Array"  # (D, TpMax, 16) f32
    tri_v: "jax.Array"  # (D, TpMax, 3, 3) f32
    tri_vidx: "jax.Array"  # (D, TpMax, 3) i32
    tri_mesh: "jax.Array"  # (D, TpMax) i32
    tri_prim: "jax.Array"  # (D, TpMax) i32
    num_tris: int = static_field()  # total real triangles
    leaf_size: int = static_field()

    @property
    def num_parts(self) -> int:
        return self.nodes.shape[0]

    @property
    def part_tris(self) -> int:
        """Padded triangle slots per part (slot globalisation stride)."""
        return self.tri_v.shape[1]


def partition_soup(tri_pos: np.ndarray, n_parts: int):
    """Recursive longest-axis median split of triangle centroids.

    Returns a list of n_parts index arrays (disjoint, covering all
    triangles, each non-empty when T >= n_parts)."""
    if tri_pos.shape[0] < n_parts:
        raise ValueError(
            f"partition_soup: {tri_pos.shape[0]} triangles cannot fill "
            f"{n_parts} non-empty parts — scene sharding needs at least "
            "one triangle per device (use ray sharding for tiny scenes)")
    cent = tri_pos.mean(axis=1)  # (T, 3)
    parts = [np.arange(tri_pos.shape[0])]
    while len(parts) < n_parts:
        # split the largest part
        parts.sort(key=len, reverse=True)
        idx = parts.pop(0)
        c = cent[idx]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        order = np.argsort(c[:, axis], kind="stable")
        half = idx.shape[0] // 2
        parts.append(idx[order[:half]])
        parts.append(idx[order[half:]])
    return parts


def build_scene_sharded(meshes, mesh: Optional[Mesh] = None,
                        config=None) -> ShardedScene:
    """Build one packed sub-scene per device from a spatial partition.

    Accepts the same mesh inputs as rtk_tpu.build_scene.  Sub-scenes are
    built sequentially (host -> default device) and stacked; pass the
    result to trace_closest_scene_sharded with the same Mesh.
    """
    from rtk_tpu.config import BuildConfig
    from rtk_tpu.mesh import TriangleSoup, build_soup
    from rtk_tpu.scene import build_from_soup
    from rtk_tpu.trace.packed import pack_scene

    if mesh is None:
        mesh = default_mesh()
    if config is None:
        config = BuildConfig(branching=8, leaf_size=8)
    # On a hybrid 2D mesh only the FIRST axis carries scene parts (the
    # second splits rays); on the classic 1D mesh they coincide.
    n_dev = mesh.shape[mesh.axis_names[0]]
    soup = meshes if isinstance(meshes, TriangleSoup) else build_soup(meshes)
    parts = partition_soup(np.asarray(soup.tri_pos), n_dev)

    packs = []
    for idx in parts:
        scene = build_from_soup(
            np.asarray(soup.tri_pos)[idx],
            tri_vidx=np.asarray(soup.tri_vidx)[idx],
            tri_mesh=np.asarray(soup.tri_mesh)[idx],
            tri_prim=np.asarray(soup.tri_prim)[idx],
            config=config)
        packs.append(pack_scene(scene))

    nd_max = max(p.nodes.shape[0] for p in packs)
    tp_max = max(p.tri_v.shape[0] for p in packs)
    trow_max = max(p.tris.shape[0] for p in packs)

    def pad_to(a, n, fill):
        pad = n - a.shape[0]
        if pad == 0:
            return a
        return jnp.concatenate(
            [a, jnp.full((pad,) + a.shape[1:], fill, a.dtype)], axis=0)

    return ShardedScene(
        nodes=jnp.stack([pad_to(p.nodes, nd_max, 0) for p in packs]),
        tris=jnp.stack([pad_to(p.tris, trow_max, jnp.nan) for p in packs]),
        tri_v=jnp.stack([pad_to(p.tri_v, tp_max, 0.0) for p in packs]),
        tri_vidx=jnp.stack([pad_to(p.tri_vidx, tp_max, -1) for p in packs]),
        tri_mesh=jnp.stack([pad_to(p.tri_mesh, tp_max, -1) for p in packs]),
        tri_prim=jnp.stack([pad_to(p.tri_prim, tp_max, -1) for p in packs]),
        num_tris=int(soup.tri_pos.shape[0]),
        leaf_size=config.leaf_size,
    )


def trace_scene_sharded(
    sscene: ShardedScene,
    rays: Rays,
    mesh: Optional[Mesh] = None,
    mode: str = "closest",
    watertight: bool = True,
    interpret: bool = False,
) -> PacketHits:
    """Trace against a scene sharded across the device mesh.

    On a 1D mesh rays are replicated; on a 2-axis ("scene", "rays")
    mesh (see hybrid_mesh) the ray batch additionally splits over the
    second axis.  Each device traverses its sub-scene; nearest hits
    combine over the scene axis (pmin on t + lowest-rank tie-break + psum
    of the selected fields).  Returns a lazy
    PacketHits whose tables are the concatenated per-part tables (slots
    are globalised as rank * part_tris + local_slot).
    """
    from rtk_tpu.ops.pallas_trace import trace_packets
    from rtk_tpu.trace.packed import PackedScene

    if mesh is None:
        mesh = default_mesh()
    axis = mesh.axis_names[0]
    ray_axis = mesh.axis_names[1] if len(mesh.axis_names) > 1 else None
    n_dev = mesh.shape[axis]
    n_count = rays.count
    if ray_axis is not None:
        rays, n_count = _pad_rays(rays, mesh.shape[ray_axis])
    tp_max = sscene.part_tris
    k = sscene.leaf_size

    def local_trace(nodes, tris, tri_v, tri_vidx, tri_mesh, tri_prim,
                    rays_rep):
        packed = PackedScene(
            nodes=nodes[0], meta=jnp.zeros((1, 4), jnp.int32),
            tris=tris[0], tri_v=tri_v[0], tri_vidx=tri_vidx[0],
            tri_mesh=tri_mesh[0], tri_prim=tri_prim[0],
            slot_src=jnp.zeros((1, 8), jnp.int32),
            tri_perm=jnp.zeros((tp_max,), jnp.int32),
            num_tris=tp_max, leaf_size=k)
        h = trace_packets(packed, rays_rep, mode=mode,
                          watertight=watertight, interpret=interpret)
        rank = jax.lax.axis_index(axis)
        ovf = jax.lax.pmax(h.overflow.astype(jnp.int32), axis) > 0
        if mode == "any":
            # Pick ONE winning device (lowest rank among hitting devices)
            # and take its entire record, so (t, u, v, slot) always
            # describe a single real intersection — same rank-select
            # pattern as the closest path below (a pmax per field would
            # mix fields from different devices).
            hit = jax.lax.pmax(h.hit.astype(jnp.int32), axis) > 0
            brank = jax.lax.pmin(
                jnp.where(h.hit, rank, jnp.int32(n_dev)), axis)
            sel = h.hit & (rank == brank)
            gslot = jnp.where(h.slot >= 0, rank * tp_max + h.slot, -1)
            slot = jax.lax.psum(jnp.where(sel, gslot + 1, 0), axis) - 1
            # Miss keeps the local miss t (== ray max_t, identical on every
            # device since rays are replicated).
            t = jnp.where(hit, jax.lax.psum(jnp.where(sel, h.t, 0.0), axis),
                          h.t)
            u = jax.lax.psum(jnp.where(sel, h.u, 0.0), axis)
            v = jax.lax.psum(jnp.where(sel, h.v, 0.0), axis)
            return (hit, t, u, v, slot, ovf)
        best_t = jax.lax.pmin(h.t, axis)
        win = (h.t <= best_t)
        brank = jax.lax.pmin(
            jnp.where(win, rank, jnp.int32(n_dev)), axis)
        sel = win & (rank == brank)
        gslot = jnp.where(h.slot >= 0, rank * tp_max + h.slot, -1)
        slot = jax.lax.psum(
            jnp.where(sel, gslot + 1, 0), axis) - 1
        u = jax.lax.psum(jnp.where(sel, h.u, 0.0), axis)
        v = jax.lax.psum(jnp.where(sel, h.v, 0.0), axis)
        return (slot >= 0, best_t, u, v, slot, ovf)

    rspec = P(ray_axis) if ray_axis is not None else P()
    sharded = jax.shard_map(
        local_trace,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis), P(axis),
                  rspec),
        out_specs=(rspec,) * 6,
        check_vma=False,
    )
    hit, t, u, v, slot, ovf = jax.jit(sharded)(
        sscene.nodes, sscene.tris, sscene.tri_v, sscene.tri_vidx,
        sscene.tri_mesh, sscene.tri_prim, rays)
    if rays.count != n_count:
        hit, t, u, v, slot, ovf = (a[:n_count]
                                   for a in (hit, t, u, v, slot, ovf))
        rays = jax.tree.map(lambda a: a[:n_count], rays)
    return PacketHits(
        hit=hit, t=t, u_k=u, v_k=v, slot=slot,
        origin=jnp.asarray(rays.origin),
        direction=jnp.asarray(rays.direction),
        tri_v=sscene.tri_v.reshape(-1, 3, 3),
        tri_vidx=sscene.tri_vidx.reshape(-1, 3),
        tri_mesh=sscene.tri_mesh.reshape(-1),
        tri_prim=sscene.tri_prim.reshape(-1),
        overflow=ovf,
    )


def trace_closest_scene_sharded(sscene, rays, mesh=None, watertight=True,
                                interpret=False):
    return trace_scene_sharded(sscene, rays, mesh, "closest", watertight,
                               interpret)


def trace_any_scene_sharded(sscene, rays, mesh=None, watertight=True,
                            interpret=False):
    return trace_scene_sharded(sscene, rays, mesh, "any", watertight,
                               interpret)
