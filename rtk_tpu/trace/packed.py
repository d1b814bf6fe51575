"""PackedScene: kernel-ready scene tables for the traversal kernel.

The packed wide tree is built straight from the *binary* LBVH topology with
a greedy collapse: starting from a node's two children, repeatedly expand
the internal slot with the largest surface area until all 8 slots are used.
This fills ~7-8 of 8 child slots (the builder's cheap depth-mod collapse
averages ~4), which makes the packed tree shallower and cuts traversal
steps.  It generalises the reference's binary->BVH4 grandchild collapse
(rtk.c:1570-1622) with an SAH-flavoured expansion order.

Nodes are numbered in BFS order with each node's internal children (and
leaf children) CONTIGUOUS, so the kernel derives every child pointer from
(first_child, first_leaf, slot masks) — no per-slot pointer loads.  This is
the analogue of rtk's linearizer pass (rtk.c:1509-1622): rtk emits
level-ordered BVH4 nodes + packed leaf records into a relocatable blob; we
emit BFS-ordered SoA rows + reordered triangle rows into device tables.

Packing runs once per topology (host NumPy); refit only regathers bounds
through saved mappings (jitted).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from rtk_tpu.pytree import pytree_dataclass, static_field

from rtk_tpu.scene import Scene

Array = jax.Array

W = 8
NODE_ROW_I32 = 8  # per child: [minx miny minz maxx maxy maxz meta0 meta1]
TRI_ROW_F32 = 16  # [v0(3) v1(3) v2(3) | 7 pad]


@pytree_dataclass
class PackedScene:
    """Dense scene tables + mappings; product of pack_scene(scene).

    nodes holds 8 rows per packed node (one per child slot): columns 0-5 are
    the child AABB (f32 bit patterns in an int32 table, so integer metadata
    shares the table unharmed), and the first two rows carry node metadata
    in columns 6-7: row0 = (first_child, first_leaf), row1 = (int_mask |
    leaf_mask << 8, unused).  The kernel reads the table flat: node n,
    child c, column k is word (n * 8 + c) * 8 + k.
    """

    nodes: Array  # (Nd*8, 8) i32 child rows with embedded meta
    meta: Array  # (Nd, 4) i32: first_child, first_leaf, masks, pad
    tris: Array  # (Tp, 16) f32 vertex rows in packed-leaf order
    # Hit-assembly arrays in packed order (indexed by kernel slot output).
    tri_v: Array  # (Tp, 3, 3) f32
    tri_vidx: Array  # (Tp, 3) i32
    tri_mesh: Array  # (Tp,) i32
    tri_prim: Array  # (Tp,) i32
    # Refit mappings.
    slot_src: Array  # (Nd, 8) i32: binary node id / leaf code / -1 per slot
    tri_perm: Array  # (Tp,) i32 old sorted-tri slot per new slot
    num_tris: int = static_field()
    leaf_size: int = static_field()

    @property
    def num_nodes(self) -> int:
        return self.meta.shape[0]

    @property
    def num_padded_tris(self) -> int:
        return self.tri_v.shape[0]


def _area(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    d = np.maximum(hi - lo, 0.0)
    return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]


def _greedy_slots(left, right, area, root=0, w=W):
    """Greedy wide collapse, level by level (vectorised host NumPy).

    Returns slot_src (Nd, 8) int64 (binary id >= 0, leaf code <= -2,
    -1 empty) in BFS order from `root`; internal children appear in
    row-major slot order, which is exactly the contiguous-child numbering.

    `root` may be an ARRAY of binary roots (disjoint subtrees): one
    vectorised BFS packs the whole forest, root r landing at packed row r
    (multi-root numbering needs _pack_meta(root_rows=len(root))).  Leaf
    codes (<= -2) are allowed as roots and become single-leaf rows; -1
    roots become EMPTY rows (no children, inverted bounds) — the march
    kernel adopts cells by index, so empty grid cells need a real row
    that drains in one pop.
    """
    levels = []
    frontier = np.atleast_1d(np.asarray(root, np.int64))
    first = True
    while frontier.size:
        f = frontier.shape[0]
        slots = np.full((f, w), -1, np.int64)
        if first:
            isleaf = frontier <= -2
            isempty = frontier == -1
            fc = np.clip(frontier, 0, None)
            slots[:, 0] = np.where(isempty, -1,
                                   np.where(isleaf, frontier, left[fc]))
            slots[:, 1] = np.where(isleaf | isempty, -1, right[fc])
            first = False
        else:
            slots[:, 0] = left[frontier]
            slots[:, 1] = right[frontier]
        nslots = np.full(f, 2, np.int64)
        rows = np.arange(f)
        for _ in range(w - 2):
            internal = slots >= 0
            a = np.where(internal, area[np.clip(slots, 0, None)], -np.inf)
            a[nslots >= w] = -np.inf  # no free slot left
            pick = a.argmax(1)
            ok = a[rows, pick] > -np.inf
            b = slots[rows, pick]
            bc = np.clip(b, 0, None)
            r = rows[ok]
            slots[r, pick[ok]] = left[bc][ok]
            slots[r, nslots[ok]] = right[bc][ok]
            nslots[ok] += 1
        levels.append(slots)
        frontier = slots[slots >= 0]
    return np.concatenate(levels, axis=0)


def _pack_meta(slot_src: np.ndarray, node_base: int = 0,
               leaf_base: int = 0, root_rows: int = 1):
    """(first_child, first_leaf, masks) per node + leaf visit order.

    node_base/leaf_base offset the contiguous numbering for multi-root
    (merged-BLAS) packing.  root_rows: number of level-0 rows (a multi-
    root BFS from _greedy_slots(root=array) puts all R roots first, so
    the first child row is R, not 1)."""
    int_m = slot_src >= 0
    leaf_m = slot_src <= -2
    n_int = int_m.sum(1)
    n_leaf = leaf_m.sum(1)
    fc = node_base + root_rows + np.concatenate(
        [[0], np.cumsum(n_int)[:-1]])
    fl = leaf_base + np.concatenate([[0], np.cumsum(n_leaf)[:-1]])
    w = slot_src.shape[1]
    bits = 1 << np.arange(w, dtype=np.int64)[None, :]
    # leaf mask rides above the int mask: shift = w (8 for the classic
    # tables, 16 for W=16 — the kernel unpacks with the same shift).
    masks = (int_m * bits).sum(1) | ((leaf_m * bits).sum(1) << w)
    leaf_order = -slot_src[leaf_m] - 2  # row-major == fl ranks
    meta = np.stack(
        [fc, fl, masks, np.zeros_like(fc)], axis=1).astype(np.int32)
    return meta, leaf_order.astype(np.int64)


@functools.partial(jax.jit, static_argnames=("n_rows",))
def _gather_rows(bin_min, bin_max, leaf_min, leaf_max, slot_src, meta, *,
                 n_rows):
    """Build (Nd*8, 8) i32 child rows (jit; reused by refit repack)."""
    internal = slot_src >= 0
    leaf = slot_src <= -2
    si = jnp.clip(slot_src, 0, bin_min.shape[0] - 1)
    li = jnp.clip(-slot_src - 2, 0, leaf_min.shape[0] - 1)
    comps = []
    for c in range(3):
        b = jnp.take(bin_min[:, c], si)
        l = jnp.take(leaf_min[:, c], li)
        comps.append(jnp.where(internal, b,
                               jnp.where(leaf, l, jnp.float32(1.0))))
    for c in range(3):
        b = jnp.take(bin_max[:, c], si)
        l = jnp.take(leaf_max[:, c], li)
        comps.append(jnp.where(internal, b,
                               jnp.where(leaf, l, jnp.float32(-1.0))))
    w = slot_src.shape[1]
    bounds = jax.lax.bitcast_convert_type(
        jnp.stack(comps, axis=-1), jnp.int32)  # (Nd, W, 6) i32
    pad = jnp.zeros((n_rows, w, 1), jnp.int32)
    rows = jnp.concatenate([bounds, pad, pad], axis=2)  # (Nd, W, 8)
    rows = rows.at[:, 0, 6].set(meta[:, 0])
    rows = rows.at[:, 0, 7].set(meta[:, 1])
    rows = rows.at[:, 1, 6].set(meta[:, 2])
    return rows.reshape(n_rows * w, 8)


MASK_COL = 9  # filter-mask column in the kernel tri row (an exact float
              # value: integers <= 2^24 survive)
MASK_ALL = float(0xFFFFFF)  # 24-bit all-pass mask
MESH_COL = 10  # mesh index as an exact float value (filter callables)
PRIM_COL = 11  # triangle index as an exact float value (<= 2^24 exact;
               # trace_packets rejects filter_fn on bigger soups)


@functools.partial(jax.jit, static_argnames=())
def _tri_rows(tri_v, valid, mask=None, mesh=None, prim=None):
    """Kernel triangle table rows.  Padding slots (valid=False) become NaN
    vertices: the intersector rejects them via the t-window without ever
    triggering the exact-sign zero-edge path (NaN == 0 is false), unlike
    zero-filled rows whose edge functions are exactly zero.

    Column MASK_COL carries the per-triangle filter-mask bits (the packet
    engine's built-in filter family, rtk.h:117,130 intent) as an exact
    float value; all-pass when no mask is given.  Columns MESH_COL and
    PRIM_COL carry the triangle's identity (mesh index, original triangle
    index) as exact float values so in-kernel filter callables can see
    the candidate's identity without a gather."""
    tp = tri_v.shape[0]
    flat = jnp.where(valid[:, None], tri_v.reshape(tp, 9), jnp.nan)
    if mask is None:
        mcol = jnp.full((tp, 1), MASK_ALL, jnp.float32)
    else:
        mcol = jnp.asarray(mask, jnp.float32).reshape(tp, 1)
    mesh_c = (jnp.zeros((tp, 1), jnp.float32) if mesh is None
              else jnp.asarray(mesh, jnp.float32).reshape(tp, 1))
    prim_c = (jnp.full((tp, 1), -1.0, jnp.float32) if prim is None
              else jnp.asarray(prim, jnp.float32).reshape(tp, 1))
    return jnp.concatenate(
        [flat, mcol, mesh_c, prim_c, jnp.zeros((tp, 4), jnp.float32)],
        axis=1)


def pack_scene(scene: Scene, tri_mask=None) -> PackedScene:
    """Pack a built Scene for the traversal kernel.

    tri_mask: optional (num_tris,) uint32 per-triangle filter-mask bits in
    ORIGINAL soup order (24 bits used).  A trace with filter_mask=m tests
    only triangles with (tri_mask & m) != 0 — the packet-kernel filter
    family; arbitrary callables stay on the XLA stack engine)."""
    k = scene.leaf_size
    if scene.num_leaves == 1:
        slot_src = np.full((1, W), -1, np.int64)
        slot_src[0, 0] = -2  # leaf 0
    else:
        left = np.asarray(scene.bin_left, np.int64)
        right = np.asarray(scene.bin_right, np.int64)
        area = _area(np.asarray(scene.bin_min), np.asarray(scene.bin_max))
        slot_src = _greedy_slots(left, right, area)
    meta, leaf_order = _pack_meta(slot_src)
    assert leaf_order.shape[0] == scene.num_leaves

    tri_perm = (leaf_order[:, None] * k + np.arange(k)[None, :]).reshape(-1)
    tri_perm = tri_perm.astype(np.int32)
    slot_src_j = jnp.asarray(slot_src, jnp.int32)
    meta_j = jnp.asarray(meta)
    nodes = _gather_rows(scene.bin_min, scene.bin_max, scene.leaf_min,
                         scene.leaf_max, slot_src_j, meta_j,
                         n_rows=slot_src.shape[0])
    perm = jnp.asarray(tri_perm)
    tri_v = jnp.take(scene.tri_v, perm, axis=0)
    tri_prim_p = jnp.take(scene.tri_prim, perm, axis=0)
    mask_p = None
    if tri_mask is not None:
        tri_mask = np.asarray(tri_mask, np.int64)
        if (tri_mask >> 24).any():
            raise ValueError("tri_mask uses more than 24 bits")
        # soup order -> Morton-sorted order -> packed order.
        soup_of_sorted = np.asarray(scene.perm)
        sorted_mask = np.where(
            soup_of_sorted >= 0,
            tri_mask[np.clip(soup_of_sorted, 0, tri_mask.shape[0] - 1)], 0)
        mask_p = sorted_mask[np.asarray(tri_perm)].astype(np.float64)
    tri_mesh_p = jnp.take(scene.tri_mesh, perm, axis=0)
    return PackedScene(
        nodes=nodes,
        meta=meta_j,
        tris=_tri_rows(tri_v, tri_prim_p >= 0, mask_p, tri_mesh_p,
                       tri_prim_p),
        tri_v=tri_v,
        tri_vidx=jnp.take(scene.tri_vidx, perm, axis=0),
        tri_mesh=tri_mesh_p,
        tri_prim=tri_prim_p,
        slot_src=slot_src_j,
        tri_perm=perm,
        num_tris=scene.num_tris,
        leaf_size=k,
    )


def pack_multiroot(scene: Scene, roots, tri_mask=None) -> PackedScene:
    """Pack a FOREST of disjoint subtrees of one Scene in a single
    vectorised BFS (one _greedy_slots call for all roots — unlike
    pack_forest's per-root host loop, this stays fast at thousands of
    roots, e.g. the macro-grid engine's per-cell trees).

    `roots`: (R,) binary node ids (or leaf codes <= -2 for single-leaf
    subtrees, or -1 for EMPTY rows) whose subtrees must be disjoint and
    jointly cover every leaf exactly once.  The packed entry id of root
    r is simply r — the march kernel relies on this to adopt grid cells
    by cell index with no lookup table.

    tri_mask: optional (num_tris,) per-triangle filter bits in ORIGINAL
    soup order (24 bits), same semantics as pack_scene.
    """
    roots = np.asarray(roots, np.int64)
    k = scene.leaf_size
    left = np.asarray(scene.bin_left, np.int64)
    right = np.asarray(scene.bin_right, np.int64)
    area = _area(np.asarray(scene.bin_min), np.asarray(scene.bin_max))
    slot_src = _greedy_slots(left, right, area, root=roots)
    meta, leaf_order = _pack_meta(slot_src, root_rows=roots.shape[0])
    assert leaf_order.shape[0] == scene.num_leaves, \
        (leaf_order.shape[0], scene.num_leaves)

    tri_perm = (leaf_order[:, None] * k + np.arange(k)[None, :]).reshape(-1)
    tri_perm = tri_perm.astype(np.int32)
    slot_src_j = jnp.asarray(slot_src, jnp.int32)
    meta_j = jnp.asarray(meta)
    nodes = _gather_rows(scene.bin_min, scene.bin_max, scene.leaf_min,
                         scene.leaf_max, slot_src_j, meta_j,
                         n_rows=slot_src.shape[0])
    perm = jnp.asarray(tri_perm)
    tri_v = jnp.take(scene.tri_v, perm, axis=0)
    tri_prim_p = jnp.take(scene.tri_prim, perm, axis=0)
    tri_mesh_p = jnp.take(scene.tri_mesh, perm, axis=0)
    mask_p = None
    if tri_mask is not None:
        tri_mask = np.asarray(tri_mask, np.int64)
        if (tri_mask >> 24).any():
            raise ValueError("tri_mask uses more than 24 bits")
        # soup order -> Morton-sorted order -> packed order.
        soup_of_sorted = np.asarray(scene.perm)
        sorted_mask = np.where(
            soup_of_sorted >= 0,
            tri_mask[np.clip(soup_of_sorted, 0, tri_mask.shape[0] - 1)], 0)
        mask_p = sorted_mask[np.asarray(tri_perm)].astype(np.float64)
    return PackedScene(
        nodes=nodes,
        meta=meta_j,
        tris=_tri_rows(tri_v, tri_prim_p >= 0, mask_p, tri_mesh_p,
                       tri_prim_p),
        tri_v=tri_v,
        tri_vidx=jnp.take(scene.tri_vidx, perm, axis=0),
        tri_mesh=tri_mesh_p,
        tri_prim=tri_prim_p,
        slot_src=slot_src_j,
        tri_perm=perm,
        num_tris=scene.num_tris,
        leaf_size=k,
    )


@pytree_dataclass
class BinaryRefitAux:
    """Refit mappings for a host-built binary tree (pack_binary_tree).

    A binned-SAH builder partitions triangles IN PLACE, so every binary
    node covers a contiguous run of the leaf sequence ordered by first
    triangle — the same property Karras nodes get from the Morton sort.
    That makes the LBVH's RMQ refit (builder/lbvh.py refit_ranges)
    directly applicable: these arrays carry each node's leaf-rank range
    plus the static permutations between the three leaf numberings
    (rank = tri-order, lidx = binary-node-id order used by slot_src,
    visit = packed tri-table block order).  Built once on the host by
    pack_binary_tree(return_refit_aux=True); verified contiguous at
    build time."""

    rank_lo: Array  # (Nn,) i32 first leaf rank under binary node
    rank_hi: Array  # (Nn,) i32 last leaf rank (inclusive)
    visit_of_rank: Array  # (nl,) i32 packed leaf-visit block of rank r
    visit_of_lidx: Array  # (nl,) i32 packed leaf-visit block of lidx l


def refit_packed_binary(packed: PackedScene, aux: BinaryRefitAux,
                        new_tri_pos) -> PackedScene:
    """Refit a pack_binary_tree PackedScene to deformed vertices (same
    topology) entirely on device — the SAH analogue of Scene.refit +
    repack_bounds, so deforming scenes can keep the step-quantized SAH
    topology's trace win instead of falling back to LBVH.

    new_tri_pos: (T, 3, 3) vertices in ORIGINAL SOUP order (the
    pack_binary_tree tri_perm convention).  Jittable; cost is the same
    class as the LBVH refit prep (per-leaf bounds + log2(nl) RMQ levels
    + the repack gathers).
    """
    from rtk_tpu.builder.lbvh import refit_ranges_flat

    tri_pos = jnp.asarray(new_tri_pos, jnp.float32)
    safe = jnp.clip(packed.tri_perm, 0, packed.num_tris - 1)
    tri_v = jnp.take(tri_pos, safe, axis=0)
    valid = packed.tri_perm >= 0
    k = packed.leaf_size
    nl = aux.visit_of_rank.shape[0]
    # Per-leaf bounds straight from the packed tri rows (visit order):
    # each visit block is k consecutive tri rows; padding rows must not
    # shrink/grow the box, so they pad with +/-inf.
    vmin = jnp.where(valid[:, None, None], tri_v, jnp.inf)
    vmax = jnp.where(valid[:, None, None], tri_v, -jnp.inf)
    lmin_visit = jnp.min(vmin.reshape(nl, k * 3, 3), axis=1)
    lmax_visit = jnp.max(vmax.reshape(nl, k * 3, 3), axis=1)
    if nl == 1:
        bmin, bmax = lmin_visit, lmax_visit
    else:
        lmin_rank = jnp.take(lmin_visit, aux.visit_of_rank, axis=0)
        lmax_rank = jnp.take(lmax_visit, aux.visit_of_rank, axis=0)
        bmin, bmax = refit_ranges_flat(aux.rank_lo, aux.rank_hi,
                                       lmin_rank, lmax_rank)
    lmin_lidx = jnp.take(lmin_visit, aux.visit_of_lidx, axis=0)
    lmax_lidx = jnp.take(lmax_visit, aux.visit_of_lidx, axis=0)
    nodes = _gather_rows(bmin, bmax, lmin_lidx, lmax_lidx,
                         packed.slot_src, packed.meta,
                         n_rows=packed.num_nodes)
    tp = tri_v.shape[0]
    mask_col = packed.tris[:tp, MASK_COL]  # mask col rides along
    return dataclasses.replace(
        packed,
        nodes=nodes,
        tris=_tri_rows(tri_v, valid, mask_col, packed.tri_mesh,
                       packed.tri_prim),
        tri_v=tri_v)


def _binary_refit_aux(left, right, first, count, is_leaf, leaf_nodes,
                      roots, leaf_order) -> BinaryRefitAux:
    """Host-side BinaryRefitAux construction (see class docstring).

    Asserts the in-place-partition contiguity invariant the RMQ refit
    needs: every internal node's children split its triangle range."""
    nn = left.shape[0]
    nl = leaf_nodes.shape[0]
    tri_lo = np.where(is_leaf, first, 0)
    tri_hi = np.where(is_leaf, first + count, 0)
    # BFS levels of internal nodes (leaf roots contribute no levels).
    rts = roots[roots >= 0]
    levels = []
    frontier = rts[~is_leaf[rts]]
    while frontier.size:
        levels.append(frontier)
        ch = np.concatenate([left[frontier], right[frontier]])
        frontier = ch[~is_leaf[ch]]
    for f in reversed(levels):
        l, r = left[f], right[f]
        tri_lo[f] = np.minimum(tri_lo[l], tri_lo[r])
        tri_hi[f] = np.maximum(tri_hi[l], tri_hi[r])
    for f in levels:
        l, r = left[f], right[f]
        straddle = ((np.minimum(tri_lo[l], tri_lo[r]) == tri_lo[f])
                    & (np.maximum(tri_hi[l], tri_hi[r]) == tri_hi[f])
                    & ((tri_hi[l] == tri_lo[r]) | (tri_hi[r] == tri_lo[l])))
        if not straddle.all():
            raise ValueError(
                "binary tree is not an in-place partition (children do not "
                "split their parent's triangle range); refit aux requires "
                "a contiguous-range builder")
    leaf_firsts = first[leaf_nodes]
    rank_order = np.argsort(leaf_firsts, kind="stable")  # rank -> lidx
    sorted_firsts = leaf_firsts[rank_order]
    rank_lo = np.searchsorted(sorted_firsts, tri_lo).astype(np.int64)
    rank_hi = (np.searchsorted(sorted_firsts, tri_hi, side="left")
               - 1).astype(np.int64)
    if not ((rank_lo <= rank_hi).all() and (rank_hi < nl).all()):
        raise ValueError(
            "malformed binary tree: leaf-rank ranges are inconsistent "
            "(empty leaves or out-of-range triangle spans); refit aux "
            "cannot be derived")
    visit_of_lidx = np.empty(nl, np.int64)
    visit_of_lidx[leaf_order] = np.arange(nl)
    return BinaryRefitAux(
        rank_lo=jnp.asarray(rank_lo, jnp.int32),
        rank_hi=jnp.asarray(rank_hi, jnp.int32),
        visit_of_rank=jnp.asarray(visit_of_lidx[rank_order], jnp.int32),
        visit_of_lidx=jnp.asarray(visit_of_lidx, jnp.int32),
    )


def pack_binary_tree(tri_v, left, right, first, count, box_lo, box_hi,
                     order, root, leaf_size: int, tri_vidx=None,
                     tri_mesh=None, tri_prim=None,
                     tri_mask=None, return_refit_aux: bool = False):
    """Pack an ARBITRARY host-built binary BVH for the traversal kernel.

    Feeds any binary topology (e.g. the corrected-rtk C++ oracle's binned
    SAH via NativeOracle.export_tree) through the same greedy wide
    collapse as pack_scene — the SAH build option, and the apparatus for
    topology-quality experiments (SAH vs Morton under an identical
    kernel).

    left/right: child node id or -1 for leaves; first/count index into
    `order` (leaf triangle lists, <= leaf_size each); box_lo/hi: (Nn, 3)
    node bounds.  tri_v: (T, 3, 3) soup; tri_perm holds original soup
    ids (pad -1).  return_refit_aux=True additionally returns a
    BinaryRefitAux so refit_packed_binary can refit the result on device
    (requires an in-place-partition topology, which the native binned
    SAH is; raises ValueError otherwise).

    `root` may be an ARRAY of binary root ids whose subtrees are
    disjoint and jointly cover every leaf exactly once (a forest, e.g.
    per-BLAS host-SAH trees for the instanced path): packed entry id of
    root r is then simply r (pack_multiroot convention).
    """
    left = np.asarray(left, np.int64)
    right = np.asarray(right, np.int64)
    first = np.asarray(first, np.int64)
    count = np.asarray(count, np.int64)
    box_lo = np.asarray(box_lo, np.float32)
    box_hi = np.asarray(box_hi, np.float32)
    order = np.asarray(order, np.int64)
    k = leaf_size
    if count.size and count.max() > k:
        raise ValueError(f"leaf count {count.max()} exceeds leaf_size {k}")

    is_leaf = left < 0
    leaf_nodes = np.nonzero(is_leaf)[0]
    nl = leaf_nodes.shape[0]
    lidx = np.full(left.shape[0], -1, np.int64)
    lidx[leaf_nodes] = np.arange(nl)

    def mapped(child):
        c = np.clip(child, 0, None)
        return np.where(is_leaf[c], -(lidx[c] + 2), child)

    lm = mapped(left)
    rm = mapped(right)
    roots = np.asarray(root, np.int64).reshape(-1)
    roots_m = np.where(is_leaf[roots], -(lidx[roots] + 2), roots)
    if np.ndim(root) == 0:
        slot_src = _greedy_slots(lm, rm, _area(box_lo, box_hi),
                                 root=int(roots_m[0]))
        meta, leaf_order = _pack_meta(slot_src)
    else:
        # Forest: packed entry id of root r is r (root rows reserved
        # first, pack_multiroot convention) — multi-BLAS SAH tables.
        slot_src = _greedy_slots(lm, rm, _area(box_lo, box_hi),
                                 root=roots_m)
        meta, leaf_order = _pack_meta(slot_src,
                                      root_rows=roots_m.shape[0])
    assert leaf_order.shape[0] == nl, (leaf_order.shape[0], nl)

    # (nl, k) triangle ids per leaf (pad -1), in leaf-visit order.
    tids = np.full((nl, k), -1, np.int64)
    col = np.arange(k)[None, :]
    fc_ = first[leaf_nodes][:, None]
    cn_ = count[leaf_nodes][:, None]
    take = col < cn_
    tids[take] = order[(fc_ + np.minimum(col, cn_ - 1))[take]]
    tri_ids = tids[leaf_order].reshape(-1)

    tri_v = jnp.asarray(tri_v, jnp.float32)
    T = tri_v.shape[0]
    valid = tri_ids >= 0
    gather = jnp.asarray(np.where(valid, tri_ids, 0).astype(np.int32))
    tv = jnp.take(tri_v, gather, axis=0)
    validj = jnp.asarray(valid)
    if tri_vidx is None:
        tvi = (gather[:, None] * 3
               + jnp.arange(3, dtype=jnp.int32)[None, :])
    else:
        tvi = jnp.take(jnp.asarray(tri_vidx, jnp.int32), gather, axis=0)
    tm = (jnp.zeros_like(gather) if tri_mesh is None
          else jnp.take(jnp.asarray(tri_mesh, jnp.int32), gather))
    tp_ = (gather if tri_prim is None
           else jnp.take(jnp.asarray(tri_prim, jnp.int32), gather))
    tp_ = jnp.where(validj, tp_, -1)
    mask = None
    if tri_mask is not None:
        mask = np.asarray(
            jnp.take(jnp.asarray(tri_mask, jnp.uint32), gather)
        ).astype(np.float32)

    slot_src_j = jnp.asarray(slot_src, jnp.int32)
    meta_j = jnp.asarray(meta)
    nodes = _gather_rows(jnp.asarray(box_lo), jnp.asarray(box_hi),
                         jnp.asarray(box_lo[leaf_nodes]),
                         jnp.asarray(box_hi[leaf_nodes]),
                         slot_src_j, meta_j, n_rows=slot_src.shape[0])
    aux = (_binary_refit_aux(left, right, first, count, is_leaf,
                             leaf_nodes, roots, leaf_order)
           if return_refit_aux else None)
    packed = PackedScene(
        nodes=nodes,
        meta=meta_j,
        tris=_tri_rows(tv, validj, mask, tm, tp_),
        tri_v=tv,
        tri_vidx=tvi,
        tri_mesh=tm,
        tri_prim=tp_,
        slot_src=slot_src_j,
        tri_perm=jnp.asarray(np.where(valid, tri_ids, -1).astype(np.int32)),
        num_tris=int(T),
        leaf_size=k,
    )
    return (packed, aux) if return_refit_aux else packed


def repack_bounds(packed: PackedScene, scene: Scene) -> PackedScene:
    """Refresh a PackedScene after Scene.refit (same topology, new bounds)."""
    nodes = _gather_rows(scene.bin_min, scene.bin_max, scene.leaf_min,
                         scene.leaf_max, packed.slot_src, packed.meta,
                         n_rows=packed.num_nodes)
    tri_v = jnp.take(scene.tri_v, packed.tri_perm, axis=0)
    tp = tri_v.shape[0]
    mask_col = packed.tris[:tp, MASK_COL]  # mask col rides along
    return dataclasses.replace(
        packed,
        nodes=nodes,
        tris=_tri_rows(tri_v, packed.tri_prim >= 0, mask_col,
                       packed.tri_mesh, packed.tri_prim),
        tri_v=tri_v)


def pack_forest(scene: Scene, roots) -> tuple[PackedScene, np.ndarray]:
    """Pack a multi-root (merged-BLAS) Scene for the packet kernel.

    `roots` are binary root node ids in the merged space (one per BLAS).
    Returns (packed, packed_roots) where packed_roots[b] is the packed node
    id to start traversal at for BLAS b.
    """
    k = scene.leaf_size
    left = np.asarray(scene.bin_left, np.int64)
    right = np.asarray(scene.bin_right, np.int64)
    area = _area(np.asarray(scene.bin_min), np.asarray(scene.bin_max))

    slot_parts, meta_parts, leaf_parts = [], [], []
    packed_roots = []
    node_base = 0
    leaf_base = 0
    for r in np.asarray(roots, np.int64):
        ss = _greedy_slots(left, right, area, root=int(r))
        meta, leaf_order = _pack_meta(ss, node_base=node_base,
                                      leaf_base=leaf_base)
        packed_roots.append(node_base)
        node_base += ss.shape[0]
        leaf_base += leaf_order.shape[0]
        slot_parts.append(ss)
        meta_parts.append(meta)
        leaf_parts.append(leaf_order)
    slot_src = np.concatenate(slot_parts)
    meta = np.concatenate(meta_parts)
    leaf_order = np.concatenate(leaf_parts)

    tri_perm = (leaf_order[:, None] * k + np.arange(k)[None, :]).reshape(-1)
    tri_perm = tri_perm.astype(np.int32)
    slot_src_j = jnp.asarray(slot_src, jnp.int32)
    meta_j = jnp.asarray(meta)
    nodes = _gather_rows(scene.bin_min, scene.bin_max, scene.leaf_min,
                         scene.leaf_max, slot_src_j, meta_j,
                         n_rows=slot_src.shape[0])
    perm = jnp.asarray(tri_perm)
    tri_v = jnp.take(scene.tri_v, perm, axis=0)
    tri_prim_p = jnp.take(scene.tri_prim, perm, axis=0)
    tri_mesh_p = jnp.take(scene.tri_mesh, perm, axis=0)
    packed = PackedScene(
        nodes=nodes,
        meta=meta_j,
        tris=_tri_rows(tri_v, tri_prim_p >= 0, None, tri_mesh_p,
                       tri_prim_p),
        tri_v=tri_v,
        tri_vidx=jnp.take(scene.tri_vidx, perm, axis=0),
        tri_mesh=tri_mesh_p,
        tri_prim=tri_prim_p,
        slot_src=slot_src_j,
        tri_perm=perm,
        num_tris=scene.num_tris,
        leaf_size=k,
    )
    return packed, np.asarray(packed_roots, np.int32)
