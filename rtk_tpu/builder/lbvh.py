"""LBVH topology from sorted Morton codes (Karras 2012), fully on-device.

Replaces the reference's task-recursive SAH builder (rtk.c:867-1019) with a
sort-based construction: every step below is a fixed-trip-count loop of dense
vector ops over all nodes at once — no recursion, no atomics, no dynamic
shapes — which is what XLA wants.

Numbering: L leaves (Morton-sorted triangle clusters), L-1 internal nodes.
Internal node i covers a contiguous range of sorted leaves; node 0 is the
root.  Child encoding (shared with traversal):
    >= 0 : internal node index
    == -1: empty slot
    <= -2: leaf, id = -(child) - 2
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp

Array = jax.Array

EMPTY = -1  # python int: keep module constants off-device


def leaf_code(leaf_id):
    return -leaf_id - 2


def is_leaf_code(child):
    return child <= -2


def leaf_id_of(child):
    return -child - 2


def _delta(i: Array, j: Array, codes: Array, length: int) -> Array:
    """Common-prefix length of augmented keys (code, index); -1 outside range.

    Duplicate Morton codes fall back to index bits (total order), the
    standard Karras duplicate-key treatment.
    """
    valid = (j >= 0) & (j < length)
    jc = jnp.clip(j, 0, length - 1)
    ci = jnp.take(codes, i)
    cj = jnp.take(codes, jc)
    x = ci ^ cj
    xi = (i ^ jc).astype(jnp.uint32)
    d = jnp.where(
        x == 0,
        32 + jax.lax.clz(xi).astype(jnp.int32),
        jax.lax.clz(x).astype(jnp.int32),
    )
    return jnp.where(valid, d, jnp.int32(-1))


def karras_topology(codes: Array):
    """Binary radix-tree topology over L sorted Morton codes.

    Returns (left, right): (L-1,) child arrays in the shared encoding.
    Requires L >= 2 (callers special-case L == 1).
    """
    length = codes.shape[0]
    assert length >= 2
    codes = jnp.asarray(codes, jnp.uint32)
    i = jnp.arange(length - 1, dtype=jnp.int32)
    k_iters = max(1, math.ceil(math.log2(length))) + 1

    d = jnp.where(
        _delta(i, i + 1, codes, length) > _delta(i, i - 1, codes, length), 1, -1
    ).astype(jnp.int32)
    dmin = _delta(i, i - d, codes, length)

    # Exponential search for an upper bound on the range length.
    # (fori_loops, not Python unrolls: the unrolled form blew compile time
    # up to minutes for large scenes.)
    def grow_body(_, lmax):
        grow = _delta(i, i + lmax * d, codes, length) > dmin
        return jnp.where(grow, lmax * 2, lmax)

    lmax = jax.lax.fori_loop(0, k_iters, grow_body, jnp.full_like(i, 2))

    # Binary search for the exact other end of the range.
    def bin_body(s, l):
        t_step = lmax >> (s + 1)
        take = (t_step >= 1) & (
            _delta(i, i + (l + t_step) * d, codes, length) > dmin
        )
        return jnp.where(take, l + t_step, l)

    l = jax.lax.fori_loop(0, k_iters + 1, bin_body, jnp.zeros_like(i))

    j = i + l * d
    dnode = _delta(i, j, codes, length)

    # Split search (do-while with per-lane ceil-halving step).
    def split_body(_, carry):
        s, t, done = carry
        t2 = (t + 1) >> 1
        take = (~done) & (_delta(i, i + (s + t2) * d, codes, length) > dnode)
        s = jnp.where(take, s + t2, s)
        return s, t2, done | (t2 <= 1)

    s, _, _ = jax.lax.fori_loop(
        0, k_iters + 2, split_body,
        (jnp.zeros_like(i), l, jnp.zeros_like(i, dtype=bool)))

    gamma = i + s * d + jnp.minimum(d, 0)
    lo = jnp.minimum(i, j)
    hi = jnp.maximum(i, j)
    left = jnp.where(lo == gamma, leaf_code(gamma), gamma)
    right = jnp.where(hi == gamma + 1, leaf_code(gamma + 1), gamma + 1)
    # (lo, hi): the node's contiguous leaf range — the key property that
    # lets refit run as range-min/max queries instead of height passes.
    return (left.astype(jnp.int32), right.astype(jnp.int32),
            lo.astype(jnp.int32), hi.astype(jnp.int32))


def _aug_delta(codes: Array) -> Array:
    """Adjacent-pair common-prefix lengths of augmented (code, index) keys.

    A[k] = delta(k, k+1) in Karras terms: clz of the code xor, falling
    back to 32 + clz(index xor) for duplicate codes (total order).  All
    range deltas reduce to range-mins of this array (the sorted-sequence
    LCP property), which is what lets the topology come from scans
    instead of per-node binary searches.
    """
    n = codes.shape[0] - 1
    c0 = codes[:-1]
    c1 = codes[1:]
    k = jnp.arange(n, dtype=jnp.uint32)
    x = c0 ^ c1
    di = 32 + jax.lax.clz(k ^ (k + jnp.uint32(1))).astype(jnp.int32)
    dc = jax.lax.clz(x).astype(jnp.int32)
    return jnp.where(x == 0, di, dc)


_A_MAX = 64  # augmented deltas live in [0, 63]


def karras_topology_scan(codes: Array):
    """Binary radix-tree topology via value-stratified scans (gather-light).

    Same contract as karras_topology (left, right, lo, hi with node 0 the
    root), built as the Cartesian tree of the adjacent-delta array under
    the lexicographic (delta, position) tie rule:

      * node = split position s (the gap between sorted leaves s, s+1);
      * its leaf range comes from all-nearest-smaller-values of A, which
        stratifies over A's 64 possible values into masked cummax/cummin
        scans — dense vector work, NO data-dependent gathers;
      * parent links are Apetrei-style boundary comparisons (2 gathers),
        children land via 4 scatters; node 0 swaps with the root split.

    Replaces karras_topology's ~130 sequential fori-loop gather passes
    (exponential + binary + split searches) for large builds; the tree
    may differ from karras_topology at exact delta ties (both are valid
    radix trees; prefix-group ranges — e.g. the grid engine's cell
    prefixes — form exact subtrees in either).
    """
    length = codes.shape[0]
    assert length >= 2
    codes = jnp.asarray(codes, jnp.uint32)
    ns = length - 1
    A = _aug_delta(codes)
    iota = jnp.arange(ns, dtype=jnp.int32)
    v = jnp.arange(_A_MAX, dtype=jnp.int32)[:, None]
    onehot = A[None, :] == v

    # Left ANSV: last j < s with A[j] <= A[s] (lex tie rule folds the
    # index comparison into <=), else -1.
    ml = jnp.where(A[None, :] <= v, iota[None, :], -1)
    cl = jax.lax.cummax(ml, axis=1)
    cl = jnp.concatenate(
        [jnp.full((_A_MAX, 1), -1, jnp.int32), cl[:, :-1]], axis=1)
    lidx = jnp.sum(jnp.where(onehot, cl, 0), axis=0)

    # Right ANSV: first j > s with A[j] < A[s] (strict), else ns.
    mr = jnp.where(A[None, :] < v, iota[None, :], ns)
    cr = jax.lax.cummin(mr, axis=1, reverse=True)
    cr = jnp.concatenate(
        [cr[:, 1:], jnp.full((_A_MAX, 1), ns, jnp.int32)], axis=1)
    ridx = jnp.sum(jnp.where(onehot, cr, 0), axis=0)

    lo = lidx + 1  # first leaf of node s's range
    hi = ridx      # last leaf (split index ns == leaf index L-1 sentinel)

    # Parent = the lexicographically deeper of the two boundary splits
    # (ties pick the right boundary: larger index = lex greater).
    a1 = lo - 1
    Aa = jnp.take(A, jnp.clip(a1, 0, ns - 1))
    Ab = jnp.take(A, jnp.clip(hi, 0, ns - 1))
    has_l = a1 >= 0
    has_r = hi < ns
    is_root = (~has_l) & (~has_r)
    parent = jnp.where(has_l & (~has_r | (Aa > Ab)), a1, hi)
    side_right = parent == a1  # node is its parent's right child

    # Leaves: boundaries are splits i-1 and i; same deeper-boundary rule.
    li = jnp.arange(length, dtype=jnp.int32)
    Ap = jnp.concatenate([jnp.full((1,), -1, jnp.int32), A])      # A[i-1]
    An = jnp.concatenate([A, jnp.full((1,), -1, jnp.int32)])      # A[i]
    lhas_l = li >= 1
    lhas_r = li < ns
    lparent = jnp.where(lhas_l & (~lhas_r | (Ap > An)), li - 1, li)
    lside_right = lparent == li - 1

    left = jnp.full((ns,), EMPTY, jnp.int32)
    right = jnp.full((ns,), EMPTY, jnp.int32)
    tgt = jnp.where(is_root, ns, parent)  # root has no parent: drop
    left = left.at[jnp.where(side_right, ns, tgt)].set(iota, mode="drop")
    right = right.at[jnp.where(side_right, tgt, ns)].set(iota, mode="drop")
    lcode = -li - 2
    left = left.at[jnp.where(lside_right, ns, lparent)].set(
        lcode, mode="drop")
    right = right.at[jnp.where(lside_right, lparent, ns)].set(
        lcode, mode="drop")

    # Renumber so the root occupies row 0 (the Scene/collapse contract).
    root_s = jnp.argmax(is_root).astype(jnp.int32)

    def remap(c):
        internal = c >= 0
        swapped = jnp.where(c == root_s, 0,
                            jnp.where(c == 0, root_s, c))
        return jnp.where(internal, swapped, c)

    def swap0(arr):
        v0 = arr[0]
        vr = arr[root_s]
        return arr.at[0].set(vr).at[root_s].set(v0)

    return (swap0(remap(left)).astype(jnp.int32),
            swap0(remap(right)).astype(jnp.int32),
            swap0(lo).astype(jnp.int32),
            swap0(hi).astype(jnp.int32))


def node_parents(left: Array, right: Array) -> Array:
    """Parent index for each *internal* node (-1 for the root)."""
    n_int = left.shape[0]
    i = jnp.arange(n_int, dtype=jnp.int32)
    parent = jnp.full((n_int,), -1, jnp.int32)
    parent = parent.at[jnp.where(left >= 0, left, n_int)].set(i, mode="drop")
    parent = parent.at[jnp.where(right >= 0, right, n_int)].set(i, mode="drop")
    return parent


def node_depths(parent: Array) -> Array:
    """Depth of each internal node via pointer doubling (log passes)."""
    n_int = parent.shape[0]
    up = parent
    depth = jnp.where(up >= 0, 1, 0).astype(jnp.int32)
    iters = max(1, math.ceil(math.log2(max(n_int, 2)))) + 1
    for _ in range(iters):
        upc = jnp.clip(up, 0, n_int - 1)
        depth = depth + jnp.where(up >= 0, jnp.take(depth, upc), 0)
        up = jnp.where(up >= 0, jnp.take(up, upc), -1)
    return depth


def refit_ranges(lo: Array, hi: Array, leaf_min: Array, leaf_max: Array):
    """AABB refit via range-min/max over each node's contiguous leaf range.

    Karras nodes cover contiguous Morton-sorted leaf runs, so their
    bounds are RMQ queries: build a sparse table (log2 L dense shifted
    mins — no tree-structured gathers) and answer every node with two
    gathers.  Replaces the height-pass fixpoint refit, which cost ~20
    sequential gather passes per frame on the deforming-mesh config
    (r2 profile: refit was 6 of the 10.6 ms frame)."""
    n_leaf = leaf_min.shape[0]
    levels = max(1, math.ceil(math.log2(max(n_leaf, 2)))) + 1
    length = hi - lo + 1
    k = 31 - jax.lax.clz(jnp.maximum(length, 1))  # floor log2
    k = jnp.minimum(k, levels - 1)
    # Answer each node at its own level while the table is built, keeping
    # only the CURRENT level's shifted-min/max arrays live: stacking all
    # levels (the obvious sparse table) materializes O(n_leaf * log)
    # device memory — ~630 MB for a 10M-tri refit — for two gathers.
    node_min = jnp.zeros((lo.shape[0], 3), leaf_min.dtype)
    node_max = jnp.zeros((lo.shape[0], 3), leaf_max.dtype)
    cur_min, cur_max = leaf_min, leaf_max
    for lvl in range(levels):
        m = (k == lvl)[:, None]
        b = jnp.clip(hi - (1 << lvl) + 1, 0, n_leaf - 1)
        qmin = jnp.minimum(jnp.take(cur_min, lo, axis=0),
                           jnp.take(cur_min, b, axis=0))
        qmax = jnp.maximum(jnp.take(cur_max, lo, axis=0),
                           jnp.take(cur_max, b, axis=0))
        node_min = jnp.where(m, qmin, node_min)
        node_max = jnp.where(m, qmax, node_max)
        if lvl + 1 < levels:
            half = 1 << lvl
            idx = jnp.minimum(jnp.arange(n_leaf) + half, n_leaf - 1)
            cur_min = jnp.minimum(cur_min,
                                  jnp.take(cur_min, idx, axis=0))
            cur_max = jnp.maximum(cur_max,
                                  jnp.take(cur_max, idx, axis=0))
    return node_min, node_max


def refit_ranges_flat(lo: Array, hi: Array, leaf_min: Array, leaf_max: Array):
    """refit_ranges with slice-shift table levels and 4 total gathers.

    The incremental variant above answers nodes level-by-level: 4 row
    gathers per level x ~21 levels, and its window shifts are
    jnp.take(arange + half) — which XLA lowers as real gathers too.
    This variant builds every sparse-table level with static slices
    (edge-replicated pad), stacks them, and answers ALL nodes with two
    row gathers per bound from the flattened (levels*L, 3) table.  Costs
    O(L log L) transient memory (~630 MB at 10M tris — fine in 16 GB
    HBM); callers with tighter memory keep refit_ranges.
    """
    n_leaf = leaf_min.shape[0]
    levels = max(1, math.ceil(math.log2(max(n_leaf, 2)))) + 1
    mins = [leaf_min]
    maxs = [leaf_max]
    cur_min, cur_max = leaf_min, leaf_max
    for lvl in range(1, levels):
        half = 1 << (lvl - 1)
        if half < n_leaf:
            pad_min = jnp.broadcast_to(cur_min[-1:], (half, 3))
            pad_max = jnp.broadcast_to(cur_max[-1:], (half, 3))
            cur_min = jnp.minimum(
                cur_min, jnp.concatenate([cur_min[half:], pad_min]))
            cur_max = jnp.maximum(
                cur_max, jnp.concatenate([cur_max[half:], pad_max]))
        else:
            cur_min = jnp.minimum(
                cur_min, jnp.broadcast_to(cur_min[-1:], cur_min.shape))
            cur_max = jnp.maximum(
                cur_max, jnp.broadcast_to(cur_max[-1:], cur_max.shape))
        mins.append(cur_min)
        maxs.append(cur_max)
    # Fused (levels*L, 6) [min | max] table: TWO row gathers answer all
    # nodes (row gathers are latency-bound per ROW, nearly free in
    # width — build3.py).
    tab = jnp.concatenate(
        [jnp.concatenate([m, M], axis=1) for m, M in zip(mins, maxs)],
        axis=0)

    length = hi - lo + 1
    k = 31 - jax.lax.clz(jnp.maximum(length, 1))  # floor log2
    k = jnp.minimum(k, levels - 1)
    b = jnp.clip(hi - jnp.left_shift(jnp.int32(1), k) + 1, 0, n_leaf - 1)
    base = k * n_leaf
    ga = jnp.take(tab, base + lo, axis=0)
    gb = jnp.take(tab, base + b, axis=0)
    node_min = jnp.minimum(ga[:, :3], gb[:, :3])
    node_max = jnp.maximum(ga[:, 3:], gb[:, 3:])
    return node_min, node_max


def refit_binary(left: Array, right: Array, leaf_min: Array, leaf_max: Array):
    """Bottom-up AABB refit of the binary tree (fixpoint form; kept for
    trees without stored leaf ranges).

    A fixpoint sweep: each pass finalises every node whose children are both
    final, so the pass count equals the tree height (expected O(log L) for
    Morton-sorted leaves).  This replaces rtk's recursive per-node bounds
    accumulation (rtk.c:988-1009) and also serves per-frame refit.
    """
    n_int = left.shape[0]
    n_leaf = leaf_min.shape[0]

    def fetch(child, node_min, node_max, valid):
        leaf = is_leaf_code(child)
        li = jnp.clip(leaf_id_of(child), 0, n_leaf - 1)
        ni = jnp.clip(child, 0, n_int - 1)
        cmin = jnp.where(leaf[:, None], jnp.take(leaf_min, li, axis=0),
                         jnp.take(node_min, ni, axis=0))
        cmax = jnp.where(leaf[:, None], jnp.take(leaf_max, li, axis=0),
                         jnp.take(node_max, ni, axis=0))
        cval = jnp.where(leaf, True, jnp.take(valid, ni))
        return cmin, cmax, cval

    def body(state):
        node_min, node_max, valid = state
        lmin, lmax_, lval = fetch(left, node_min, node_max, valid)
        rmin, rmax_, rval = fetch(right, node_min, node_max, valid)
        ok = lval & rval
        node_min = jnp.where(ok[:, None], jnp.minimum(lmin, rmin), node_min)
        node_max = jnp.where(ok[:, None], jnp.maximum(lmax_, rmax_), node_max)
        return node_min, node_max, valid | ok

    def cond(state):
        return ~state[2][0]  # root valid <=> whole tree valid

    init = (
        jnp.full((n_int, 3), jnp.inf, jnp.float32),
        jnp.full((n_int, 3), -jnp.inf, jnp.float32),
        jnp.zeros((n_int,), bool),
    )
    node_min, node_max, _ = jax.lax.while_loop(cond, body, init)
    return node_min, node_max
