"""Collapse the binary LBVH into a wide (BVH4/BVH8) SoA node array.

The reference collapses its binary build tree into BVH4 by taking
grandchildren, two levels at a time (rtk.c:1570-1622); this generalises the
same idea to log2(W) levels, computed for every node in parallel:

  * a binary internal node becomes a wide node iff depth % log2(W) == 0;
  * its wide children are all binary descendants exactly log2(W) levels
    below (leaves encountered earlier become direct children);
  * empty slots get inverted bounds (+1/-1) so any slab test fails, exactly
    like rtk's empty BVH4 slots (rtk.c:1612-1620).

Layout note: slot bounds come from ONE row gather of a fused
(Li + L + 1, 6) bounds table — internal rows, leaf rows, then a single
sentinel row holding the inverted empty-slot bounds — instead of six
per-component element gathers.
"""
from __future__ import annotations

import jax.numpy as jnp

from rtk_tpu.builder.lbvh import is_leaf_code, leaf_id_of

EMPTY = -1  # python int: keep module constants off-device


def _fused_bounds(node_min, node_max, leaf_min, leaf_max):
    """(Li + L + 1, 6) rows: [min | max] per binary node, then per leaf,
    then the inverted sentinel row for empty slots."""
    nodes6 = jnp.concatenate([node_min, node_max], axis=1)
    leaves6 = jnp.concatenate([leaf_min, leaf_max], axis=1)
    sentinel = jnp.asarray([[1.0, 1.0, 1.0, -1.0, -1.0, -1.0]],
                           node_min.dtype)
    return jnp.concatenate([nodes6, leaves6, sentinel], axis=0)


def _slot_rows(src, n_int, n_leaf):
    """Map child encodings to fused-table row ids (empty -> sentinel)."""
    internal = src >= 0
    leaf = is_leaf_code(src)
    li = jnp.clip(leaf_id_of(src), 0, n_leaf - 1)
    return jnp.where(internal, src,
                     jnp.where(leaf, n_int + li, n_int + n_leaf))


def collapse_wide(left, right, node_min, node_max, leaf_min, leaf_max,
                  branching: int):
    """Build wide SoA nodes from the binary topology.

    Args:
      left/right: (Li,) binary child arrays (shared encoding).
      node_min/node_max: (Li, 3) refit binary bounds.
      leaf_min/leaf_max: (L, 3) leaf bounds.
      branching: W in {2, 4, 8}.

    Wide nodes are indexed by their *binary* node id: a binary node at
    depth % log2(W) == 0 owns the wide-node row of the same index (other
    rows are dead and never reachable from the root, row 0).  This keeps the
    child translation trivial; a later host-side compaction pass can densify
    the rows for very large scenes.

    Returns:
      wide_child: (Li, W) i32 — >=0 wide node index (== binary id), -1
        empty, <=-2 leaf.  Doubles as the refit source encoding.
      wide_min/wide_max: (Li, W, 3) f32 child bounds.
    """
    k = {2: 1, 4: 2, 8: 3}[branching]
    n_int = left.shape[0]

    def expand(slots):
        """Each internal slot -> its two binary children; leaves/empties
        keep their value in the left position and pad with EMPTY."""
        out = []
        for s in slots:
            internal = s >= 0
            si = jnp.clip(s, 0, n_int - 1)
            out.append(jnp.where(internal, jnp.take(left, si), s))
            out.append(jnp.where(internal, jnp.take(right, si), EMPTY))
        return out

    i = jnp.arange(n_int, dtype=jnp.int32)
    slots = [jnp.take(left, i), jnp.take(right, i)]
    for _ in range(k - 1):
        slots = expand(slots)
    src = jnp.stack(slots, axis=1)  # (Li, W) binary ids / leaf codes / EMPTY

    wide_min, wide_max = gather_slot_bounds(
        src, node_min, node_max, leaf_min, leaf_max
    )
    return src.astype(jnp.int32), wide_min, wide_max


def gather_slot_bounds(src, node_min, node_max, leaf_min, leaf_max):
    """Child-slot AABBs from binary-tree sources (also used by refit).

    Empty slots get inverted bounds (min=+1, max=-1) like rtk.c:1612-1620,
    via the fused table's sentinel row.
    """
    n_int = node_min.shape[0]
    n_leaf = leaf_min.shape[0]
    w = src.shape[1]
    table = _fused_bounds(node_min, node_max, leaf_min, leaf_max)
    rows = _slot_rows(src, n_int, n_leaf)
    g = jnp.take(table, rows.reshape(-1), axis=0).reshape(
        src.shape[0], w, 6)
    return g[..., :3], g[..., 3:]
