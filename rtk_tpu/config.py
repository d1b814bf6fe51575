"""Build/trace configuration.

The reference (rtk.c:3-7, 586-592) exposes these as compile-time #defines:
RTK_BVH_MAX_DEPTH=64, leaf min/max items 4/64, RTK_BUILD_SPLITS=32,
RTK_MAX_CONCURRENT_TASKS=128.  Here they are dataclasses whose fields are
static under jit (they select program structure, not data).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class BuildConfig:
    """Static configuration for BVH construction.

    Attributes:
      leaf_size: triangles per leaf (rtk: RTK_BVH_LEAF_MIN_ITEMS=4).
      branching: wide-node arity W; 2, 4 or 8 (rtk builds BVH4, rtk.c:1576;
        the traversal kernel's packed tables are 8-wide).
      morton_bits: bits per axis of the Morton code (<=10 for uint32 keys).
      snap_node_counts: round dynamic node counts up to the next power of two
        bucket so repeated builds of similarly-sized scenes reuse compiles.
      wide_nodes: also build the wide (branching-ary) SoA node arrays.
        The packet-kernel product path derives its own tables from the
        binary topology (trace/packed.py), so a kernel-only user can skip
        the collapse, the costliest build stage at scale.  The XLA
        stack/stackless engines and wide-array refit need True.
    """

    leaf_size: int = 4
    branching: int = 8
    morton_bits: int = 10
    wide_nodes: bool = True

    def __post_init__(self):
        if self.branching not in (2, 4, 8):
            raise ValueError("branching must be 2, 4, or 8")
        if not (1 <= self.leaf_size <= 64):
            # rtk bounds leaf items to 64 (rtk.c:588 RTK_BVH_LEAF_MAX_ITEMS)
            raise ValueError("leaf_size must be in [1, 64]")
        if not (1 <= self.morton_bits <= 10):
            raise ValueError("morton_bits must be in [1, 10]")

    @property
    def log2_branching(self) -> int:
        return {2: 1, 4: 2, 8: 3}[self.branching]


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Static configuration for traversal.

    Attributes:
      max_stack: per-ray traversal stack bound (rtk: RTK_BVH_MAX_DEPTH=64,
        rtk.c:5; wide nodes divide the needed depth by log2(W)).
      watertight: resolve exact-zero shear-space edge functions with
        double-word (two-float) products, mirroring rtk's f64 fallback
        (rtk.c:294-336) without needing f64.
      max_steps: hard bound on traversal loop iterations (safety net; the
        loop normally exits when every ray's stack is empty).
      defer_uv: kernel engine only — drop the u/v hit carries from the
        kernel; PacketHits recomputes u/v lazily on access (hit/t/slot
        bit-equal, u/v equal up to rounding).  Off by default.
    """

    max_stack: int = 48
    watertight: bool = True
    max_steps: int = 0  # 0 = unbounded (loop until all rays finish)
    defer_uv: bool = False
