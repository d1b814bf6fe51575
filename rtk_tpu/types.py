"""Core batched types: rays and hit records (SoA pytrees).

Parity notes (reference rtk.h):
  * rtk_ray (rtk.h:29-34): origin, direction, min_t, max_t — here batched
    into arrays of shape (N, 3) / (N,).
  * rtk_hit (rtk.h:36-43): t, u, v, three full vertex records (position +
    original vertex index), mesh_index, triangle_index.  Hits carries all of
    those, plus an explicit `hit` mask (rtk returns it as the bool result of
    rtk_trace_ray, rtk.c:571-576).
  * Barycentric convention matches rtk.c:363-375: u weights vertex[0],
    v weights vertex[1], w = 1-u-v weights vertex[2].
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from rtk_tpu.pytree import pytree_dataclass, static_field

Array = jax.Array

# Host-side scalar (a module-level jnp constant would live on the default
# device and force a device sync whenever a traced function captures it).
RTK_INF = np.float32(3.402823e38)  # rtk.h:11


@pytree_dataclass
class Rays:
    """A batch of rays, SoA."""

    origin: Array  # (N, 3) f32
    direction: Array  # (N, 3) f32
    min_t: Array  # (N,) f32
    max_t: Array  # (N,) f32

    @staticmethod
    def make(origin, direction, min_t=None, max_t=None) -> "Rays":
        origin = jnp.asarray(origin, jnp.float32)
        direction = jnp.asarray(direction, jnp.float32)
        if origin.ndim == 1:
            origin = origin[None]
        if direction.ndim == 1:
            direction = direction[None]
        n = max(origin.shape[0], direction.shape[0])
        origin = jnp.broadcast_to(origin, (n, 3))
        direction = jnp.broadcast_to(direction, (n, 3))
        if min_t is None:
            min_t = jnp.zeros((n,), jnp.float32)
        else:
            min_t = jnp.broadcast_to(jnp.asarray(min_t, jnp.float32), (n,))
        if max_t is None:
            max_t = jnp.full((n,), RTK_INF, jnp.float32)
        else:
            max_t = jnp.broadcast_to(jnp.asarray(max_t, jnp.float32), (n,))
        return Rays(origin=origin, direction=direction, min_t=min_t, max_t=max_t)

    @property
    def count(self) -> int:
        return self.origin.shape[0]

    def __getitem__(self, idx) -> "Rays":
        return jax.tree.map(lambda a: a[idx], self)


@pytree_dataclass
class Hits:
    """Hit records for a batch of rays, SoA.

    Misses have hit=False, t == ray.max_t, indices == -1 (rtk leaves the hit
    struct untouched on a miss; we define miss fields explicitly).
    """

    hit: Array  # (N,) bool
    t: Array  # (N,) f32
    u: Array  # (N,) f32 — barycentric weight of vertex[0]
    v: Array  # (N,) f32 — barycentric weight of vertex[1]
    mesh_index: Array  # (N,) i32
    triangle_index: Array  # (N,) i32 — triangle index within its mesh
    vertex_position: Array  # (N, 3, 3) f32 — the 3 vertices of the hit triangle
    vertex_index: Array  # (N, 3) i32 — original vertex indices (rtk_vertex.index)

    @property
    def count(self) -> int:
        return self.t.shape[0]

    @property
    def w(self) -> Array:
        """Barycentric weight of vertex[2]."""
        return 1.0 - self.u - self.v

    def position(self) -> Array:
        """Interpolated hit position: u*v0 + v*v1 + w*v2. (N, 3)."""
        w = (1.0 - self.u - self.v)[:, None]
        return (
            self.u[:, None] * self.vertex_position[:, 0]
            + self.v[:, None] * self.vertex_position[:, 1]
            + w * self.vertex_position[:, 2]
        )

    def __getitem__(self, idx) -> "Hits":
        return jax.tree.map(lambda a: a[idx], self)


@pytree_dataclass
class PacketHits:
    """Lazily-assembled hit records from the packet kernel.

    The kernel returns (t, u, v, slot) per ray; materialising the rest of
    the rtk_hit record (mesh/triangle indices, the three full vertex
    records — rtk.h:36-43) costs large device gathers that most consumers
    never need (shading wants position+normal; occlusion wants `hit`).
    PacketHits defers those gathers to property access — inside a jitted
    consumer they fuse into that program; a consumer that never touches
    them never pays.  `.full()` materialises a plain Hits.

    Field-compatible with Hits via properties; `slot` indexes the packed
    triangle tables carried alongside (same device buffers as the scene —
    no copies).
    """

    hit: Array  # (N,) bool
    t: Array  # (N,) f32
    u_k: Array  # (N,) f32 kernel u (zeros when uv_deferred — see .u)
    v_k: Array  # (N,) f32
    slot: Array  # (N,) i32 packed triangle slot, -1 = miss
    origin: Array  # (N, 3) f32 — the traced rays (for position())
    direction: Array  # (N, 3) f32
    tri_v: Array  # (Tp, 3, 3) f32 packed tables
    tri_vidx: Array  # (Tp, 3) i32
    tri_mesh: Array  # (Tp,) i32
    tri_prim: Array  # (Tp,) i32
    # (N,) bool: the ray's traversal stack overflowed and its record may
    # be incomplete (None for records not produced by the kernel).
    overflow: Array | None = None
    # defer_uv traces don't carry u/v through the kernel (two fewer hit
    # carries + per-triangle normalises); .u/.v re-run the same
    # watertight shear test against the ONE winning triangle on access —
    # the lazy-assembly pattern the rest of this class already uses.
    uv_deferred: bool = static_field(default=False)

    @property
    def count(self) -> int:
        return self.t.shape[0]

    @property
    def u(self) -> Array:
        return self.u_k if not self.uv_deferred else self._uv()[0]

    @property
    def v(self) -> Array:
        return self.v_k if not self.uv_deferred else self._uv()[1]

    def _uv(self) -> tuple[Array, Array]:
        """Recompute (u, v) for the accepted hits (rtk.c:181-388 math —
        identical shear-space edge functions as the kernel's leaf phase,
        so values match the carried ones up to fma contraction)."""
        from rtk_tpu.ops.intersect import intersect_triangles, ray_shear

        tri = jnp.take(self.tri_v, self._safe_slot, axis=0)  # (N, 3, 3)
        shear = ray_shear(self.direction)
        n = self.t.shape[0]
        _, u, v, _ = intersect_triangles(
            self.origin, shear, tri[:, None],
            jnp.full((n,), -jnp.inf, jnp.float32),
            jnp.full((n,), jnp.inf, jnp.float32))
        return (jnp.where(self.hit, u[:, 0], 0.0),
                jnp.where(self.hit, v[:, 0], 0.0))

    @property
    def w(self) -> Array:
        return 1.0 - self.u - self.v

    @property
    def _safe_slot(self) -> Array:
        return jnp.clip(self.slot, 0, self.tri_mesh.shape[0] - 1)

    @property
    def mesh_index(self) -> Array:
        return jnp.where(self.hit, jnp.take(self.tri_mesh, self._safe_slot),
                         -1)

    @property
    def triangle_index(self) -> Array:
        return jnp.where(self.hit, jnp.take(self.tri_prim, self._safe_slot),
                         -1)

    @property
    def vertex_position(self) -> Array:
        return jnp.where(self.hit[:, None, None],
                         jnp.take(self.tri_v, self._safe_slot, axis=0), 0.0)

    @property
    def vertex_index(self) -> Array:
        return jnp.where(self.hit[:, None],
                         jnp.take(self.tri_vidx, self._safe_slot, axis=0),
                         -1)

    def position(self) -> Array:
        """Hit position o + t*d (cheaper than barycentric interpolation and
        identical up to rounding: the kernel's t comes from the same
        watertight test). (N, 3)."""
        return jnp.where(self.hit[:, None],
                         self.origin + self.t[:, None] * self.direction, 0.0)

    def full(self) -> Hits:
        """Materialise a plain Hits record (pays the assembly gathers)."""
        return Hits(hit=self.hit, t=self.t, u=self.u, v=self.v,
                    mesh_index=self.mesh_index,
                    triangle_index=self.triangle_index,
                    vertex_position=self.vertex_position,
                    vertex_index=self.vertex_index)

    def __getitem__(self, idx) -> "PacketHits":
        per_ray = ("hit", "t", "u_k", "v_k", "slot", "origin", "direction")
        if self.overflow is not None:
            per_ray += ("overflow",)
        return dataclasses.replace(
            self, **{f: getattr(self, f)[idx] for f in per_ray})


def miss_hits(n: int) -> Hits:
    """An all-miss Hits batch (t initialised to +inf sentinel by caller)."""
    return Hits(
        hit=jnp.zeros((n,), bool),
        t=jnp.full((n,), RTK_INF, jnp.float32),
        u=jnp.zeros((n,), jnp.float32),
        v=jnp.zeros((n,), jnp.float32),
        mesh_index=jnp.full((n,), -1, jnp.int32),
        triangle_index=jnp.full((n,), -1, jnp.int32),
        vertex_position=jnp.zeros((n, 3, 3), jnp.float32),
        vertex_index=jnp.full((n, 3), -1, jnp.int32),
    )
