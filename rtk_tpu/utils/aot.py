"""AOT export of compiled trace programs (jax.export).

rtk's scene blob IS its runtime format — load it and trace, no build step
(rtk.h:78-89; rtk.c:1732-1774).  Here the analogue has two halves:
utils/serialize.py round-trips the DATA (scene/packed tables), and this
module round-trips the PROGRAM: the jitted kernel-trace computation,
exported to a serialized StableHLO artifact that reloads and runs with no
Python retracing and no fresh XLA compile of the trace logic.  Together
they give a serving path whose warmup is file reads, not compiles.

The artifact has a FLAT, stable signature (plain arrays in, plain arrays
out) rather than serialized pytree classes, for the same reason rtk's
blob stores offsets instead of pointers: the on-disk format must not
depend on in-memory layout details that can drift between versions.

Shapes are pinned at export time (ray count, table sizes) — the standard
serving shape discipline; export one artifact per batch size.

On the GPU the kernel is a Triton custom call, which jax.export does not
count among its stable targets: its Triton IR is compiled by the XLA that
loads it.  Export disables that one check, so an artifact holding the
compiled kernel is tied to the JAX version that exported it (interpreted
exports are plain StableHLO and carry no such tie).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp

from rtk_tpu.trace.packed import PackedScene
from rtk_tpu.types import PacketHits, Rays

# Artifact signature version: bump when the flat call signature changes.
AOT_VERSION = 2

_TRITON_CALL = "__gpu$xla.gpu.triton"


def _export(fn, args, platforms, sm_count):
    """jax.export with the Triton custom call allowed (see module doc).
    sm_count sizes the kernel's persistent grid for the card that will run
    the artifact (default: the exporting host's GPU)."""
    from jax import export as jexport

    from rtk_tpu.ops.pallas_trace import target_sm_count

    kw = {"disabled_checks": [
        jexport.DisabledSafetyCheck.custom_call(_TRITON_CALL)]}
    if platforms is not None:
        kw["platforms"] = list(platforms)
    # The kernel is strictly f32/i32; ambient x64 (e.g. the test suite's
    # f64 oracle config) would leak float64 literals into the lowering.
    # Pin it off so the artifact is independent of host configuration.
    grid = (contextlib.nullcontext() if sm_count is None
            else target_sm_count(sm_count))
    with jax.enable_x64(False), grid:
        return jexport.export(jax.jit(fn), **kw)(*args).serialize()


def export_packet_trace(packed: PackedScene, n_rays: int,
                        mode: str = "closest",
                        platforms: Sequence[str] | None = None,
                        sm_count: int | None = None,
                        **trace_kw) -> bytes:
    """Serialize the compiled kernel-trace program for `packed`'s shapes.

    The flat signature is
    ``(nodes, tris, origin, direction, min_t, max_t) -> (hit, t, u, v,
    slot, overflow)`` — the node/triangle tables ride as ARGUMENTS so one
    artifact
    serves any scene with the same table shapes (same pack_scene config
    and padded sizes), e.g. every frame of a refit sequence.

    platforms: lowering targets (default: the current backend).  An
    artifact lowered for "cuda" can be exported from a CPU host and called
    later on a GPU host running the same JAX version; the kernel's grid is
    then sized for `sm_count` SMs, the target card's (132 on an H100 SXM),
    which such an export must give.
    """
    from rtk_tpu.ops.pallas_trace import trace_packets

    def flat(nodes, tris, origin, direction, min_t, max_t):
        pk = dataclasses.replace(packed, nodes=nodes, tris=tris)
        h = trace_packets(
            pk, Rays(origin=origin, direction=direction,
                     min_t=min_t, max_t=max_t), mode=mode, **trace_kw)
        # Only the kernel outputs: the lazy hit-assembly tables stay with
        # the scene data (serialize.py), out of the program artifact.
        return h.hit, h.t, h.u, h.v, h.slot, h.overflow

    args = (
        jax.ShapeDtypeStruct(packed.nodes.shape, packed.nodes.dtype),
        jax.ShapeDtypeStruct(packed.tris.shape, packed.tris.dtype),
        jax.ShapeDtypeStruct((n_rays, 3), jnp.float32),
        jax.ShapeDtypeStruct((n_rays, 3), jnp.float32),
        jax.ShapeDtypeStruct((n_rays,), jnp.float32),
        jax.ShapeDtypeStruct((n_rays,), jnp.float32),
    )
    return _export(flat, args, platforms, sm_count)


class LoadedTrace:
    """A deserialized kernel-trace program; call with (packed, rays).

    The packed scene supplies both the kernel tables (checked against the
    artifact's pinned shapes by jax.export) and the lazy hit-assembly
    tables for the returned PacketHits.
    """

    def __init__(self, exported):
        self._exported = exported
        self.in_shapes = tuple(a.shape for a in exported.in_avals)

    @property
    def n_rays(self) -> int:
        return self.in_shapes[2][0]

    def __call__(self, packed: PackedScene, rays: Rays) -> PacketHits:
        hit, t, u, v, slot, ovf = self._exported.call(
            packed.nodes, packed.tris, rays.origin, rays.direction,
            rays.min_t, rays.max_t)
        return PacketHits(
            hit=hit, t=t, u_k=u, v_k=v, slot=slot,
            origin=rays.origin, direction=rays.direction,
            tri_v=packed.tri_v, tri_vidx=packed.tri_vidx,
            tri_mesh=packed.tri_mesh, tri_prim=packed.tri_prim,
            overflow=ovf)


def load_packet_trace(blob: bytes) -> LoadedTrace:
    """Deserialize an export_packet_trace artifact (no retracing: the
    StableHLO module recompiles directly, skipping Python/JAX tracing)."""
    from jax import export as jexport

    return LoadedTrace(jexport.deserialize(blob))


def export_refit_trace(packed: PackedScene, scene, n_rays: int,
                       mode: str = "closest",
                       platforms: Sequence[str] | None = None,
                       sm_count: int | None = None,
                       **trace_kw) -> bytes:
    """Serialize the fused refit+repack+trace program for deforming scenes.

    Flat signature: ``(tri_pos, origin, direction, min_t, max_t) ->
    (hit, t, u, v, slot, overflow, tri_v)`` where tri_pos is the frame's deformed
    (T, 3, 3) vertex positions (same topology as `scene`).  Unlike
    export_packet_trace, the scene TOPOLOGY is baked into the artifact
    (refit walks the tree structure); the returned tri_v is the frame's
    repacked vertex table so hit records interpolate deformed geometry.

    The serving analogue of trace_packets_refit: one artifact animates a
    character/cloth rig forever — per frame, one call, no retracing.
    platforms and sm_count as for export_packet_trace.
    """
    from rtk_tpu.ops.pallas_trace import trace_packets_refit

    T = scene.num_tris  # tri_pos is in *original soup order* (scene.refit)

    def flat(tri_pos, origin, direction, min_t, max_t):
        h, _, packed2 = trace_packets_refit(
            packed, scene, tri_pos,
            Rays(origin=origin, direction=direction,
                 min_t=min_t, max_t=max_t), mode=mode, **trace_kw)
        return h.hit, h.t, h.u, h.v, h.slot, h.overflow, packed2.tri_v

    args = (
        jax.ShapeDtypeStruct((T, 3, 3), jnp.float32),
        jax.ShapeDtypeStruct((n_rays, 3), jnp.float32),
        jax.ShapeDtypeStruct((n_rays, 3), jnp.float32),
        jax.ShapeDtypeStruct((n_rays,), jnp.float32),
        jax.ShapeDtypeStruct((n_rays,), jnp.float32),
    )
    return _export(flat, args, platforms, sm_count)


class LoadedRefitTrace:
    """A deserialized refit+trace program; call with (packed, tri_pos,
    rays).  `packed` supplies only the static hit-assembly tables
    (tri_vidx/tri_mesh/tri_prim — the slot mapping is repack-invariant);
    the frame's vertex table comes back from the artifact."""

    def __init__(self, exported):
        self._exported = exported

    def __call__(self, packed: PackedScene, tri_pos, rays: Rays
                 ) -> PacketHits:
        hit, t, u, v, slot, ovf, tri_v = self._exported.call(
            tri_pos, rays.origin, rays.direction, rays.min_t, rays.max_t)
        return PacketHits(
            hit=hit, t=t, u_k=u, v_k=v, slot=slot,
            origin=rays.origin, direction=rays.direction,
            tri_v=tri_v, tri_vidx=packed.tri_vidx,
            tri_mesh=packed.tri_mesh, tri_prim=packed.tri_prim,
            overflow=ovf)


def load_refit_trace(blob: bytes) -> LoadedRefitTrace:
    from jax import export as jexport

    return LoadedRefitTrace(jexport.deserialize(blob))
