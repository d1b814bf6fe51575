"""Tracer: engine-selecting front-end over a built Scene.

Three interchangeable traversal engines implement the same hit-record
contract (rtk_trace_ray semantics, rtk.c:543-577):

  * "packet": the thread-per-ray Pallas kernel (ops/pallas_trace.py),
    compiled for the GPU through Triton; scene tables are packed once and
    cached on this object.  Supports filter_mask and jit_filter callables.
  * "stack": the plain-XLA lockstep traversal (trace/stack.py) — runs on
    any backend, any branching, and supports arbitrary filter callables.
  * "stackless": the XLA parent-link traversal (trace/stackless.py).

"auto" is resolved by `resolve_engine`, the one place that looks at the
backend: on "gpu" it picks the engine measured faster on the card
(PERF.md), on "cpu" the stack engine; any other platform is an error.
The kernel runs interpreted only when a caller asks for it.
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import jax

from rtk_tpu.config import TraceConfig
from rtk_tpu.scene import Scene
from rtk_tpu.types import Hits, PacketHits, Rays

# The packet engine returns a lazy PacketHits; the XLA engines return an
# eager Hits.  Both satisfy the same hit-record property surface, but the
# pytree structures differ (PacketHits carries ray + triangle-table
# leaves) — call .full() on a PacketHits if you need the stable Hits
# pytree for jax.tree.map.
AnyHits = Union[Hits, PacketHits]


def jit_filter(fn: Callable) -> Callable:
    """Mark a filter callable as jax-traceable so the Tracer keeps it on
    the kernel engine (rtk_filter_fn intent, rtk.h:117,130).

    The predicate receives a HitCandidate (trace/stack.py) of array tiles
    — t, u, v, mesh_index, triangle_index, ray_index — and must return a
    bool mask using only jax-traceable ops; it is inlined into the
    kernel's leaf phase (each distinct function compiles its own kernel).
    Unmarked callables keep routing to the XLA stack engine, which can
    trace arbitrary Python.
    """
    fn.jittable = True
    return fn


# Engine "auto" picks on a GPU: the faster of the two on the card at the
# bench's shapes (PERF.md, "Kernel against XLA").
GPU_ENGINE = "packet"


def resolve_engine(engine: str = "auto", platform: str | None = None) -> str:
    """The engine a Tracer runs: `engine` itself unless it is "auto"."""
    if engine not in ("auto", "packet", "stack", "stackless"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine != "auto":
        return engine
    platform = jax.default_backend() if platform is None else platform
    if platform == "gpu":
        return GPU_ENGINE
    if platform == "cpu":
        return "stack"
    raise ValueError(f"no traversal engine for platform {platform!r}")


class Tracer:
    def __init__(self, scene: Scene, engine: str = "auto",
                 config: TraceConfig = TraceConfig(), tri_mask=None,
                 interpret: bool = False):
        """tri_mask: optional (num_tris,) uint32 per-triangle filter bits
        (soup order, 24 bits).  Queries passing filter_mask=m then test
        only triangles with (tri_mask & m) != 0 on the kernel engine.
        interpret=True runs the kernel in Pallas' CPU interpreter (tests)."""
        self.scene = scene
        self.config = config
        self.tri_mask = tri_mask
        self.interpret = interpret
        self._packed = None
        self._stackless = None
        self.engine = resolve_engine(engine)
        if self.engine == "packet" and scene.branching != 8:
            raise ValueError("packet engine requires branching=8 scenes")

    @property
    def packed(self):
        if self._packed is None:
            from rtk_tpu.trace.packed import pack_scene

            self._packed = pack_scene(self.scene, tri_mask=self.tri_mask)
        return self._packed

    def refresh(self, scene: Scene) -> "Tracer":
        """Rebind to a refit Scene (same topology): repacks bounds only."""
        t = Tracer.__new__(Tracer)
        t.__dict__.update(self.__dict__)
        t.scene = scene
        t._packed = None
        t._stackless = None
        if self._packed is not None:
            from rtk_tpu.trace.packed import repack_bounds

            t._packed = repack_bounds(self._packed, scene)
        return t

    def _trace(self, rays: Rays, mode: str,
               filter_fn: Optional[Callable],
               filter_mask: Optional[int] = None) -> AnyHits:
        kernel_filter_ok = (filter_fn is None
                            or getattr(filter_fn, "jittable", False))
        if self.engine == "packet" and kernel_filter_ok:
            from rtk_tpu.ops.pallas_trace import trace_packets

            return trace_packets(self.packed, rays, mode=mode,
                                 watertight=self.config.watertight,
                                 filter_mask=filter_mask,
                                 filter_fn=filter_fn,
                                 defer_uv=self.config.defer_uv,
                                 interpret=self.interpret)
        if filter_mask is not None:
            raise ValueError(
                "filter_mask runs on the packet (kernel) engine only; use "
                "filter_fn on the stack engine")
        if self.engine == "stackless" and filter_fn is None:
            from rtk_tpu.trace.stackless import build_stackless, trace_stackless

            if self._stackless is None:
                self._stackless = build_stackless(self.scene)
            return trace_stackless(self._stackless, rays, mode=mode,
                                   watertight=self.config.watertight)
        from rtk_tpu.trace import stack as _stack

        fn = _stack.trace_closest if mode == "closest" else _stack.trace_any
        return fn(self.scene, rays, filter_fn=filter_fn, config=self.config)

    def closest(self, rays: Rays, filter_fn: Optional[Callable] = None,
                filter_mask: Optional[int] = None) -> AnyHits:
        """Nearest-hit query (rtk_trace_ray).  `filter_mask` runs the
        built-in mask filter on the kernel engine."""
        return self._trace(rays, "closest", filter_fn, filter_mask)

    def any(self, rays: Rays, filter_fn: Optional[Callable] = None,
            filter_mask: Optional[int] = None) -> AnyHits:
        """Any-hit query (the intended rtk_trace_ray_filter semantics)."""
        return self._trace(rays, "any", filter_fn, filter_mask)
