"""rtk_tpu: a batched ray-query engine for the GPU (JAX/XLA/Pallas).

Capabilities of bqqbarbhg/rtk — BVH build over flexible triangle meshes,
watertight closest-hit / any-hit ray queries, serializable scenes —
re-designed for an accelerator: batched SoA APIs, on-device LBVH
construction, and a thread-per-ray wide-BVH traversal kernel. See
SURVEY.md for the blueprint.
"""

from rtk_tpu.api import (
    BuildConfig,
    Hits,
    PacketHits,
    MeshDesc,
    Rays,
    Scene,
    TraceConfig,
    Tracer,
    jit_filter,
    TriangleSoup,
    build_from_soup,
    build_sah_packed,
    build_scene,
    load_scene,
    refit,
    save_scene,
    trace_any,
    trace_closest,
)

__version__ = "0.1.0"
