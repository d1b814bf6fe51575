"""Quickest proof that the system runs on the GPU.

Drives the main path through the entry points a user calls (build_scene,
Tracer, refit, instancing) at full scene size, runs the traversal kernel
compiled for the card, and checks every result against the XLA stack
engine and the float64 brute-force oracle:

  1. platform: the first JAX device must be a GPU;
  2. build the bunny-class scene, scenes.blob(6): 81,920 triangles;
  3. trace 1920x1080 primaries (closest) and shadow rays (any);
  4. parity with Tracer(engine="stack") on the whole batch and with
     oracle.trace_brute on a 16,384-ray subsample;
  5. atrium (~410k triangles): 1M diffuse-bounce rays, checked the same;
  6. refit a deforming grid and trace a clip through
     trace_packets_refit_frames;
  7. an instanced scene through the kernel's candidate rounds, checked
     against brute force over the world-space geometry;
  8. compiled memory analysis and peak device memory.

    python chip_smoke.py            # one GPU
    python chip_smoke.py --multi    # ray and scene sharding on 4 GPUs

The last line of standard output is one JSON object; any failure exits
non-zero before it.  Tolerances: the kernel is FP32 scalar arithmetic with
no matrix product, so TF32 never enters.  Against the stack engine, over
the whole batch, hit masks are identical and t agrees to rtol 1e-5: the
two share every rounding, division included (ops/intersect.py).  Against
the float64 oracle at most 0.01% of the subsample may disagree in its
record (silhouette grazes, where float32 rounding decides hit or miss),
and t agrees to rtol 1e-5 on the rest.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
RTOL = 1e-5  # t, kernel vs XLA and vs the f64 oracle (FP32 throughout)
# Rays whose record may disagree between the kernel and the float64
# oracle: rays that graze a silhouette edge, where float32 rounding
# decides hit or miss (and, with a surface behind, which t).  At most this
# fraction of the oracle's subsample.
GRAZE_FRAC = 1e-4
ORACLE_RAYS = 16384


def log(msg):
    print(msg, flush=True)


FAILURES = []


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    """Record a failed check; `end_phase` exits once the phase has
    printed all its numbers."""
    if not cond:
        print(f"FAIL: {msg}", file=sys.stderr, flush=True)
        FAILURES.append(msg)


def end_phase():
    if FAILURES:
        sys.exit(1)


def _oracle(tris, rays):
    import jax
    import numpy as np

    from rtk_tpu.oracle import trace_brute

    with jax.enable_x64(True):
        ref = trace_brute(tris, rays)
        return np.asarray(ref.hit), np.asarray(ref.t)


def _rel(a, b):
    import numpy as np

    return np.abs(a - b) / np.maximum(np.abs(b), 1e-30)


def _disagree(gh, gt, rh, rt):
    """Per-ray record disagreement: hit masks differ, or both hit and t
    differs by more than RTOL (relative)."""
    import numpy as np

    both = gh & rh
    bad = gh != rh
    bad[both] = _rel(gt[both], rt[both]) > RTOL
    return bad


def parity(name, got, ref, t_check=True, tris=None, rays=None):
    """Kernel vs the XLA stack engine on the whole batch: identical hit
    masks, and t within RTOL wherever both hit.  On a failure the log names
    the first disagreeing ray beside the f64 oracle's record for it."""
    import numpy as np

    gh, rh = np.asarray(got.hit), np.asarray(ref.hit)
    gt, rt = np.asarray(got.t), np.asarray(ref.t)
    if not t_check:
        gt = rt = np.zeros_like(gt)
    bad = np.flatnonzero(_disagree(gh, gt, rh, rt))
    check(bad.size == 0,
          f"{name}: {bad.size} records differ from the stack engine")
    both = gh & rh
    err = float(_rel(gt[both], rt[both]).max()) if both.any() else 0.0
    note = ""
    if bad.size and tris is not None:
        w = bad[0]
        oh, ot = _oracle(tris, rays[bad[:1]])
        note = (f"; first: ray {w}: kernel hit {bool(gh[w])} t "
                f"{float(gt[w])!r}, stack hit {bool(rh[w])} t "
                f"{float(rt[w])!r}, oracle hit {bool(oh[0])} t "
                f"{float(ot[0])!r}")
    log(f"  {name}: {gh.size} rays, {int(gh.sum())} hits, {bad.size} "
        f"records differ, max t rel err where both hit {err:.3g}{note}")


def oracle_parity(name, tris, rays, got, seed=0):
    """Kernel vs the float64 brute-force oracle on a ray subsample: records
    agree on all but GRAZE_FRAC of it (at most one ray in 16,384)."""
    import numpy as np

    n = rays.count
    idx = np.sort(np.random.default_rng(seed).choice(
        n, min(ORACLE_RAYS, n), replace=False))
    rh, rt = _oracle(tris, rays[idx])
    gh, gt = np.asarray(got.hit)[idx], np.asarray(got.t)[idx]
    bad = int(_disagree(gh, gt, rh, rt).sum())
    check(bad <= max(1, int(GRAZE_FRAC * idx.size)),
          f"{name}: {bad}/{idx.size} records differ from the f64 oracle")
    both = gh & rh
    ok = both & ~_disagree(gh, gt, rh, rt)
    err = float(_rel(gt[ok], rt[ok]).max()) if ok.any() else 0.0
    log(f"  {name} vs f64 oracle: {idx.size} rays, {bad} records differ, "
        f"max t rel err on the rest {err:.3g}")


def timed(fn, *args):
    import jax

    t0 = time.perf_counter()
    out = fn(*args)
    jax.block_until_ready(out)
    return out, time.perf_counter() - t0


def soup_of(tris):
    import numpy as np

    return (tris.reshape(-1, 3), np.arange(tris.shape[0] * 3).reshape(-1, 3))


def no_overflow(name, hits):
    import numpy as np

    n = int(np.asarray(hits.overflow).sum())
    check(n == 0, f"{name}: {n} rays overflowed the kernel stack")


def phase_primary():
    import jax.numpy as jnp
    import numpy as np

    import rtk_tpu
    from rtk_tpu import Rays
    from rtk_tpu.testing import scenes

    log("phase 2: build blob(6)")
    tris = scenes.blob(subdivisions=6)[0]
    scene, dt = timed(rtk_tpu.build_scene, soup_of(tris))
    log(f"  {scene.num_tris} tris built in {dt:.2f} s (includes compile)")

    log("phase 3: 1920x1080 primaries (closest) + shadow rays (any)")
    kern = rtk_tpu.Tracer(scene, engine="packet")
    xla = rtk_tpu.Tracer(scene, engine="stack")
    cam = scenes.camera_rays((0, 0, 3.0), (0, 0, 0), (0, 1, 0), 45,
                             1920, 1080)
    prim, dt = timed(kern.closest, cam)
    no_overflow("primary", prim)
    log(f"  primary: {cam.count} rays, {int(np.asarray(prim.hit).sum())} "
        f"hits, first call {dt:.2f} s (includes compile)")
    light = jnp.asarray([2.0, 3.0, 2.5], jnp.float32)
    p = prim.position()
    shadow = Rays(origin=p, direction=light[None] - p,
                  min_t=jnp.full((cam.count,), 1e-4, jnp.float32),
                  max_t=jnp.where(prim.hit, 1.0, 0.0).astype(jnp.float32))
    occ, dt = timed(kern.any, shadow)
    no_overflow("shadow", occ)
    log(f"  shadow: {int(np.asarray(occ.hit).sum())} occluded, first call "
        f"{dt:.2f} s")

    log("phase 4: parity (stack engine, full batch; f64 oracle, subsample)")
    parity("primary", prim, xla.closest(cam), tris=tris, rays=cam)
    parity("shadow", occ, xla.any(shadow), t_check=False)
    oracle_parity("primary", tris, cam, prim)
    return kern, cam


def phase_atrium():
    import jax
    import jax.numpy as jnp
    import numpy as np

    import rtk_tpu
    from rtk_tpu import Rays
    from rtk_tpu.models.path import cosine_sample, geometric_normal
    from rtk_tpu.testing import scenes

    log("phase 5: atrium diffuse bounce")
    atr = scenes.atrium()
    scene, dt = timed(rtk_tpu.build_scene, soup_of(atr))
    log(f"  {scene.num_tris} tris built in {dt:.2f} s")
    kern = rtk_tpu.Tracer(scene, engine="packet")
    xla = rtk_tpu.Tracer(scene, engine="stack")
    cam = scenes.camera_rays((0, 6, 9), (0, 2, 0), (0, 1, 0), 60, 1024, 1024)
    prim = kern.closest(cam)
    no_overflow("atrium primary", prim)
    n = geometric_normal(prim, cam.direction)
    bounce = Rays(
        origin=prim.position() + 1e-3 * n,
        direction=cosine_sample(jax.random.PRNGKey(0), n),
        min_t=jnp.full((cam.count,), 1e-3, jnp.float32),
        max_t=jnp.where(prim.hit, np.float32(3.4e38), 0.0))
    hb, dt = timed(kern.closest, bounce)
    no_overflow("atrium bounce", hb)
    log(f"  bounce: {bounce.count} rays, {int(np.asarray(hb.hit).sum())} "
        f"hits, first call {dt:.2f} s")
    parity("atrium bounce", hb, xla.closest(bounce),
           tris=atr, rays=bounce)
    oracle_parity("atrium bounce", atr, bounce, hb, seed=1)


def phase_refit():
    import jax.numpy as jnp
    import numpy as np

    import rtk_tpu
    from rtk_tpu.ops.pallas_trace import trace_packets_refit_frames
    from rtk_tpu.testing import scenes
    from rtk_tpu.trace.packed import pack_scene

    log("phase 6: refit deforming_grid + trace_packets_refit_frames")
    g0 = scenes.deforming_grid(0.0)
    scene = rtk_tpu.build_scene(soup_of(g0))
    packed = pack_scene(scene)
    ts = (0.1, 0.4, 0.7, 1.0)
    frames = jnp.stack([jnp.asarray(scenes.deforming_grid(t)) for t in ts])
    cam = scenes.camera_rays((0, 3, 4), (0, 0, 0), (0, 1, 0), 50, 512, 512)
    got, dt = timed(trace_packets_refit_frames, packed, scene, frames, cam)
    log(f"  {len(ts)} frames x {cam.count} rays in {dt:.2f} s "
        f"(includes compile)")
    for f, t in enumerate(ts):
        no_overflow(f"refit frame {f}", got[f])
        ref = rtk_tpu.Tracer(rtk_tpu.refit(scene, frames[f]),
                             engine="stack").closest(cam)
        parity(f"refit frame {f}", got[f], ref,
               tris=np.asarray(frames[f]), rays=cam)


def phase_instanced():
    import numpy as np

    from rtk_tpu import BuildConfig, build_scene
    from rtk_tpu.instancing import (build_instanced, pack_instanced,
                                    trace_closest_instanced_packets)
    from rtk_tpu.testing import scenes

    log("phase 7: instanced scene through the kernel's candidate rounds")
    rng = np.random.default_rng(3)
    blob = scenes.blob(subdivisions=3)[0]
    box = scenes.box([-0.5, -0.5, -0.5], [0.5, 0.5, 0.5])
    cfg = BuildConfig(leaf_size=8)
    blas = [build_scene(soup_of(blob), cfg), build_scene(soup_of(box), cfg)]
    n_inst = 24
    inst_blas = rng.integers(0, 2, n_inst)
    tf = np.zeros((n_inst, 3, 4), np.float32)
    for i in range(n_inst):
        a = rng.random() * 6.28
        s = 0.4 + 0.4 * rng.random()
        c, si = np.cos(a), np.sin(a)
        tf[i, :, :3] = s * np.array([[c, 0, si], [0, 1, 0], [-si, 0, c]])
        tf[i, :, 3] = rng.uniform(-3, 3, 3)
    iscene = build_instanced(blas, inst_blas, tf)
    ps = pack_instanced(iscene)
    cam = scenes.camera_rays((0, 1, 9), (0, 0, 0), (0, 1, 0), 50, 256, 256)
    (hits, inst), dt = timed(trace_closest_instanced_packets, ps, cam)
    log(f"  {n_inst} instances, {cam.count} rays, "
        f"{int(np.asarray(hits.hit).sum())} hits in {dt:.2f} s")
    world = np.concatenate([
        (np.asarray(b) @ tf[i, :, :3].T) + tf[i, :, 3]
        for i, b in ((i, (blob, box)[inst_blas[i]]) for i in range(n_inst))])
    oracle_parity("instanced", world.astype(np.float32), cam, hits, seed=2)


def phase_memory(kern, cam):
    import jax

    from rtk_tpu.ops.pallas_trace import trace_packets

    log("phase 8: memory")
    compiled = jax.jit(lambda pk, r: trace_packets(pk, r).t).lower(
        kern.packed, cam).compile()
    log(f"  primary trace program: {compiled.memory_analysis()}")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"  peak_bytes_in_use: {stats.get('peak_bytes_in_use')}")


def run_multi():
    """Ray and scene sharding on a 4-GPU mesh against a 1-GPU mesh."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    import rtk_tpu
    from rtk_tpu.parallel.shard import (build_scene_sharded,
                                        trace_closest_scene_sharded,
                                        trace_closest_sharded,
                                        trace_packets_sharded)
    from rtk_tpu.testing import scenes
    from rtk_tpu.trace.packed import pack_scene

    devs = jax.devices()
    if len(devs) < 4:
        fail(f"--multi needs 4 GPUs, found {len(devs)}")
    mesh4 = Mesh(np.asarray(devs[:4]), ("rays",))
    mesh1 = Mesh(np.asarray(devs[:1]), ("rays",))
    tris = scenes.blob(subdivisions=6)[0]
    scene = rtk_tpu.build_scene(soup_of(tris))
    cam = scenes.camera_rays((0, 0, 3.0), (0, 0, 0), (0, 1, 0), 45,
                             1920, 1080)
    log("multi: ray sharding, stack engine")
    parity("trace_closest_sharded 4 vs 1",
           trace_closest_sharded(scene, cam, mesh4),
           trace_closest_sharded(scene, cam, mesh1))
    log("multi: ray sharding, kernel")
    packed = pack_scene(scene)
    h4, dt4 = timed(trace_packets_sharded, packed, cam, mesh4)
    h1, dt1 = timed(trace_packets_sharded, packed, cam, mesh1)
    no_overflow("trace_packets_sharded", h4)
    parity("trace_packets_sharded 4 vs 1", h4, h1)
    log("multi: scene sharding (pmin combine)")
    s4 = build_scene_sharded(soup_of(tris), mesh4)
    s1 = build_scene_sharded(soup_of(tris), mesh1)
    g4 = trace_closest_scene_sharded(s4, cam, mesh4)
    no_overflow("trace_closest_scene_sharded", g4)
    parity("trace_closest_scene_sharded 4 vs 1", g4,
           trace_closest_scene_sharded(s1, cam, mesh1))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the 4-GPU sharding phases")
    args = ap.parse_args()

    sys.path.insert(0, ROOT)
    try:
        import rtk_tpu  # noqa: F401
    except ImportError as e:
        fail(f"run chip_smoke.py from a checkout of the repo ({e})")
    from rtk_tpu.utils.cache import configure_compile_cache

    configure_compile_cache(ROOT)
    import jax

    log("phase 1: platform")
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        fail(f"no GPU: JAX's first device is {dev.platform!r}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"  {smi}")
    log(f"  jax {jax.__version__}: {len(jax.devices())} x {dev.device_kind}")

    if args.multi:
        run_multi()
        end_phase()
    else:
        kern, cam = phase_primary()
        end_phase()
        for phase in (phase_atrium, phase_refit, phase_instanced):
            phase()
            end_phase()
        phase_memory(kern, cam)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
