"""Benchmark suite over the BASELINE.json acceptance configs (one GPU).

Prints the headline JSON line {"metric", "value", "unit", ...} right after
the headline measurement, then runs the remaining configs, each in its own
bounded child process, and prints the headline record once more at the end
so the final stdout line is always the headline.

The parent process never imports JAX: one child at a time holds the card
(a JAX process reserves most of the card's memory when it starts).  A
child fails unless JAX's first device is a GPU; every JSON record names
the platform, device kind and count, and the card's name and power limit.

Headline = primary-ray closest-hit throughput on the bunny-class scene
(config 2, 8192^2 = 67M rays) through Tracer(engine="auto").  Per-config
numbers go to stderr.  Procedural stand-ins replace the named assets (no
network here): blob(6)=81,920 tris for the 69k bunny; atrium~=410k tris
for 262k Sponza.

Usage:
  python bench.py                      # full suite
  python bench.py --config <name>      # one config, one JSON line out
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SUITE_BUDGET_S = 1620.0
_T0 = time.perf_counter()


def _remaining():
    return SUITE_BUDGET_S - (time.perf_counter() - _T0)


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def gpu_info() -> dict:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name, limit = (x.strip() for x in out.split(","))
    return {"gpu_name": name, "power_limit": limit}


def _child_setup() -> dict:
    """Compile cache + the device record; exits unless on a GPU."""
    sys.path.insert(0, ROOT)
    from rtk_tpu.utils.cache import configure_compile_cache

    configure_compile_cache(ROOT)
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        log(f"bench: no GPU (JAX's first device is {dev.platform!r})")
        sys.exit(2)
    return {"platform": dev.platform, "device_kind": dev.device_kind,
            "device_count": len(jax.devices()), **gpu_info()}


def timeit(fn, iters=5, batches=3, warm=False):
    """Best-of-batches mean seconds per call of fn(), host clock around
    work that ends in block_until_ready.  warm=True skips the warm-up."""
    import jax

    if not warm:
        jax.block_until_ready(fn())
    best = float("inf")
    for _ in range(batches):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn()
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def timeit_frames(packed, rays, frames=8, iters=3, **kw):
    """Amortised per-dispatch trace timing: one program lax.scans the
    kernel over `frames` ray variants, so the fixed per-dispatch cost
    divides by `frames`.  Returns per-frame seconds.  Reported beside the
    single-dispatch number, never instead of it."""
    import jax
    import jax.numpy as jnp

    from rtk_tpu.ops.pallas_trace import trace_packets
    from rtk_tpu.types import Rays

    base = jnp.asarray(rays.min_t)
    eps = (jnp.arange(frames, dtype=jnp.float32) + 1.0)[:, None] * 1e-7

    def run_fn(min_t_f, bump):
        def body(c, mt):
            h = trace_packets(
                packed, Rays(origin=rays.origin, direction=rays.direction,
                             min_t=mt + bump, max_t=rays.max_t), **kw)
            return c, (h.t, h.slot)
        _, outs = jax.lax.scan(body, 0, min_t_f)
        return outs

    run = jax.jit(run_fn)

    min_t_f = base[None, :] + eps
    import itertools
    ctr = itertools.count()
    nxt = lambda: run(min_t_f, jnp.float32(1e-9) * (next(ctr) + 1))
    dt = timeit(nxt, iters=iters, batches=2)
    return dt / frames


def emit_headline(mrays, rec):
    """Print the headline record NOW (never defer this)."""
    out = {
        "metric": "primary_ray_closest_hit_throughput",
        "value": round(mrays, 3),
        "unit": "Mrays/s",
        "scale": "8192x8192",
        **{k: rec[k] for k in ("engine", "platform", "device_kind",
                               "device_count", "gpu_name", "power_limit")},
    }
    print(json.dumps(out), flush=True)


def config_headline():
    """Bunny blob(6), 8192^2 morton-ordered primaries, Tracer(auto)."""
    from rtk_tpu import Tracer, build_scene
    from rtk_tpu.testing import scenes

    btris = scenes.blob(subdivisions=6)[0]
    scene = build_scene((btris.reshape(-1, 3),
                         np.arange(btris.shape[0] * 3).reshape(-1, 3)))
    tracer = Tracer(scene)
    rays = scenes.camera_rays((0, 0, 3.0), (0, 0, 0), (0, 1, 0), 45,
                              8192, 8192, order="morton", device=True)
    out = tracer.closest(rays)
    n_hit = int(np.asarray(out.hit).sum())
    del out
    dt = timeit(lambda: tracer.closest(rays).t, iters=3, batches=2,
                warm=True)
    mrays = rays.count / dt / 1e6
    log(f"bunny 8192x8192 primary [{tracer.engine}]: {mrays:.2f} Mrays/s "
        f"({n_hit} hits)")
    return {"headline_mrays": round(mrays, 3), "engine": tracer.engine,
            "headline_hits": n_hit}


def _run_config(name, timeout):
    """Run one bench config in a bounded subprocess; parsed JSON or None.

    The child's stderr (per-metric lines) is forwarded to ours so the log
    shows every number as soon as the config finishes."""
    t0 = time.perf_counter()
    try:
        out = subprocess.run(
            [sys.executable, __file__, "--config", name],
            timeout=timeout, capture_output=True, text=True)
    except subprocess.TimeoutExpired as e:
        txt = e.stderr or b""
        sys.stderr.write(txt.decode() if isinstance(txt, bytes) else txt)
        log(f"config [{name}] TIMED OUT after {timeout}s")
        return None
    if out.stderr:
        sys.stderr.write(out.stderr)
        sys.stderr.flush()
    dt = time.perf_counter() - t0
    try:
        line = [l for l in out.stdout.splitlines() if l.startswith("{")][-1]
        rec = json.loads(line)
        log(f"config [{name}] done in {dt:.0f}s")
        return rec
    except Exception as e:
        log(f"config [{name}] FAILED rc={out.returncode} in {dt:.0f}s "
            f"({type(e).__name__}: {e}); stdout tail: {out.stdout[-300:]!r}")
        return None


# ---------------------------------------------------------------------------
# Individual configs — each runs in its own process and prints ONE JSON line.
# ---------------------------------------------------------------------------

def _soup(tris):
    return (tris.reshape(-1, 3), np.arange(tris.shape[0] * 3).reshape(-1, 3))


def config_build():
    """LBVH build throughput at 82k tris (the bunny-class scene) and at
    5.24M tris, both as the full Scene (wide arrays for the XLA engines)
    and as the kernel-only build (wide_nodes=False)."""
    import jax
    import jax.numpy as jnp

    from rtk_tpu import BuildConfig
    from rtk_tpu.scene import build_from_soup
    from rtk_tpu.testing import scenes

    cfg = BuildConfig(branching=8, leaf_size=8)
    cfg_kernel = BuildConfig(branching=8, leaf_size=8, wide_nodes=False)
    rec = {}
    for sub, iters, key, bc in ((6, 10, "build_mtris_82k", cfg),
                                (9, 3, "build_mtris", cfg),
                                (9, 3, "build_kernel_mtris", cfg_kernel)):
        btris = jax.block_until_ready(
            jnp.asarray(scenes.blob(subdivisions=sub)[0]))
        n = btris.shape[0]
        dt = timeit(lambda: build_from_soup(btris, config=bc), iters=iters)
        rec[key] = round(n / dt / 1e6, 1)
        log(f"build[{key}]: {n} tris in {dt*1e3:.2f} ms "
            f"({rec[key]:.1f} Mtris/s)")
    return rec


def config_cornell():
    """Config 1: Cornell box 256^2 primary, single call and amortised."""
    import jax.numpy as jnp

    from rtk_tpu.ops.pallas_trace import trace_packets
    from rtk_tpu.scene import build_from_soup
    from rtk_tpu.trace.packed import pack_scene
    from rtk_tpu.testing import scenes

    packed = pack_scene(build_from_soup(jnp.asarray(scenes.cornell_box())))
    rays = scenes.cornell_camera(256, 256)
    dt = timeit(lambda: trace_packets(packed, rays).t)
    rec = {"cornell_mrays": round(rays.count / dt / 1e6, 2)}
    dtf = timeit_frames(packed, rays, frames=8)
    rec["cornell_amort_mrays"] = round(rays.count / dtf / 1e6, 2)
    log(f"cornell 256x256 primary: {rec['cornell_mrays']:.2f} Mrays/s, "
        f"amortised (8-frame scan) {rec['cornell_amort_mrays']:.2f}")
    return rec


def config_bunny():
    """Config 2 (non-headline parts): bunny 512^2 primary, 4M shadow
    any-hit (sparse + compacted), and record parity against the
    corrected-rtk C++ oracle at 512^2."""
    import jax.numpy as jnp

    from rtk_tpu import BuildConfig, Rays
    from rtk_tpu.ops.pallas_trace import trace_packets
    from rtk_tpu.scene import build_from_soup
    from rtk_tpu.trace.packed import pack_scene
    from rtk_tpu.testing import scenes

    rec = {}
    btris = scenes.blob(subdivisions=6)[0]
    packed = pack_scene(build_from_soup(
        jnp.asarray(btris), config=BuildConfig(branching=8, leaf_size=8)))
    rays512 = scenes.camera_rays((0, 0, 3.0), (0, 0, 0), (0, 1, 0), 45,
                                 512, 512, order="morton")
    dt = timeit(lambda: trace_packets(packed, rays512, sort_rays=False).t)
    rec["bunny_512_mrays"] = round(rays512.count / dt / 1e6, 2)
    dtf = timeit_frames(packed, rays512, frames=8, sort_rays=False)
    rec["bunny_512_amort_mrays"] = round(rays512.count / dtf / 1e6, 2)
    log(f"bunny 512x512 primary: {rec['bunny_512_mrays']:.2f} Mrays/s, "
        f"amortised {rec['bunny_512_amort_mrays']:.2f}")

    # Record parity (hit/t/u/v/prim) against the corrected-rtk C++ oracle:
    # catches a miscompile that keeps hit counts but corrupts records.
    try:
        from rtk_tpu.testing.native_oracle import NativeOracle

        orc = NativeOracle(btris.reshape(-1, 9), leaf_max=8)
        hl = trace_packets(packed, rays512, sort_rays=False)
        ot, ou, ov, oidx = orc.trace(
            np.asarray(rays512.origin), np.asarray(rays512.direction),
            np.asarray(rays512.min_t), np.asarray(rays512.max_t))
        gh = np.asarray(hl.hit)
        oh = oidx >= 0
        n = gh.size
        hit_mism = int((gh != oh).sum())
        both = gh & oh
        t_bad = int((np.abs(np.asarray(hl.t)[both] - ot[both])
                     > 1e-4).sum())
        same = both & (np.asarray(hl.triangle_index) == oidx)
        same_frac = same.sum() / max(both.sum(), 1)
        uv_bad = int(((np.abs(np.asarray(hl.u)[same] - ou[same]) > 1e-3)
                      | (np.abs(np.asarray(hl.v)[same] - ov[same])
                         > 1e-3)).sum())
        ok = (hit_mism <= n * 1e-4 and t_bad <= both.sum() * 1e-4
              and same_frac > 0.95 and uv_bad <= same.sum() * 1e-4)
        rec["record_parity"] = int(ok)
        log(f"record parity [kernel vs rtk-CPU oracle, 512^2]: "
            f"{'OK' if ok else 'FAIL'} (hit mism {hit_mism}/{n}, "
            f"t bad {t_bad}, prim same {same_frac:.4f}, uv bad {uv_bad})")
    except Exception as e:
        rec["record_parity"] = 0
        log(f"record parity gate unavailable: {type(e).__name__}: {e}")

    rays2k = scenes.camera_rays((0, 0, 3.0), (0, 0, 0), (0, 1, 0), 45,
                                2048, 2048, order="morton")
    hits = trace_packets(packed, rays2k, sort_rays=False)
    p = np.asarray(hits.position())
    light = np.array([3.0, 4.0, 2.0], np.float32)
    d = light[None] - p
    dist = np.linalg.norm(d, axis=1)
    dn = d / np.maximum(dist[:, None], 1e-9)
    live = np.asarray(hits.hit)
    shadow = Rays.make(p, dn, min_t=1e-3, max_t=np.where(live, dist, 0.0))
    dt = timeit(lambda: trace_packets(packed, shadow, mode="any").t,
                iters=3)
    rec["bunny_shadow_mrays"] = round(shadow.count / dt / 1e6, 2)
    # Renderer-realistic variant: shadow rays only for hit pixels,
    # compacted to the front.
    nlive = int(live.sum())
    order = np.argsort(~live, kind="stable")[:nlive]
    shadow_c = Rays.make(p[order], dn[order], min_t=1e-3,
                         max_t=dist[order])
    dt = timeit(lambda: trace_packets(packed, shadow_c, mode="any").t,
                iters=3)
    rec["bunny_shadow_compact_mrays"] = round(nlive / dt / 1e6, 2)
    log(f"bunny shadow (any-hit, 4M rays): "
        f"{rec['bunny_shadow_mrays']:.2f} Mrays/s; compacted ({nlive} "
        f"live): {rec['bunny_shadow_compact_mrays']:.2f}")
    return rec


def _atrium_bounce(tracer, cam):
    """1M diffuse-bounce rays off the atrium primaries."""
    import jax
    import jax.numpy as jnp

    from rtk_tpu import Rays
    from rtk_tpu.models.path import cosine_sample, geometric_normal

    prim = tracer.closest(cam)
    n = geometric_normal(prim, cam.direction)
    return Rays(
        origin=prim.position() + 1e-3 * n,
        direction=cosine_sample(jax.random.PRNGKey(0), n),
        min_t=jnp.full((cam.count,), 1e-3, jnp.float32),
        max_t=jnp.where(prim.hit, np.float32(3.4e38), 0.0))


def config_atrium():
    """Config 3: Sponza-class scene, 1024^2 primary and 1-bounce diffuse,
    through Tracer(engine="auto")."""
    from rtk_tpu import Tracer, build_scene
    from rtk_tpu.testing import scenes

    atr = scenes.atrium()
    tracer = Tracer(build_scene(_soup(atr)))
    cam = scenes.camera_rays((0, 6, 9), (0, 2, 0), (0, 1, 0), 60, 1024, 1024,
                             order="morton")
    bounce = _atrium_bounce(tracer, cam)
    rec = {}
    dt = timeit(lambda: tracer.closest(cam).t, iters=3)
    rec["atrium_primary_mrays"] = round(cam.count / dt / 1e6, 2)
    dt = timeit(lambda: tracer.closest(bounce).t, iters=3)
    rec["atrium_bounce_mrays"] = round(cam.count / dt / 1e6, 2)
    log(f"atrium ({atr.shape[0]} tris) [{tracer.engine}]: primary "
        f"{rec['atrium_primary_mrays']:.2f} Mrays/s, diffuse bounce "
        f"{rec['atrium_bounce_mrays']:.2f}")
    return rec


def config_engines():
    """The traversal kernel against XLA's stack engine, end to end through
    Tracer, at the bench's shapes: bunny 512^2 and 8192^2 primaries and
    the atrium diffuse bounce.  The stack engine traces the 67M batch in
    8M-ray slices (its per-ray stacks do not fit the card at once)."""
    import jax

    from rtk_tpu import Tracer, build_scene
    from rtk_tpu.testing import scenes

    def sliced(fn, rays, chunk):
        if rays.count <= chunk:
            return fn(rays).t
        return [fn(rays[i:i + chunk]).t for i in range(0, rays.count, chunk)]

    rec = {}
    bunny = build_scene(_soup(scenes.blob(subdivisions=6)[0]))
    atr = build_scene(_soup(scenes.atrium()))
    acam = scenes.camera_rays((0, 6, 9), (0, 2, 0), (0, 1, 0), 60, 1024,
                              1024, order="morton")
    bounce = _atrium_bounce(Tracer(atr, engine="packet"), acam)
    cells = (
        ("bunny_512", bunny, 512, None),
        ("bunny_8192", bunny, 8192, None),
        ("atrium_bounce", atr, None, bounce),
    )
    for name, scene, side, rays in cells:
        if rays is None:
            rays = scenes.camera_rays((0, 0, 3.0), (0, 0, 0), (0, 1, 0), 45,
                                      side, side, order="morton",
                                      device=side > 1024)
        for engine in ("packet", "stack"):
            tr = Tracer(scene, engine=engine)
            chunk = 1 << 23 if engine == "stack" else rays.count
            try:
                dt = timeit(lambda: sliced(tr.closest, rays, chunk),
                            iters=2 if rays.count > 1 << 22 else 5,
                            batches=2)
                rec[f"{name}_{engine}_ms"] = round(dt * 1e3, 3)
                log(f"engines [{name}] {engine}: {dt*1e3:.3f} ms = "
                    f"{rays.count / dt / 1e6:.2f} Mrays/s")
            except Exception as e:
                rec[f"{name}_{engine}_ms"] = None
                log(f"engines [{name}] {engine} failed: "
                    f"{type(e).__name__}: {str(e)[:300]}")
            jax.clear_caches()
    return rec


def config_refit():
    """Config 4: deforming mesh — fused refit->repack->trace per frame,
    plus the F-frame scan executor."""
    import jax.numpy as jnp

    from rtk_tpu import BuildConfig
    from rtk_tpu.ops.pallas_trace import (trace_packets_refit,
                                          trace_packets_refit_frames)
    from rtk_tpu.scene import build_from_soup
    from rtk_tpu.trace.packed import pack_scene
    from rtk_tpu.testing import scenes

    rec = {}
    # wide_nodes=False: the refit executors only re-derive the packed
    # tables (repack_bounds reads the binary bounds).
    cfg = BuildConfig(branching=8, leaf_size=8, wide_nodes=False)
    grid0 = scenes.deforming_grid(0.0, n=96)  # 18,432 tris
    scene_d = build_from_soup(jnp.asarray(grid0), config=cfg)
    packed_d = pack_scene(scene_d)
    frames = [jnp.asarray(scenes.deforming_grid(t, n=96))
              for t in (0.1, 0.2, 0.3)]
    cam_d = scenes.camera_rays((0, 3, 4), (0, 0, 0), (0, 1, 0), 50, 256, 256,
                               order="morton")
    import itertools

    fctr = itertools.count()
    dt = timeit(lambda: trace_packets_refit(
        packed_d, scene_d, frames[next(fctr) % 3], cam_d,
        sort_rays=False)[0].t, iters=6)
    rec["refit_ms_per_frame"] = round(dt * 1e3, 2)
    F = 32
    clip = jnp.stack([jnp.asarray(scenes.deforming_grid(0.05 * i, n=96))
                      for i in range(F)])
    dt = timeit(lambda: trace_packets_refit_frames(
        packed_d, scene_d, clip, cam_d, sort_rays=False)[-1].t,
        iters=3, batches=2)
    rec["refit_scan_ms_per_frame"] = round(dt / F * 1e3, 3)
    log(f"deforming refit+trace: {rec['refit_ms_per_frame']} ms/frame; "
        f"{F}-frame scan: {rec['refit_scan_ms_per_frame']} ms/frame")
    return rec


def config_instanced():
    """Config 5: 10.2M instanced tris (125 x 82k BLAS), TLAS/BLAS,
    4-bounce wavefront with on-device shade/sample/compaction."""
    import functools

    import jax
    import jax.numpy as jnp

    from rtk_tpu import BuildConfig, Rays
    from rtk_tpu.instancing import (build_instanced, caps_from_counts,
                                    pack_instanced,
                                    trace_closest_instanced_packets)
    from rtk_tpu.models.path import (_ray_sort_key, cosine_sample,
                                     geometric_normal)
    from rtk_tpu.scene import build_from_soup
    from rtk_tpu.testing import scenes

    cfg = BuildConfig(branching=8, leaf_size=8)
    blas = build_from_soup(jnp.asarray(scenes.blob(subdivisions=6)[0]),
                           config=cfg)
    n_inst = 125  # 125 x 81,920 = 10.24M instanced triangles
    side = 5
    tf = np.zeros((n_inst, 3, 4), np.float32)
    rng5 = np.random.default_rng(7)
    for i in range(n_inst):
        gx, gy, gz = i % side, (i // side) % side, i // (side * side)
        sc = 0.35 + 0.15 * rng5.random()
        tf[i, :, :3] = np.eye(3, dtype=np.float32) * sc
        tf[i, :, 3] = (np.array([gx, gy, gz], np.float32) * 1.1
                       + rng5.random(3).astype(np.float32) * 0.2)
    pscene = pack_instanced(
        build_instanced([blas], np.zeros(n_inst, np.int64), tf))
    cam5 = scenes.camera_rays((7, 6.5, 8), (2.2, 2.2, 2.2), (0, 1, 0), 55,
                              1024, 1024, order="morton")
    # C=12 covers this camera's p99 instance-overlap depth, so the
    # stack-engine exactness residual all but vanishes.
    CAND5 = 12
    scene_lo5 = jnp.asarray(tf[:, :, 3].min(axis=0) - 1.0)
    scene_hi5 = jnp.asarray(tf[:, :, 3].max(axis=0) + 2.0)

    @jax.jit
    def _bounce_prep(hits, rays_b, kd):
        # Shade/sample + compaction permutation, all on device: live rays
        # to the front (Morton-keyed within the live run), dead behind.
        nrm = geometric_normal(hits, rays_b.direction)
        nd = cosine_sample(kd, nrm)
        origin = hits.position() + 1e-3 * nrm
        alive = hits.hit
        key32 = _ray_sort_key(
            Rays(origin=origin, direction=nd,
                 min_t=rays_b.min_t, max_t=rays_b.max_t),
            scene_lo5, scene_hi5)
        order = ((~alive).astype(jnp.uint32) << 28) | (key32 >> 4)
        perm = jnp.argsort(order, stable=True)
        return nd, origin, perm, jnp.sum(alive)

    @functools.partial(jax.jit, static_argnames=("m",))
    def _take_rays(origin, nd, perm, n_alive, *, m):
        take = lambda a: jnp.take(a, perm[:m], axis=0)
        live = jnp.arange(m) < n_alive
        return Rays(
            origin=take(origin), direction=take(nd),
            min_t=jnp.full((m,), 1e-3, jnp.float32),
            max_t=jnp.where(live, np.float32(3.4e38), 0.0))

    def wavefront4(k, caps=None, collect=None):
        # Bounce batches keep the full 1024^2 shape (live rays compacted
        # to the front, dead tail max_t=0) so the fused rounds program
        # compiles once; one pooled round_caps tuple serves every trace.
        rays_b = cam5
        total = m = cam5.count
        kw5 = dict(max_candidates=CAND5)
        if caps is not None:
            kw5["round_caps"] = caps

        def trace(rb):
            if collect is not None:
                h, _, cnt = trace_closest_instanced_packets(
                    pscene, rb, return_live_counts=True, **kw5)
                collect.append(np.asarray(cnt))
                return h
            return trace_closest_instanced_packets(pscene, rb, **kw5)[0]

        hits = trace(rays_b)
        for _ in range(3):
            k, kd = jax.random.split(k)
            nd, origin, perm, n_alive_dev = _bounce_prep(hits, rays_b, kd)
            n_alive = int(n_alive_dev)
            if n_alive == 0:
                break
            rays_b = _take_rays(origin, nd, perm, n_alive_dev, m=m)
            hits = trace(rays_b)
            total += n_alive
        jax.block_until_ready(hits.t)
        return total

    col5 = []
    wavefront4(jax.random.PRNGKey(5), collect=col5)  # calibration
    caps5 = caps_from_counts(np.max(np.stack(col5), axis=0), cam5.count)
    log(f"instanced round caps (pooled, calibrated): {caps5}")
    total5 = wavefront4(jax.random.PRNGKey(5), caps=caps5)  # warm-up
    best5 = float("inf")
    for seed in (11, 12):
        t0 = time.perf_counter()
        wavefront4(jax.random.PRNGKey(seed), caps=caps5)
        best5 = min(best5, time.perf_counter() - t0)
    mrays = total5 / best5 / 1e6
    log(f"instanced 10.2M tris (125 x 82k BLAS) 4-bounce wavefront: "
        f"{total5} rays in {best5*1e3:.0f} ms -> {mrays:.2f} Mrays/s")
    return {"instanced_mrays": round(mrays, 2)}


CONFIGS = {
    # name: (fn, subprocess timeout seconds), in priority order: the suite
    # deadline cuts from the back.
    "headline": (config_headline, 600),
    "engines": (config_engines, 900),
    "refit": (config_refit, 420),
    "instanced": (config_instanced, 540),
    "build": (config_build, 540),
    "bunny": (config_bunny, 600),
    "cornell": (config_cornell, 300),
    "atrium": (config_atrium, 540),
}


def main():
    # The parent never imports JAX: every measurement runs in a child
    # process, one at a time, so each child has the card to itself.
    headline = None
    results = {}
    skipped = []
    for name, (_, timeout) in CONFIGS.items():
        rem = _remaining()
        if rem < 90:
            skipped.append(name)
            continue
        rec = _run_config(name, min(timeout, max(60, rem - 20)))
        if rec is None:
            continue
        results.update(rec)
        if name == "headline":
            headline = rec
            emit_headline(rec["headline_mrays"], rec)
    if skipped:
        log(f"configs skipped (suite budget {SUITE_BUDGET_S:.0f}s "
            f"exhausted): {skipped}")
    log("bench summary: " + json.dumps(results))
    if headline is None:
        sys.exit(1)
    emit_headline(headline["headline_mrays"], headline)


if __name__ == "__main__":
    if len(sys.argv) >= 3 and sys.argv[1] == "--config":
        _device = _child_setup()
        _rec = CONFIGS[sys.argv[2]][0]()
        print(json.dumps({**_device, **_rec}))
    else:
        main()
