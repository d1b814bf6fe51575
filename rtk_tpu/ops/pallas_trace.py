"""Thread-per-ray BVH8 traversal kernel (Pallas, Triton route).

Each lane of a Pallas program is one ray.  A lane keeps its ray, its best
hit (t, u, v, slot), its current entry and its stack pointer in registers,
and one `while` loop steps the program until every lane is done:

  1. pop: lanes with no current entry, or whose entry is no nearer than
     their best hit (the pop-cull of rtk.c:432-437), pop their stack until
     they hold a live entry or the stack runs dry;
  2. internal: lanes at a wide node fetch its 8 child boxes by per-lane
     gathers from the packed node table, slab-test them (rtk.c:449-473),
     sort the hits near to far with the compare-exchange network of
     trace/stack.py, descend into the nearest and push the rest;
  3. leaf: lanes at a leaf test its K triangles with the watertight shear
     test and its double-word exact-zero fallback (ops/intersect.py,
     rtk.c:181-388).

Per-ray stacks live in device memory and are sized by the rays in flight,
not by the batch: the grid is persistent (a fixed number of programs, each
looping over ray tiles) and each program owns BLOCK stacks of depth
MAX_STACK.  A push past the bound is dropped and sets the ray's overflow
flag (`PacketHits.overflow`), so an overflow is always reported.

The work is FP32 and integer scalar arithmetic, gathers and divergent
loops, with no matrix product, so the kernel takes the Triton route and
TF32 never enters.  Pallas' interpret mode runs the same kernel on the CPU,
which is how the tests reach it.

Table layout (trace/packed.py): a node is 8 rows of 8 int32, one row per
child slot: the child box (f32 bit patterns) in columns 0-5; row 0 carries
(first_child, first_leaf) in columns 6-7 and row 1 the slot masks in
column 6.  A triangle is one row of 16 f32: three vertices, then the
filter-mask, mesh and triangle-id columns.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from rtk_tpu.ops.intersect import rounded
from rtk_tpu.trace.packed import (MASK_COL, MESH_COL, NODE_ROW_I32,
                                  PRIM_COL, TRI_ROW_F32, W, PackedScene)
from rtk_tpu.types import PacketHits, Rays

NODE_I32 = W * NODE_ROW_I32  # int32 words per packed node
BLOCK = 32  # rays per program: one warp, one ray per thread
MAX_STACK = 64  # per-ray stack entries (rtk: RTK_BVH_MAX_DEPTH=64, rtk.c:5)
PROGRAMS_PER_SM = 16  # persistent programs per streaming multiprocessor
INTERPRET_PROGRAMS = 4  # persistent programs when interpreted on the CPU

_BIG = 3.0e38
_INF = float("inf")

# Batcher odd-even merge network for 8 keys (the same 19 comparators as
# trace/stack.py's _sort_w, applied lane-wise).
_NET8 = ((0, 1), (2, 3), (4, 5), (6, 7), (0, 2), (1, 3), (4, 6), (5, 7),
         (1, 2), (5, 6), (0, 4), (1, 5), (2, 6), (3, 7), (2, 4), (3, 5),
         (1, 2), (3, 4), (5, 6))


def _any(mask):
    """Block-wide OR as a scalar (Triton lowers max, not reduce_or)."""
    return jnp.max(mask.astype(jnp.int32)) > 0


def _sel3(k, a, b, c):
    return jnp.where(k == 0, a, jnp.where(k == 1, b, c))


def _rounded_mul(interpret):
    """A multiply whose result is rounded to f32 before any later use.

    Compilers contract a*b - c*d into fma(a, b, -c*d), which rounds the two
    products differently: an edge shared by two triangles then no longer
    gets exactly opposite edge functions, and a ray through the edge leaks
    (watertightness).  On the card the kernel issues PTX mul.rn, which
    ptxas never fuses; interpreted, `rounded` (ops/intersect.py) hides the
    product from XLA's contraction.

    Division is the plain f32 divide, the same one XLA uses on each
    platform: correctly rounded on the CPU, and div.full.f32 (within 2 ulp)
    on the GPU from both XLA and Triton.  The kernel and the XLA engines
    thus share every division bit for bit; an exactly rounded divide in the
    kernel alone would move the shear constants by an ulp against the XLA
    engines and flip rays that graze an edge."""
    if interpret:
        return lambda a, b: rounded(a * b)

    def mul(a, b):
        return plt.elementwise_inline_asm(
            "mul.rn.f32 $0, $1, $2;", args=[a, b], constraints="=f,f,f",
            pack=1, result_shape_dtypes=[jax.ShapeDtypeStruct(a.shape,
                                                              jnp.float32)])[0]

    return mul


def _edge_dw(ax, ay, bx, by, mul):
    """Double-word exact-sign edge function ax*by - ay*bx (the f32 stand-in
    for the reference's f64 exact-zero fallback, rtk.c:306-336).  `mul`
    rounds the split and the leading products; the partial products are
    exact, so contracting them changes nothing."""
    def split(a):  # Veltkamp: a = hi + lo, halves of 12 significant bits
        ca = mul(jnp.full_like(a, 4097.0), a)
        hi = ca - (ca - a)
        return hi, a - hi

    axh, axl = split(ax)
    ayh, ayl = split(ay)
    bxh, bxl = split(bx)
    byh, byl = split(by)
    p1 = mul(ax, by)
    e1 = ((axh * byh - p1) + axh * byl + axl * byh) + axl * byl
    p2 = mul(ay, bx)
    e2 = ((ayh * bxh - p2) + ayh * bxl + ayl * bxh) + ayl * bxl
    s = p1 - p2
    bb = s - p1
    e3 = (p1 - (s - bb)) + (-p2 - bb)
    return s + (e3 + (e1 - e2))


def _make_kernel(*, mode, watertight, leaf_size, max_stack, tiles,
                 use_mask, filter_fn, stats, defer_uv, interpret):
    K = leaf_size
    D = max_stack
    mul = _rounded_mul(interpret)

    def kernel(nodes_ref, tris_ref, ox_ref, oy_ref, oz_ref, dx_ref, dy_ref,
               dz_ref, mint_ref, maxt_ref, root_ref, *rest):
        if use_mask:
            qmask_ref, *rest = rest
        if filter_fn is not None:
            ridx_ref, *rest = rest
        t_ref, slot_ref, ovf_ref, *rest = rest
        if not defer_uv:
            u_ref, v_ref, *rest = rest
        if stats:
            steps_ref, *rest = rest
        stk_n_ref, stk_t_ref = rest

        pid = pl.program_id(0)
        nprog = pl.num_programs(0)
        lane = jax.lax.iota(jnp.int32, BLOCK)
        sbase = (pid * BLOCK + lane) * D  # this program's stacks
        qmask = qmask_ref[0] if use_mask else None

        def tile(i, carry):
            r = (i * nprog + pid) * BLOCK + lane
            ox, oy, oz = ox_ref[r], oy_ref[r], oz_ref[r]
            dx, dy, dz = dx_ref[r], dy_ref[r], dz_ref[r]
            mint, maxt = mint_ref[r], maxt_ref[r]
            ridx = ridx_ref[r] if filter_fn is not None else None

            def crcp(d):
                # Clamped reciprocal: finite huge instead of inf keeps the
                # slab products NaN-free ((v - o) * rcp with v == o).
                return jnp.where(d == 0.0, jnp.where(d >= 0, _BIG, -_BIG),
                                 1.0 / d)

            rcpx, rcpy, rcpz = crcp(dx), crcp(dy), crcp(dz)
            # Near/far plane columns per axis: lanes read the plane they
            # need instead of selecting between two loaded ones.
            nx = jnp.where(rcpx >= 0, 0, 3)
            ny = jnp.where(rcpy >= 0, 1, 4)
            nz = jnp.where(rcpz >= 0, 2, 5)
            fx, fy, fz = 3 - nx, 5 - ny, 7 - nz

            # Shear basis (rtk.c:550-567): kz = first axis of max |d|.
            adx, ady, adz = jnp.abs(dx), jnp.abs(dy), jnp.abs(dz)
            maxc = jnp.maximum(adx, jnp.maximum(ady, adz))
            kz = jnp.where(adx == maxc, 0, jnp.where(ady == maxc, 1, 2))
            kx = jnp.where(kz == 2, 0, kz + 1)
            ky = jnp.where(kx == 2, 0, kx + 1)
            d_kz = _sel3(kz, dx, dy, dz)
            sx = -_sel3(kx, dx, dy, dz) / d_kz
            sy = -_sel3(ky, dx, dy, dz) / d_kz
            sz = 1.0 / d_kz
            o_kx = _sel3(kx, ox, oy, oz)
            o_ky = _sel3(ky, ox, oy, oz)
            o_kz = _sel3(kz, ox, oy, oz)

            def internal(args):
                cur, cur_t, sp, ht, ovf = args
                is_int = cur >= 0
                base = jnp.where(is_int, cur, 0) * NODE_I32
                node_i = lambda off: plt.load(nodes_ref.at[off],
                                              mask=is_int, other=0)
                first_child = node_i(base + 6)
                first_leaf = node_i(base + 7)
                masks = node_i(base + 14)
                ts, ids = [], []
                kcount = jnp.zeros_like(cur)
                nxt_int, nxt_leaf = first_child, first_leaf
                for c in range(W):
                    ib = (masks >> c) & 1
                    lb = (masks >> (W + c)) & 1
                    valid = is_int & ((ib | lb) != 0)
                    row = base + c * NODE_ROW_I32

                    def plane(col, row=row, valid=valid):
                        bits = plt.load(nodes_ref.at[row + col], mask=valid,
                                        other=0)
                        return jax.lax.bitcast_convert_type(bits,
                                                            jnp.float32)

                    enter = jnp.maximum(
                        jnp.maximum((plane(nx) - ox) * rcpx,
                                    (plane(ny) - oy) * rcpy),
                        jnp.maximum((plane(nz) - oz) * rcpz, mint))
                    exit_ = jnp.minimum(
                        jnp.minimum((plane(fx) - ox) * rcpx,
                                    (plane(fy) - oy) * rcpy),
                        jnp.minimum((plane(fz) - oz) * rcpz, ht))
                    hit = valid & (enter <= exit_)
                    ts.append(jnp.where(hit, enter, _INF))
                    ids.append(jnp.where(ib != 0, nxt_int, -nxt_leaf - 2))
                    kcount = kcount + hit.astype(jnp.int32)
                    nxt_int = nxt_int + ib
                    nxt_leaf = nxt_leaf + lb
                for a, b in _NET8:
                    swap = ts[a] > ts[b]
                    ts[a], ts[b] = (jnp.where(swap, ts[b], ts[a]),
                                    jnp.where(swap, ts[a], ts[b]))
                    ids[a], ids[b] = (jnp.where(swap, ids[b], ids[a]),
                                      jnp.where(swap, ids[a], ids[b]))
                # Descend into the nearest hit child; push the others far
                # to near so the next-nearest pops first.
                for i in range(1, W):
                    pos = sp + kcount - 1 - i
                    m = is_int & (i < kcount) & (pos < D)
                    at = sbase + jnp.clip(pos, 0, D - 1)
                    plt.store(stk_n_ref.at[at], ids[i], mask=m)
                    plt.store(stk_t_ref.at[at], ts[i], mask=m)
                new_sp = sp + jnp.maximum(kcount - 1, 0)
                ovf = ovf | (is_int & (new_sp > D))
                has = kcount > 0
                cur_n = jnp.where(is_int, jnp.where(has, ids[0], -1), cur)
                cur_tn = jnp.where(is_int, ts[0], cur_t)
                sp = jnp.where(is_int, jnp.minimum(new_sp, D), sp)
                return cur_n, cur_tn, sp, ht, ovf

            def leaf(args):
                cur, sp, ht, hu, hv, hs = args
                is_leaf = cur <= -2
                first = jnp.where(is_leaf, -cur - 2, 0) * K

                def tri(k, carry):
                    ht, hu, hv, hs, found = carry
                    slot = first + k
                    row = slot * TRI_ROW_F32
                    # Inactive lanes read NaN: it never passes the t-window
                    # and never triggers the exact-zero pass.
                    col = lambda c: plt.load(tris_ref.at[row + c],
                                             mask=is_leaf, other=jnp.nan)
                    xs, ys, zs = [], [], []
                    for j in range(3):
                        # Translate before shearing (rtk.c:228-240): folding
                        # the origin into the shear loses precision.
                        px = col(3 * j + kx) - o_kx
                        py = col(3 * j + ky) - o_ky
                        pz = col(3 * j + kz) - o_kz
                        xs.append(px + mul(sx, pz))
                        ys.append(py + mul(sy, pz))
                        zs.append(sz * pz)
                    edge = lambda a, b: (mul(xs[a], ys[b])
                                         - mul(ys[a], xs[b]))
                    u, v, w = edge(1, 2), edge(2, 0), edge(0, 1)
                    if watertight:
                        need = (u == 0.0) | (v == 0.0) | (w == 0.0)

                        def exact(uvw):
                            uu, vv, ww = uvw
                            dw = lambda a, b: _edge_dw(xs[a], ys[a], xs[b],
                                                       ys[b], mul)
                            return (jnp.where(need, dw(1, 2), uu),
                                    jnp.where(need, dw(2, 0), vv),
                                    jnp.where(need, dw(0, 1), ww))

                        # Exact zeros are rare: branch on the whole block.
                        u, v, w = jax.lax.cond(_any(need), exact,
                                               lambda uvw: uvw, (u, v, w))
                    lo = jnp.minimum(jnp.minimum(u, v), w)
                    hi = jnp.maximum(jnp.maximum(u, v), w)
                    rcp_det = 1.0 / (u + v + w)
                    t = (mul(u, zs[0]) + mul(v, zs[1])
                         + mul(w, zs[2])) * rcp_det
                    ok = (is_leaf & ~((lo < 0.0) & (hi > 0.0))
                          & (t > mint) & (t < ht))
                    if use_mask:
                        ok = ok & ((col(MASK_COL).astype(jnp.int32)
                                    & qmask) != 0)
                    if filter_fn is not None:
                        from rtk_tpu.trace.stack import HitCandidate

                        ok = ok & filter_fn(HitCandidate(
                            t=t, u=u * rcp_det, v=v * rcp_det,
                            mesh_index=col(MESH_COL).astype(jnp.int32),
                            triangle_index=col(PRIM_COL).astype(jnp.int32),
                            ray_index=ridx))
                    ht = jnp.where(ok, t, ht)
                    if not defer_uv:
                        hu = jnp.where(ok, u * rcp_det, hu)
                        hv = jnp.where(ok, v * rcp_det, hv)
                    hs = jnp.where(ok, slot, hs)
                    return ht, hu, hv, hs, found | ok

                ht, hu, hv, hs, found = jax.lax.fori_loop(
                    0, K, tri, (ht, hu, hv, hs, jnp.zeros_like(is_leaf)))
                cur = jnp.where(is_leaf, -1, cur)
                if mode == "any":
                    # The first accepted hit ends the ray.
                    sp = jnp.where(found, 0, sp)
                return cur, sp, ht, hu, hv, hs

            def stale(cur, cur_t, ht):
                return (cur == -1) | (cur_t >= ht)

            def step(st):
                cur, cur_t, sp, ht, hu, hv, hs, steps, ovf = st

                def pop(c):
                    cur, cur_t, sp = c
                    need = stale(cur, cur_t, ht) & (sp > 0)
                    at = sbase + jnp.maximum(sp - 1, 0)
                    pn = plt.load(stk_n_ref.at[at], mask=need, other=-1)
                    pt = plt.load(stk_t_ref.at[at], mask=need, other=0.0)
                    return (jnp.where(need, pn, cur),
                            jnp.where(need, pt, cur_t),
                            jnp.where(need, sp - 1, sp))

                cur, cur_t, sp = jax.lax.while_loop(
                    lambda c: _any(stale(c[0], c[1], ht) & (c[2] > 0)),
                    pop, (cur, cur_t, sp))
                cur = jnp.where(stale(cur, cur_t, ht), -1, cur)
                steps = steps + (cur != -1).astype(jnp.int32)
                cur, cur_t, sp, ht, ovf = jax.lax.cond(
                    _any(cur >= 0), internal, lambda a: a,
                    (cur, cur_t, sp, ht, ovf))
                cur, sp, ht, hu, hv, hs = jax.lax.cond(
                    _any(cur <= -2), leaf, lambda a: a,
                    (cur, sp, ht, hu, hv, hs))
                return cur, cur_t, sp, ht, hu, hv, hs, steps, ovf

            zf = jnp.zeros((BLOCK,), jnp.float32)
            zi = jnp.zeros((BLOCK,), jnp.int32)
            # Rays with an empty t-window (max_t <= min_t: padding and the
            # wavefront compaction convention) start done.
            cur0 = jnp.where(maxt > mint, root_ref[r], -1)
            st = (cur0, zf - _INF, zi, maxt, zf, zf, zi - 1, zi,
                  jnp.zeros((BLOCK,), jnp.bool_))
            st = jax.lax.while_loop(
                lambda s: _any((s[0] != -1) | (s[2] > 0)), step, st)
            _, _, _, ht, hu, hv, hs, steps, ovf = st
            t_ref[r] = ht
            slot_ref[r] = hs
            ovf_ref[r] = ovf.astype(jnp.int32)
            if not defer_uv:
                u_ref[r] = hu
                v_ref[r] = hv
            if stats:
                steps_ref[r] = steps
            return carry

        jax.lax.fori_loop(0, tiles, tile, 0)

    return kernel


_TARGET_SMS = contextvars.ContextVar("target_sms", default=None)


@contextlib.contextmanager
def target_sm_count(count: int):
    """Size the persistent grid for a card with `count` SMs instead of the
    local device: for lowering on a host without that card (AOT export)."""
    token = _TARGET_SMS.set(int(count))
    try:
        yield
    finally:
        _TARGET_SMS.reset(token)


def _sm_count() -> int:
    """Streaming multiprocessors that size the persistent grid: the
    target_sm_count in force, else the first device's."""
    if _TARGET_SMS.get() is not None:
        return _TARGET_SMS.get()
    dev = jax.devices()[0]
    count = getattr(dev, "core_count", None)
    if not count:
        raise RuntimeError(
            f"{dev.device_kind} reports no SM count (core_count), which "
            "sizes the kernel's persistent grid; the compiled kernel needs "
            "a GPU (pass interpret=True to run it interpreted, or lower "
            "under target_sm_count)")
    return int(count)


def grid_programs(interpret: bool) -> int:
    """Persistent programs of one launch: PROGRAMS_PER_SM per SM on the
    card (measured best, PERF.md), INTERPRET_PROGRAMS interpreted."""
    if interpret:
        return INTERPRET_PROGRAMS
    return _sm_count() * PROGRAMS_PER_SM


def launch_geometry(n: int, programs: int):
    """(programs, tiles per program, padded ray count) for n rays on a
    persistent grid of at most `programs` programs.

    Each program loops over ray tiles of BLOCK rays, so stack memory
    scales with programs * BLOCK, not with n."""
    tiles = max(1, -(-n // BLOCK))
    programs = min(programs, tiles)
    per = -(-tiles // programs)
    return programs, per, programs * per * BLOCK


@functools.partial(
    jax.jit,
    static_argnames=("mode", "watertight", "interpret", "sort_rays",
                     "use_mask", "stats", "filter_fn", "defer_uv",
                     "max_stack", "programs"))
def _trace_impl(packed, origin, direction, min_t, max_t, roots, qmask, *,
                mode, watertight, interpret, sort_rays, use_mask, stats,
                filter_fn, defer_uv, max_stack, programs):
    """One program: optional coherence sort -> kernel -> unsort -> lazy
    hit record.  `programs` bounds the persistent grid (grid_programs,
    resolved outside the jit so that it keys the cache)."""
    n = origin.shape[0]
    perm = None
    comps = [origin[:, 0], origin[:, 1], origin[:, 2], direction[:, 0],
             direction[:, 1], direction[:, 2], min_t, max_t, roots]
    if sort_rays:
        from rtk_tpu.ops.morton import ray_coherence_key

        perm = jnp.argsort(ray_coherence_key(origin, direction))
        comps = [jnp.take(c, perm) for c in comps]
    nprog, per, npad = launch_geometry(n, programs)
    pad = npad - n
    fills = (0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0)  # max_t 0: dead
    comps = [jnp.concatenate([c, jnp.full((pad,), f, c.dtype)]) if pad
             else c for c, f in zip(comps, fills)]
    if use_mask:
        comps.append(qmask)
    if filter_fn is not None:
        # The caller's ray index per lane, so the filter sees ray identity
        # through the coherence sort.  Pad lanes carry n (dead anyway).
        ridx = (perm.astype(jnp.int32) if perm is not None
                else jnp.arange(n, dtype=jnp.int32))
        comps.append(jnp.concatenate(
            [ridx, jnp.full((pad,), n, jnp.int32)]) if pad else ridx)
    ray_f = jax.ShapeDtypeStruct((npad,), jnp.float32)
    ray_i = jax.ShapeDtypeStruct((npad,), jnp.int32)
    out_shape = [ray_f, ray_i, ray_i]
    if not defer_uv:
        out_shape += [ray_f, ray_f]
    if stats:
        out_shape.append(ray_i)
    stack_words = nprog * BLOCK * max_stack
    out_shape += [jax.ShapeDtypeStruct((stack_words,), jnp.int32),
                  jax.ShapeDtypeStruct((stack_words,), jnp.float32)]
    kernel = _make_kernel(
        mode=mode, watertight=watertight, leaf_size=packed.leaf_size,
        max_stack=max_stack, tiles=per, use_mask=use_mask,
        filter_fn=filter_fn, stats=stats, defer_uv=defer_uv,
        interpret=interpret)
    outs = pl.pallas_call(
        kernel,
        out_shape=out_shape,
        grid=(nprog,),
        backend="triton",
        interpret=interpret,
        name=f"bvh_traverse_{mode}",
        compiler_params=plt.CompilerParams(num_warps=1, num_stages=1),
    )(packed.nodes.reshape(-1), packed.tris.reshape(-1), *comps)
    outs = list(outs[:-2])
    t, slot, ovf = outs[:3]
    rest = outs[3:]
    if not defer_uv:
        u, v, *rest = rest
    steps = rest[0] if stats else None

    def unsort(a):
        a = a[:n]
        if perm is None:
            return a
        return jnp.zeros_like(a).at[perm].set(a)

    t, slot, ovf = unsort(t), unsort(slot), unsort(ovf)
    hit = slot >= 0
    if defer_uv:
        u = v = jnp.zeros_like(t)
    else:
        u = jnp.where(hit, unsort(u), 0.0)
        v = jnp.where(hit, unsort(v), 0.0)
    hits = PacketHits(
        hit=hit, t=t, u_k=u, v_k=v, slot=slot, origin=origin,
        direction=direction, tri_v=packed.tri_v, tri_vidx=packed.tri_vidx,
        tri_mesh=packed.tri_mesh, tri_prim=packed.tri_prim,
        overflow=ovf > 0, uv_deferred=defer_uv)
    if stats:
        return hits, unsort(steps)
    return hits


def trace_packets(packed: PackedScene, rays: Rays, mode: str = "closest",
                  watertight: bool = True, interpret: bool = False,
                  roots=None, sort_rays: bool | None = None,
                  filter_mask: int | None = None, stats: bool = False,
                  filter_fn=None, defer_uv: bool = False) -> PacketHits:
    """Trace rays with the thread-per-ray traversal kernel.

    Hit-record contract matches rtk_trace_ray (rtk.c:543-577): t, u, v,
    vertex records, mesh/triangle indices; a miss leaves t = max_t.  The
    record comes back as a lazy PacketHits: the index/vertex gathers run
    only for consumers that read those fields (`.full()` materialises a
    plain Hits).  `hits.overflow` flags rays whose stack overflowed.

    roots: optional (N,) per-ray start node (multi-root tables: the
    instanced rounds start each ray at its instance's BLAS root).
    sort_rays=None sorts large batches by a Morton key of a probe point
    (neighbouring lanes then visit the same nodes); results come back in
    the caller's order.  filter_mask=m tests only triangles whose packed
    mask has a common bit with m; filter_fn is a jax-traceable predicate
    on a HitCandidate (trace/stack.py) evaluated in the leaf phase.
    defer_uv drops the u/v carries; PacketHits recomputes them on access.
    stats=True also returns the per-ray traversal step count.  Each ray's
    stack holds MAX_STACK entries; `hits.overflow` flags rays that needed
    more.
    interpret=True runs the kernel in Pallas' CPU interpreter.
    """
    if mode not in ("closest", "any"):
        raise ValueError(f"unknown mode {mode!r}")
    n = rays.count
    if sort_rays is None:
        sort_rays = n >= 16384
    if roots is None:
        roots = jnp.zeros((n,), jnp.int32)
    else:
        roots = jnp.asarray(roots, jnp.int32)
        if roots.shape != (n,):
            raise ValueError(f"roots must have shape ({n},), got "
                             f"{roots.shape}")
    qmask = None
    if filter_mask is not None:
        qmask = jnp.full((1,), int(filter_mask) & 0xFFFFFF, jnp.int32)
    if filter_fn is not None:
        if not callable(filter_fn):
            raise TypeError("filter_fn must be callable")
        if packed.num_tris >= (1 << 24):
            # Mesh and triangle ids ride the table as exact f32 values.
            raise ValueError("kernel filter callables need triangle ids "
                             "exact in f32 (< 2^24 triangles); use the "
                             "stack engine")
    return _trace_impl(
        packed, jnp.asarray(rays.origin), jnp.asarray(rays.direction),
        jnp.asarray(rays.min_t), jnp.asarray(rays.max_t), roots, qmask,
        mode=mode, watertight=watertight, interpret=interpret,
        sort_rays=bool(sort_rays), use_mask=filter_mask is not None,
        stats=stats, filter_fn=filter_fn, defer_uv=defer_uv,
        max_stack=MAX_STACK, programs=grid_programs(interpret))


def trace_packets_chunked(packed: PackedScene, rays: Rays,
                          chunk: int = 1 << 24, **kw) -> PacketHits:
    """trace_packets with bounded working memory for huge ray batches.

    trace_packets materialises several N-sized intermediates besides its
    outputs (sort keys and permutations, padded ray components).  This
    host loop traces `chunk`-ray slices, each one program, then
    concatenates the per-ray results.  A final partial slice is padded
    with dead rays up to `chunk` so every slice reuses one compiled
    program.  The packed tables are shared, not copied.
    """
    n = rays.count
    if n <= chunk:
        return trace_packets(packed, rays, **kw)
    outs = []
    for i in range(0, n, chunk):
        sl = jax.tree.map(lambda a: a[i:i + chunk], rays)
        pad = chunk - sl.count
        if pad:
            sl = Rays(
                origin=jnp.concatenate(
                    [sl.origin, jnp.zeros((pad, 3), jnp.float32)]),
                direction=jnp.concatenate(
                    [sl.direction,
                     jnp.tile(jnp.array([[1.0, 0.0, 0.0]], jnp.float32),
                              (pad, 1))]),
                min_t=jnp.concatenate(
                    [sl.min_t, jnp.zeros((pad,), jnp.float32)]),
                max_t=jnp.concatenate(
                    [sl.max_t, jnp.zeros((pad,), jnp.float32)]))
        h = trace_packets(packed, sl, **kw)
        if pad:
            h = h[:chunk - pad]
        outs.append(h)
    cat = lambda f: jnp.concatenate([getattr(o, f) for o in outs])
    return dataclasses.replace(
        outs[0], hit=cat("hit"), t=cat("t"), u_k=cat("u_k"), v_k=cat("v_k"),
        slot=cat("slot"), overflow=cat("overflow"), origin=rays.origin,
        direction=rays.direction)


def _refit_repack(scene, packed, tri_pos):
    """One frame's refit+repack: Scene (LBVH RMQ refit) or BinaryRefitAux
    (host-SAH topology, refit_packed_binary).  The type switch is static
    under jit (pytree structure)."""
    from rtk_tpu.trace.packed import BinaryRefitAux, refit_packed_binary

    if isinstance(scene, BinaryRefitAux):
        return scene, refit_packed_binary(packed, scene, tri_pos)
    from rtk_tpu.scene import refit as _refit
    from rtk_tpu.trace.packed import repack_bounds

    scene2 = _refit(scene, tri_pos)
    return scene2, repack_bounds(packed, scene2)


def _trace_kw(rays, interpret, sort_rays, mode, watertight, defer_uv):
    n = rays.count
    return dict(mode=mode, watertight=watertight, interpret=interpret,
                sort_rays=n >= 16384 if sort_rays is None else bool(sort_rays),
                use_mask=False, stats=False, filter_fn=None,
                defer_uv=defer_uv, max_stack=MAX_STACK,
                programs=grid_programs(interpret))


@functools.partial(jax.jit, static_argnames=("kw",))
def _refit_trace_jit(scene, packed, new_tri_pos, origin, direction, min_t,
                     max_t, *, kw):
    scene2, packed2 = _refit_repack(scene, packed, new_tri_pos)
    roots = jnp.zeros((origin.shape[0],), jnp.int32)
    hits = _trace_impl(packed2, origin, direction, min_t, max_t, roots,
                       None, **dict(kw))
    return hits, scene2, packed2


def trace_packets_refit(packed: PackedScene, scene, new_tri_pos, rays: Rays,
                        mode: str = "closest", watertight: bool = True,
                        interpret: bool = False,
                        sort_rays: bool | None = None,
                        defer_uv: bool = False):
    """Per-frame dynamic-scene step as ONE device program: refit the BVH to
    deformed vertices (same topology), regather the packed tables, trace.

    `scene` is either the LBVH Scene the PackedScene was packed from, or
    a BinaryRefitAux (build_sah_packed(refittable=True)), whose host-SAH
    topology refits on device with the same RMQ machinery.

    Returns (hits, refit_scene, repacked_scene).
    """
    kw = _trace_kw(rays, interpret, sort_rays, mode, watertight, defer_uv)
    return _refit_trace_jit(
        scene, packed, jnp.asarray(new_tri_pos, jnp.float32),
        jnp.asarray(rays.origin), jnp.asarray(rays.direction),
        jnp.asarray(rays.min_t), jnp.asarray(rays.max_t),
        kw=tuple(sorted(kw.items())))


@functools.partial(jax.jit, static_argnames=("kw",))
def _refit_trace_frames_jit(scene, packed, frames, origin, direction, min_t,
                            max_t, *, kw):
    kw = dict(kw)
    # Refit + repack ALL frames in one vmapped prep: the per-frame refit
    # is a chain of sequential RMQ levels, which vmapped runs once on
    # (F, ...) operands; the scan body keeps only the trace.
    def prep(tri_pos):
        _, p2 = _refit_repack(scene, packed, tri_pos)
        return p2.nodes, p2.tris, p2.tri_v

    nodes_f, tris_f, triv_f = jax.vmap(prep)(frames)

    # The coherence sort permutes the same rays identically on every frame:
    # sort once here, trace unsorted inside the scan, un-permute once.
    inv = None
    if kw["sort_rays"]:
        from rtk_tpu.ops.morton import ray_coherence_key

        perm = jnp.argsort(ray_coherence_key(origin, direction))
        origin, direction = origin[perm], direction[perm]
        min_t, max_t = min_t[perm], max_t[perm]
        inv = jnp.zeros_like(perm).at[perm].set(
            jnp.arange(perm.shape[0], dtype=perm.dtype))
        kw["sort_rays"] = False
    roots = jnp.zeros((origin.shape[0],), jnp.int32)

    def body(_, per_frame):
        nodes, tris, tri_v = per_frame
        packed2 = dataclasses.replace(packed, nodes=nodes, tris=tris,
                                      tri_v=tri_v)
        h = _trace_impl(packed2, origin, direction, min_t, max_t, roots,
                        None, **kw)
        # u_k/v_k, not .u/.v: under defer_uv the latter are lazy
        # recomputes, which the scan must not force per frame.
        return (), (h.t, h.u_k, h.v_k, h.slot, h.overflow, tri_v)

    _, outs = jax.lax.scan(body, (), (nodes_f, tris_f, triv_f))
    if inv is not None:
        t, u, v, slot, ovf, tri_v = outs
        outs = (t[:, inv], u[:, inv], v[:, inv], slot[:, inv], ovf[:, inv],
                tri_v)
    return outs


def trace_packets_refit_frames(packed: PackedScene, scene, frames_tri_pos,
                               rays: Rays, mode: str = "closest",
                               watertight: bool = True,
                               interpret: bool = False,
                               sort_rays: bool | None = None,
                               defer_uv: bool = False):
    """Animation executor: refit+repack+trace F deformation frames of one
    topology against one ray batch as ONE device program (`lax.scan` over
    frames; the kernel compiles once for the whole clip).

    frames_tri_pos: (F, T, 3, 3) per-frame triangle vertices in soup
    order.  Returns a list of F PacketHits (frame order); index tables are
    shared (static topology), tri_v is per frame.
    """
    kw = _trace_kw(rays, interpret, sort_rays, mode, watertight, defer_uv)
    frames = jnp.asarray(frames_tri_pos, jnp.float32)
    origin = jnp.asarray(rays.origin)
    direction = jnp.asarray(rays.direction)
    t, u, v, slot, ovf, tri_v = _refit_trace_frames_jit(
        scene, packed, frames, origin, direction,
        jnp.asarray(rays.min_t), jnp.asarray(rays.max_t),
        kw=tuple(sorted(kw.items())))
    return [
        PacketHits(hit=slot[f] >= 0, t=t[f], u_k=u[f], v_k=v[f],
                   slot=slot[f], origin=origin, direction=direction,
                   tri_v=tri_v[f], tri_vidx=packed.tri_vidx,
                   tri_mesh=packed.tri_mesh, tri_prim=packed.tri_prim,
                   overflow=ovf[f], uv_deferred=defer_uv)
        for f in range(frames.shape[0])
    ]
