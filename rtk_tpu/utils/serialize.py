"""Scene serialization: a versioned, relocatable container.

The reference's scene *is* its file format — a relocatable blob with a
magic/endian/version/sizeof_real header and byte-offset section table
(rtk.h:78-89, rtk.c:1732-1774), explicitly designed for save/mmap.  This
module preserves those semantics for the scene pytrees:

  header:  magic "\\0RTK8TPU" (8 bytes), endian mark 0xAABB (u16),
           sizeof_real (u8), kind (u8), version (u32),
           total size (u64), section count (u32),
           static-metadata block (u32 count + i64 x count).
  section: name (24 bytes), dtype code (u8), ndim (u8), shape (u32 x 4),
           byte offset (u64, 128-aligned like rtk's section alignment,
           rtk.c:1719-1730), byte size (u64).

Three container kinds round-trip (the reference blob is its runtime
format, so derived scenes must not need a rebuild after load):

  * kind 0 ``Scene``          — the base LBVH pytree,
  * kind 1 ``PackedScene``    — the packet-kernel tables (load-and-trace),
  * kind 2 ``InstancedScene`` — merged-BLAS forest + instance table.

Arrays are stored little-endian, contiguous; load() reads and
reconstructs the pytree.  Loading checks magic, endianness and version
(the validation rtk declares fields for but never implements — SURVEY
§3.4).  ``load_any()`` dispatches on the header kind.
"""
from __future__ import annotations

import io
import struct as pystruct
from typing import BinaryIO, Union

import jax.numpy as jnp
import numpy as np

from rtk_tpu.scene import Scene

MAGIC = b"\x00RTK8TPU"
ENDIAN_MARK = 0xAABB
VERSION = 2
ALIGN = 128

KIND_SCENE = 0
KIND_PACKED = 1
KIND_INSTANCED = 2

_DTYPES = {0: np.float32, 1: np.int32, 2: np.uint32, 3: np.float64,
           4: np.int64, 5: np.uint8}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}

# Scene array fields in serialization order.
_FIELDS = [
    "node_child", "node_min", "node_max", "bin_left", "bin_right",
    "bin_lo", "bin_hi",
    "bin_min", "bin_max", "leaf_min", "leaf_max",
    "tri_v", "tri_vidx", "tri_mesh", "tri_prim", "perm",
    "bounds_min", "bounds_max",
]

_PACKED_FIELDS = [
    "nodes", "meta", "tris", "tri_v", "tri_vidx", "tri_mesh", "tri_prim",
    "slot_src", "tri_perm",
]

_INSTANCED_FIELDS = [
    "roots", "instance_blas", "world_from_object", "object_from_world",
    "inst_lo", "inst_hi",
]


def _align(n: int) -> int:
    return (n + ALIGN - 1) // ALIGN * ALIGN


def _save_container(kind: int, arrays: dict, meta_ints,
                    f: BinaryIO) -> int:
    meta = pystruct.pack("<I", len(meta_ints))
    meta += pystruct.pack(f"<{len(meta_ints)}q", *meta_ints)

    header_size = 8 + 2 + 1 + 1 + 4 + 8 + 4 + len(meta)
    sec_entry = 24 + 1 + 1 + 2 + 4 * 4 + 8 + 8
    table_size = sec_entry * len(arrays)
    offset = _align(header_size + table_size)

    entries = []
    for name, a in arrays.items():
        a = np.asarray(a)
        if a.ndim > 4:
            raise ValueError(f"{name}: ndim > 4")
        entries.append((name, a, offset, a.nbytes))
        offset = _align(offset + a.nbytes)
    total = offset

    buf = io.BytesIO()
    buf.write(MAGIC)
    buf.write(pystruct.pack("<HBB", ENDIAN_MARK, 4, kind))  # sizeof_real=4
    buf.write(pystruct.pack("<I", VERSION))
    buf.write(pystruct.pack("<Q", total))
    buf.write(pystruct.pack("<I", len(arrays)))
    buf.write(meta)
    for name, a, off, size in entries:
        if len(name.encode()) > 24:
            raise ValueError(f"section name too long: {name}")
        nb = name.encode().ljust(24, b"\x00")
        shape = list(a.shape) + [0] * (4 - a.ndim)
        buf.write(nb)
        buf.write(pystruct.pack("<BBH", _DTYPE_CODES[a.dtype], a.ndim, 0))
        buf.write(pystruct.pack("<4I", *shape))
        buf.write(pystruct.pack("<QQ", off, size))

    blob = bytearray(total)
    head = buf.getvalue()
    blob[: len(head)] = head
    for name, a, off, size in entries:
        blob[off:off + size] = np.ascontiguousarray(a).tobytes()
    f.write(bytes(blob))
    return total


def _load_container(data: bytes):
    if data[:8] != MAGIC:
        raise ValueError("not an rtk_tpu scene (bad magic)")
    endian, sizeof_real, kind = pystruct.unpack_from("<HBB", data, 8)
    if endian != ENDIAN_MARK:
        raise ValueError("endianness mismatch")
    if sizeof_real != 4:
        raise ValueError(f"unsupported sizeof_real {sizeof_real}")
    (version,) = pystruct.unpack_from("<I", data, 12)
    if version != VERSION:
        raise ValueError(f"unsupported version {version}")
    (total,) = pystruct.unpack_from("<Q", data, 16)
    if total > len(data):
        raise ValueError("truncated scene blob")
    (n_sec,) = pystruct.unpack_from("<I", data, 24)
    (n_meta,) = pystruct.unpack_from("<I", data, 28)
    meta_ints = pystruct.unpack_from(f"<{n_meta}q", data, 32)

    pos = 32 + 8 * n_meta
    arrays = {}
    for _ in range(n_sec):
        name = data[pos:pos + 24].rstrip(b"\x00").decode()
        dtype_code, ndim, _ = pystruct.unpack_from("<BBH", data, pos + 24)
        shape = pystruct.unpack_from("<4I", data, pos + 28)[:ndim]
        off, size = pystruct.unpack_from("<QQ", data, pos + 44)
        dt = _DTYPES[dtype_code]
        arr = np.frombuffer(data, dtype=dt,
                            count=size // np.dtype(dt).itemsize,
                            offset=off).reshape(shape)
        arrays[name] = jnp.asarray(arr)
        pos += 60
    return kind, arrays, meta_ints


def _read(f) -> bytes:
    if isinstance(f, str):
        with open(f, "rb") as fh:
            return fh.read()
    if isinstance(f, (bytes, bytearray, memoryview)):
        return bytes(f)
    return f.read()


def save_scene(scene: Scene, f: Union[str, BinaryIO]) -> int:
    """Serialize a base Scene; returns total bytes written."""
    if isinstance(f, str):
        with open(f, "wb") as fh:
            return save_scene(scene, fh)
    arrays = {name: getattr(scene, name) for name in _FIELDS}
    meta = (scene.num_tris, scene.leaf_size, scene.branching,
            scene.num_leaves, int(scene.has_wide))
    return _save_container(KIND_SCENE, arrays, meta, f)


def _scene_from(arrays, meta_ints, prefix="") -> Scene:
    missing = [n for n in _FIELDS if prefix + n not in arrays]
    if missing:
        raise ValueError(f"scene blob missing sections: {missing}")
    num_tris, leaf_size, branching, num_leaves = meta_ints[:4]
    # 5th int (r5): wide-array presence; pre-r5 blobs lack it (always
    # built wide then).
    has_wide = bool(meta_ints[4]) if len(meta_ints) > 4 else True
    return Scene(
        num_tris=int(num_tris),
        leaf_size=int(leaf_size),
        branching=int(branching),
        num_leaves=int(num_leaves),
        has_wide=has_wide,
        **{n: arrays[prefix + n] for n in _FIELDS},
    )


def load_scene(f: Union[str, bytes, BinaryIO]) -> Scene:
    """Deserialize a Scene, validating magic/endian/version."""
    kind, arrays, meta_ints = _load_container(_read(f))
    if kind != KIND_SCENE:
        raise ValueError(f"blob holds kind {kind}, not a base Scene "
                         "(use load_any)")
    return _scene_from(arrays, meta_ints)


def save_packed_scene(packed, f: Union[str, BinaryIO]) -> int:
    """Serialize a PackedScene (the kernel tables): load-and-trace with no
    repack — the packed blob IS the runtime format, like rtk's
    (rtk.c:1732-1774)."""
    if isinstance(f, str):
        with open(f, "wb") as fh:
            return save_packed_scene(packed, fh)
    from rtk_tpu.trace.packed import W

    arrays = {name: getattr(packed, name) for name in _PACKED_FIELDS}
    # meta slot 2 was kz_tables (a pruned layout experiment); kept as 0 so
    # the on-disk layout is unchanged.  Slot 3 is the node table's wide
    # arity; the kernel reads 8-wide tables only.
    meta = (packed.num_tris, packed.leaf_size, 0, W)
    return _save_container(KIND_PACKED, arrays, meta, f)


def load_packed_scene(f):
    from rtk_tpu.trace.packed import W, PackedScene

    kind, arrays, meta_ints = _load_container(_read(f))
    if kind != KIND_PACKED:
        raise ValueError(f"blob holds kind {kind}, not a PackedScene")
    num_tris, leaf_size = meta_ints[:2]
    if len(meta_ints) > 2 and meta_ints[2]:
        # kz_tables packs (3 stacked rotated tables) no longer match the
        # kernel's layout.  Repack the scene to migrate.
        raise ValueError("blob was saved with kz_tables=True, which is "
                         "no longer supported; re-pack the scene")
    if len(meta_ints) > 3 and meta_ints[3] != W:
        raise ValueError(f"blob holds {meta_ints[3]}-wide node tables; the "
                         f"kernel reads {W}-wide tables; re-pack the scene")
    return PackedScene(
        num_tris=int(num_tris), leaf_size=int(leaf_size),
        **{n: arrays[n] for n in _PACKED_FIELDS})


def save_instanced_scene(iscene, f: Union[str, BinaryIO]) -> int:
    """Serialize an InstancedScene (merged BLAS forest + instance table).
    The nested merged Scene's sections are prefixed "m."."""
    if isinstance(f, str):
        with open(f, "wb") as fh:
            return save_instanced_scene(iscene, fh)
    arrays = {"m." + n: getattr(iscene.merged, n) for n in _FIELDS}
    for n in _INSTANCED_FIELDS:
        arrays[n] = getattr(iscene, n)
    m = iscene.merged
    # merged scenes always carry real wide arrays (merge_blas rejects
    # wide_nodes=False BLAS), so _scene_from's has_wide=True default is
    # correct for the nested load.
    meta = (m.num_tris, m.leaf_size, m.branching, m.num_leaves,
            *iscene.blas_tris)
    return _save_container(KIND_INSTANCED, arrays, meta, f)


def load_instanced_scene(f):
    from rtk_tpu.instancing import InstancedScene

    kind, arrays, meta_ints = _load_container(_read(f))
    if kind != KIND_INSTANCED:
        raise ValueError(f"blob holds kind {kind}, not an InstancedScene")
    merged = _scene_from(arrays, meta_ints[:4], prefix="m.")
    return InstancedScene(
        merged=merged,
        blas_tris=tuple(int(x) for x in meta_ints[4:]),
        **{n: arrays[n] for n in _INSTANCED_FIELDS})


def load_any(f):
    """Load whichever container kind the blob holds."""
    data = _read(f)
    kind, _, _ = _load_container(data)
    if kind == KIND_SCENE:
        return load_scene(data)
    if kind == KIND_PACKED:
        return load_packed_scene(data)
    if kind == KIND_INSTANCED:
        return load_instanced_scene(data)
    raise ValueError(f"unknown container kind {kind}")
