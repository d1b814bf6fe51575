"""Cooperative, host-driven build task system (parity layer).

The reference never creates threads: rtk_start_build hands the host a first
task, the host calls rtk_run_task from as many threads as it likes, each run
may push follow-up tasks into a caller-provided queue, and phase transitions
ride an atomic counter (rtk.h:108-115; rtk.c:679-710, 1692-1717).

The accelerated build is a single fused device program (scene.py), so
the task system's job shifts to what still benefits from host parallelism:
per-mesh decode (strides/dtypes/callbacks — CPU-bound, one task per mesh),
soup assembly, device upload + build dispatch, and kernel-table packing.
The lifecycle and scheduling contract are preserved:

    build, first = start_build(desc)          # rtk_start_build
    # host threads, each with its own queue:
    n = run_task(task, queue)                  # rtk_run_task -> #spawned
    size = get_build_size(build)               # rtk_get_build_size
    scene = finish_build(build)                # rtk_finish_build
    blob = finish_build_to(build, buffer)      # rtk_finish_build_to

Tasks carry a `cost` hint for the host scheduler exactly like rtk_task.cost
(rtk.h:112; rtk.c:1664-1667 derives it from per-item constants).
"""
from __future__ import annotations

import dataclasses
import io
import threading
from typing import Callable, List, Optional, Sequence

import numpy as np

from rtk_tpu.config import BuildConfig
from rtk_tpu.mesh import MeshDesc, TriangleSoup, as_mesh_desc, decode_indices, decode_positions
from rtk_tpu.scene import Scene, build_from_soup
from rtk_tpu.utils.stats import BuildLogger

# Cost-model constants (per item), in the spirit of rtk.c:1664-1667.
COST_DECODE_PER_TRI = 1.0
COST_UPLOAD_PER_TRI = 0.25
COST_BUILD_PER_TRI = 0.5


@dataclasses.dataclass
class Task:
    """Parity: rtk_task (rtk.h:109-115)."""

    build: "Build"
    fn: Callable[["Task", List["Task"]], None]
    index: int = 0
    arg: object = None
    cost: float = 0.0


class Build:
    """Parity: rtk_build — all in-flight state of one scene build."""

    def __init__(self, meshes: Sequence[MeshDesc], config: BuildConfig,
                 log_fn=None, log_user=None):
        self.meshes = [as_mesh_desc(m) for m in meshes]
        self.config = config
        self.logger = BuildLogger(log_fn, log_user, build=self)
        self._decoded: List[Optional[tuple]] = [None] * len(self.meshes)
        self._lock = threading.Lock()
        self._pending = 0  # analogue of a_tasks_left (rtk.c:1703-1714)
        self._phase = "decode"
        self.soup: Optional[TriangleSoup] = None
        self.scene: Optional[Scene] = None

    # -- internal phase barrier (the lock stands in for rtk's atomics) --
    def _task_started(self, n: int):
        with self._lock:
            self._pending += n

    def _task_done(self) -> bool:
        """Returns True when this completion drains the phase."""
        with self._lock:
            self._pending -= 1
            return self._pending == 0


def _decode_task(task: Task, queue: List[Task]):
    build: Build = task.build
    m = build.meshes[task.index]
    idx = decode_indices(m)
    pos = decode_positions(m, idx)
    build._decoded[task.index] = (pos, idx)
    build.logger.log(f"decoded mesh {task.index}: {m.num_triangles} tris")
    if build._task_done():
        build._phase = "assemble"
        queue.append(Task(build, _assemble_task,
                          cost=COST_UPLOAD_PER_TRI * _total_tris(build)))
        build._task_started(1)


def _total_tris(build: Build) -> int:
    return sum(m.num_triangles for m in build.meshes)


def _assemble_task(task: Task, queue: List[Task]):
    build: Build = task.build
    pos, vidx, mids, prims = [], [], [], []
    for mi, (p, idx) in enumerate(build._decoded):
        t = p.shape[0]
        pos.append(p)
        vidx.append(idx.astype(np.int32))
        mids.append(np.full((t,), mi, np.int32))
        prims.append(np.arange(t, dtype=np.int32))
    build.soup = TriangleSoup(
        tri_pos=np.concatenate(pos),
        tri_vidx=np.concatenate(vidx),
        tri_mesh=np.concatenate(mids),
        tri_prim=np.concatenate(prims),
    )
    build.logger.log(f"assembled soup: {build.soup.num_triangles} tris")
    if build._task_done():
        build._phase = "device_build"
        queue.append(Task(build, _device_build_task,
                          cost=COST_BUILD_PER_TRI * _total_tris(build)))
        build._task_started(1)


def _device_build_task(task: Task, queue: List[Task]):
    build: Build = task.build
    s = build.soup
    build.scene = build_from_soup(
        s.tri_pos, s.tri_vidx, s.tri_mesh, s.tri_prim, build.config)
    build.logger.log(
        f"device build dispatched: {build.scene.num_leaves} leaves")
    if build._task_done():
        build._phase = "done"


def start_build(meshes, config: BuildConfig = BuildConfig(),
                log_fn=None, log_user=None):
    """Parity: rtk_start_build (rtk.c:1625).  Returns (build, first_tasks).

    The host owns scheduling: run the returned tasks (and everything they
    push) from any number of threads, each with its own queue list.
    """
    if isinstance(meshes, (MeshDesc, tuple)):
        meshes = [meshes]
    build = Build(meshes, config, log_fn, log_user)
    build.logger.log(f"start_build: {len(build.meshes)} meshes")
    tasks = [
        Task(build, _decode_task, index=i,
             cost=COST_DECODE_PER_TRI * m.num_triangles)
        for i, m in enumerate(build.meshes)
    ]
    build._task_started(len(tasks))
    return build, tasks


def run_task(task: Task, queue: List[Task]) -> int:
    """Parity: rtk_run_task (rtk.c:1692) — executes the task, appends any
    spawned tasks to `queue`, returns how many were spawned."""
    before = len(queue)
    task.fn(task, queue)
    return len(queue) - before


def get_build_size(build: Build) -> int:
    """Parity: rtk_get_build_size (rtk.c:1719) — serialized scene size."""
    if build.scene is None:
        raise RuntimeError("build not finished; run all tasks first")
    from rtk_tpu.utils.serialize import save_scene

    buf = io.BytesIO()
    return save_scene(build.scene, buf)


def finish_build(build: Build) -> Scene:
    """Parity: rtk_finish_build (rtk.c:1776)."""
    if build._phase != "done" or build.scene is None:
        raise RuntimeError("build tasks not drained")
    return build.scene


def finish_build_to(build: Build, buffer) -> int:
    """Parity: rtk_finish_build_to (rtk.c:1732) — serialize into a
    caller-provided writable buffer/file object; returns bytes written."""
    from rtk_tpu.utils.serialize import save_scene

    return save_scene(finish_build(build), buffer)


def build_scene_tasks(meshes, config: BuildConfig = BuildConfig(),
                      num_threads: int = 1, log_fn=None) -> Scene:
    """Parity: rtk_build_scene (rtk.c:1788) — one-shot convenience that
    drains the task graph, optionally with a host thread pool."""
    build, tasks = start_build(meshes, config, log_fn=log_fn)
    if num_threads <= 1:
        queue = list(tasks)
        while queue:
            run_task(queue.pop(), queue)
    else:
        import concurrent.futures as cf

        lock = threading.Lock()
        shared: List[Task] = list(tasks)

        def worker():
            local: List[Task] = []
            while True:
                with lock:
                    if not shared:
                        return
                    t = shared.pop()
                run_task(t, local)
                with lock:
                    shared.extend(local)
                local.clear()

        # Workers may drain before followers are pushed; loop until done.
        while build._phase != "done":
            with cf.ThreadPoolExecutor(num_threads) as ex:
                for _ in range(num_threads):
                    ex.submit(worker)
    return finish_build(build)
