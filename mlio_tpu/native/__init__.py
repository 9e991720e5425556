"""Native (C++) host runtime: block allocator + continuous-batching scheduler.

The device step is one jitted dispatch, so between decode steps the
host does the serving-critical bookkeeping — block accounting, table
assembly, token commit, finish/preemption decisions. The reference keeps all
of this in Python object graphs (/root/reference/baseline/inference.py:
1045-1302); here it is a C++17 library (`src/mlio_runtime.cc`) driven through
ctypes, one C call per engine step, with the per-slot device-mirror arrays
(block tables, context lengths, current tokens) exposed as zero-copy numpy
views.

Build model: `g++ -O2 -shared -fPIC` on first use, cached next to the
sources; everything degrades cleanly to the pure-Python scheduler
(mlio_tpu.runtime.scheduler.PyScheduler) when no toolchain is available.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from typing import List, Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "src", "mlio_runtime.cc")
_SO = os.path.join(_HERE, "_mlio_runtime.so")

_lib: Optional[ctypes.CDLL] = None
_load_error: Optional[str] = None


def _build() -> bool:
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
    if cxx is None:
        return False
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_HERE)
    os.close(fd)
    try:
        subprocess.run(
            [cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-o", tmp, _SRC],
            check=True, capture_output=True, text=True, timeout=120)
        os.replace(tmp, _SO)  # atomic: concurrent builders race safely
        return True
    except (subprocess.SubprocessError, OSError):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32p = ctypes.POINTER(ctypes.c_int32)
    sigs = {
        "mlio_bm_create": ([ctypes.c_int, ctypes.c_int], ctypes.c_void_p),
        "mlio_bm_destroy": ([ctypes.c_void_p], None),
        "mlio_bm_num_free": ([ctypes.c_void_p], ctypes.c_int),
        "mlio_bm_allocate": ([ctypes.c_void_p], ctypes.c_int),
        "mlio_bm_fork": ([ctypes.c_void_p, ctypes.c_int], ctypes.c_int),
        "mlio_bm_free": ([ctypes.c_void_p, ctypes.c_int], ctypes.c_int),
        "mlio_bm_refcount": ([ctypes.c_void_p, ctypes.c_int], ctypes.c_int),
        "mlio_sched_create": ([ctypes.c_int] * 5, ctypes.c_void_p),
        "mlio_sched_destroy": ([ctypes.c_void_p], None),
        "mlio_sched_submit": ([ctypes.c_void_p, i32p, ctypes.c_int,
                               ctypes.c_int, ctypes.c_int32],
                              ctypes.c_longlong),
        "mlio_sched_admit": ([ctypes.c_void_p], ctypes.c_int),
        "mlio_sched_admitted": ([ctypes.c_void_p], i32p),
        "mlio_sched_slot_prompt": ([ctypes.c_void_p, ctypes.c_int, i32p,
                                    ctypes.c_int, i32p], ctypes.c_int),
        "mlio_sched_slot_req_id": ([ctypes.c_void_p, ctypes.c_int],
                                   ctypes.c_longlong),
        "mlio_sched_commit_prefill": ([ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_int32], ctypes.c_int),
        "mlio_sched_commit_prefill_pending": ([ctypes.c_void_p,
                                               ctypes.c_int], ctypes.c_int),
        "mlio_sched_resolve_prefill": ([ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_int32], ctypes.c_int),
        "mlio_sched_commit_tokens": ([ctypes.c_void_p, i32p], ctypes.c_int),
        "mlio_sched_plan_multi_step": ([ctypes.c_void_p, ctypes.c_int],
                                       ctypes.c_int),
        "mlio_sched_plan_multi_step_r": ([ctypes.c_void_p, ctypes.c_int,
                                          ctypes.c_int], ctypes.c_int),
        "mlio_sched_tables": ([ctypes.c_void_p], i32p),
        "mlio_sched_ctx": ([ctypes.c_void_p], i32p),
        "mlio_sched_cur": ([ctypes.c_void_p], i32p),
        "mlio_sched_num_active": ([ctypes.c_void_p], ctypes.c_int),
        "mlio_sched_num_queued": ([ctypes.c_void_p], ctypes.c_int),
        "mlio_sched_num_finished": ([ctypes.c_void_p], ctypes.c_int),
        "mlio_sched_num_free_blocks": ([ctypes.c_void_p], ctypes.c_int),
        "mlio_sched_pop_finished": ([ctypes.c_void_p, i32p, ctypes.c_int,
                                     i32p], ctypes.c_longlong),
        "mlio_sched_stats": ([ctypes.c_void_p,
                              ctypes.POINTER(ctypes.c_longlong)], None),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def load_library(rebuild: bool = False) -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native runtime; None if unavailable."""
    global _lib, _load_error
    if _lib is not None and not rebuild:
        return _lib
    if rebuild or not os.path.exists(_SO) or (
            os.path.exists(_SRC)
            and os.path.getmtime(_SRC) > os.path.getmtime(_SO)):
        if not _build() and not os.path.exists(_SO):
            _load_error = "no C++ toolchain and no prebuilt _mlio_runtime.so"
            return None
    try:
        _lib = _bind(ctypes.CDLL(_SO))
        _load_error = None
    except OSError as e:
        _load_error = str(e)
        _lib = None
    return _lib


def available() -> bool:
    return load_library() is not None


def load_error() -> Optional[str]:
    load_library()
    return _load_error


def _as_i32(arr) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(arr, dtype=np.int32))


def _i32p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


class NativeBlockManager:
    """ctypes facade over the C++ block allocator — drop-in for
    mlio_tpu.runtime.kv_cache.BlockManager (block 0 = pinned scratch)."""

    def __init__(self, num_blocks: int, block_size: int):
        lib = load_library()
        if lib is None:
            raise RuntimeError(f"native runtime unavailable: {_load_error}")
        self._lib = lib
        self._h = lib.mlio_bm_create(num_blocks, block_size)
        self.num_blocks = num_blocks
        self.block_size = block_size

    @property
    def num_free(self) -> int:
        return self._lib.mlio_bm_num_free(self._h)

    def allocate(self) -> int:
        b = self._lib.mlio_bm_allocate(self._h)
        if b < 0:
            raise MemoryError("out of KV-cache blocks")
        return b

    def fork(self, block: int) -> int:
        b = self._lib.mlio_bm_fork(self._h, block)
        if b < 0:
            raise ValueError(f"fork of dead block {block}")
        return b

    def free(self, block: int) -> None:
        if self._lib.mlio_bm_free(self._h, block) < 0:
            raise ValueError(f"double free of block {block}")

    def refcount(self, block: int) -> int:
        return self._lib.mlio_bm_refcount(self._h, block)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.mlio_bm_destroy(self._h)
            self._h = None


class NativeScheduler:
    """ctypes facade over the C++ continuous-batching scheduler.

    Same interface as runtime.scheduler.PyScheduler; `tables`/`ctx`/`cur`
    are zero-copy views into C++ memory, valid for the scheduler's lifetime.
    """

    name = "native"

    def __init__(self, max_batch: int, num_blocks: int, block_size: int,
                 max_blocks_per_seq: int, prefix_caching: bool = True):
        lib = load_library()
        if lib is None:
            raise RuntimeError(f"native runtime unavailable: {_load_error}")
        self._lib = lib
        self._h = lib.mlio_sched_create(max_batch, num_blocks, block_size,
                                        max_blocks_per_seq,
                                        1 if prefix_caching else 0)
        if not self._h:
            raise ValueError("invalid scheduler parameters")
        self.max_batch = max_batch
        self.block_size = block_size
        self.max_blocks_per_seq = max_blocks_per_seq
        n = max_batch * max_blocks_per_seq
        self.tables = np.ctypeslib.as_array(
            lib.mlio_sched_tables(self._h), (n,)).reshape(
                max_batch, max_blocks_per_seq)
        self.ctx = np.ctypeslib.as_array(lib.mlio_sched_ctx(self._h),
                                         (max_batch,))
        self.cur = np.ctypeslib.as_array(lib.mlio_sched_cur(self._h),
                                         (max_batch,))
        self._scratch = np.empty(max_blocks_per_seq * block_size
                                 + 4096, np.int32)

    def submit(self, prompt, max_new_tokens: int,
               eos_token: Optional[int] = None) -> int:
        p = _as_i32(prompt)
        rid = self._lib.mlio_sched_submit(
            self._h, _i32p(p), len(p), max_new_tokens,
            -1 if eos_token is None else eos_token)
        if rid < 0:
            raise ValueError("bad request (empty prompt or max_new_tokens<1)")
        return int(rid)

    def admit(self) -> List[Tuple[int, List[int], int]]:
        """Admit queued requests; returns [(slot, prompt, num_cached), ...]
        for slots that now need a prefill."""
        n = self._lib.mlio_sched_admit(self._h)
        if n < 0:
            raise ValueError("request longer than max_blocks_per_seq allows")
        if n == 0:
            return []
        slots = np.ctypeslib.as_array(
            self._lib.mlio_sched_admitted(self._h), (n,))
        out = []
        cached = np.zeros(1, np.int32)
        for s in slots.tolist():
            ln = self._lib.mlio_sched_slot_prompt(
                self._h, s, _i32p(self._scratch), len(self._scratch),
                _i32p(cached))
            out.append((s, self._scratch[:ln].tolist(), int(cached[0])))
        return out

    def slot_req_id(self, slot: int) -> int:
        return int(self._lib.mlio_sched_slot_req_id(self._h, slot))

    def commit_prefill(self, slot: int, token: int) -> None:
        if self._lib.mlio_sched_commit_prefill(self._h, slot, token) < 0:
            raise ValueError(f"slot {slot} not active")

    def commit_prefill_pending(self, slot: int) -> None:
        if self._lib.mlio_sched_commit_prefill_pending(self._h, slot) < 0:
            raise ValueError(f"slot {slot} not active")

    def resolve_prefill(self, slot: int, token: int) -> None:
        if self._lib.mlio_sched_resolve_prefill(self._h, slot, token) < 0:
            raise ValueError(f"slot {slot} not active")

    def commit_tokens(self, tokens) -> int:
        t = _as_i32(tokens)
        assert len(t) == self.max_batch
        return self._lib.mlio_sched_commit_tokens(self._h, _i32p(t))

    def plan_multi_step(self, k_max: int, reserve: int = 0) -> int:
        """Multi-step scheduling plan (see the C++ twin): preallocates the
        chunk's KV blocks and returns the feasible k <= k_max. ``reserve``
        covers positions already dispatched but not yet committed (the
        engine's pipelined mode)."""
        return self._lib.mlio_sched_plan_multi_step_r(self._h, int(k_max),
                                                      int(reserve))

    def commit_tokens_multi(self, tokens_steps) -> int:
        done = 0
        for row in np.asarray(tokens_steps, np.int32):
            done += self.commit_tokens(row)
        return done

    @property
    def num_active(self) -> int:
        return self._lib.mlio_sched_num_active(self._h)

    @property
    def num_queued(self) -> int:
        return self._lib.mlio_sched_num_queued(self._h)

    @property
    def num_finished(self) -> int:
        return self._lib.mlio_sched_num_finished(self._h)

    @property
    def num_free_blocks(self) -> int:
        return self._lib.mlio_sched_num_free_blocks(self._h)

    def pop_finished(self) -> Optional[Tuple[int, List[int]]]:
        n = np.zeros(1, np.int32)
        rid = self._lib.mlio_sched_pop_finished(
            self._h, _i32p(self._scratch), len(self._scratch), _i32p(n))
        if rid < 0:
            return None
        return int(rid), self._scratch[: int(n[0])].tolist()

    def stats(self) -> dict:
        out = (ctypes.c_longlong * 4)()
        self._lib.mlio_sched_stats(self._h, out)
        return {"preempted": out[0], "prefills": out[1],
                "generated_tokens": out[2], "prefix_hit_blocks": out[3]}

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.mlio_sched_destroy(self._h)
            self._h = None
