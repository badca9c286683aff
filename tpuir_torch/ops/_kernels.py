"""Build ``tpuir_torch/csrc/*.cu`` with nvcc at first use and bind it with ctypes.

One shared library with a plain C interface, compiled for Hopper
(``sm_90a``) into ``build/tpuir_torch/`` at the repository root and keyed
by a hash of the sources (``*.cu`` and the ``*.cuh`` they include) and
flags, so an edited source is rebuilt and an unchanged one is loaded as it
is. Each ``.cu`` is compiled by its own nvcc process, all started together,
into an object under ``build/tpuir_torch/obj/`` keyed by a hash of that
``.cu``, the headers it includes and the flags, and the objects are linked
into the library; an object whose hash is there already is reused, so a
copy of the package with one edited header (the serving checks' mutation
controls, ``utils/serving_mutants.py``) recompiles only the sources that
include it. No PyTorch headers are compiled, which keeps a cold build to
seconds.

There is no fallback: a missing nvcc, a failed build or a failed load
raises. Wrappers take their kernel's plain PyTorch version only for a
tensor that lies on the CPU, and decide that themselves.

``LAUNCHES`` counts kernel launches by name. A wrapper adds one where it
launches its kernel and nowhere else, so a run can show that its main path
went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List, Optional

_PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "tpuir_torch"
OBJ_DIR = BUILD_DIR / "obj"
# -fno-gnu-unique: a function-local static of a template (a kernel's shared
# memory size set so far, ``tc_gemm.cuh``) stays the library's own, so
# that two builds of the library loaded in one process (the serving
# checks' planted copies, ``utils/serving_mutants.py``) each set their own
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xcompiler", "-fno-gnu-unique", "-Xptxas=-v",
)

LAUNCHES: Dict[str, int] = {
    "fused_transformer_block": 0, "fused_transformer_block_serving": 0, "mixer_prologue": 0,
    "nss_scan": 0, "mixer_epilogue": 0, "mixer_prologue_serving": 0, "nss_scan_serving": 0,
    "mixer_epilogue_serving": 0, "nss_scan_recur_serving": 0, "selective_scan_fused_proj": 0,
    "selective_scan_fused_proj_serving": 0, "nss_scan_fused": 0, "nss_scan_fused_serving": 0,
    "selective_scan": 0, "rate_probe": 0, "tc_gemm": 0,
    "tc_gemm_bf16_operands": 0,
}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
build_log = ""  # nvcc's output (ptxas register and spill report) of the last build


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the CUDA "
        "kernels of tpuir_torch are built from source and have no fallback"
    )


def _sources():
    sources = sorted(CSRC_DIR.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return sources


def includes(src: Path) -> List[Path]:
    """The local headers (``#include "name"``) that src includes, directly
    or through another header, sorted."""
    seen, todo = set(), [src]
    while todo:
        for name in re.findall(r'^\s*#include\s+"([^"]+)"', todo.pop().read_text(), re.M):
            dep = CSRC_DIR / name
            if dep not in seen:
                seen.add(dep)
                todo.append(dep)
    return sorted(seen)


def object_path(src: Path) -> Path:
    """Where src's object goes: keyed by the flags, src and its headers."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [src, *includes(src)]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return OBJ_DIR / f"{src.stem}_{h.hexdigest()[:16]}.o"


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*_sources(), *CSRC_DIR.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libtpuir_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources whose objects are missing and link them, if this
    hash has no library yet; return its path."""
    global build_log
    so = library_path()
    if so.exists():
        return so
    OBJ_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(prefix=f"{so.stem}_", dir=BUILD_DIR) as tmpdir:
        objs = [object_path(src) for src in _sources()]
        todo = [(src, obj, Path(tmpdir) / obj.name) for src, obj in zip(_sources(), objs)
                if not obj.exists()]
        procs = [
            subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(tmp), str(src)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, _, tmp in todo
        ]
        logs = [p.communicate()[0] for p in procs]
        build_log = "".join(logs)
        failed = [src.name for (src, _, _), p in zip(todo, procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
        for _, obj, tmp in todo:
            os.replace(tmp, obj)
        tmp = Path(tmpdir) / so.name
        res = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                             capture_output=True, text=True)
        build_log += res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{build_log}")
        os.replace(tmp, so)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.tpuir_fused_block_f32.argtypes = [vp] * 21 + [ci] * 7 + [vp]
        lib.tpuir_fused_block_f32.restype = ci
        lib.tpuir_fused_block_bf16.argtypes = [vp] * 23 + [ci] * 8 + [vp]
        lib.tpuir_fused_block_bf16.restype = ci
        lib.tpuir_fused_block_bf16_norms_numel.argtypes = [ci] * 4
        lib.tpuir_fused_block_bf16_norms_numel.restype = ctypes.c_longlong
        lib.tpuir_fused_block_partials_numel.argtypes = [ci] * 5
        lib.tpuir_fused_block_partials_numel.restype = ctypes.c_longlong
        lib.tpuir_mixer_prologue_f32.argtypes = [vp] * 7 + [ci] * 5 + [vp]
        lib.tpuir_mixer_prologue_f32.restype = ci
        lib.tpuir_mixer_prologue_bf16.argtypes = [vp] * 8 + [ci] * 5 + [vp]
        lib.tpuir_mixer_prologue_bf16.restype = ci
        lib.tpuir_nss_scan_scratch_numel.argtypes = [ci] * 5
        lib.tpuir_nss_scan_scratch_numel.restype = ctypes.c_longlong
        lib.tpuir_nss_scan_f32.argtypes = [vp] * 10 + [ci] * 5 + [vp]
        lib.tpuir_nss_scan_f32.restype = ci
        lib.tpuir_nss_scan_bf16.argtypes = [vp] * 10 + [ci] * 6 + [vp]
        lib.tpuir_nss_scan_bf16.restype = ci
        lib.tpuir_nss_scan_bf16_scratch_numel.argtypes = [ci] * 6
        lib.tpuir_nss_scan_bf16_scratch_numel.restype = ctypes.c_longlong
        lib.tpuir_nss_scan_bf16_resident_blocks.argtypes = [ci] * 2
        lib.tpuir_nss_scan_bf16_resident_blocks.restype = ci
        lib.tpuir_nss_scan_recur_bf16.argtypes = [vp] * 12 + [ci] * 6 + [vp]
        lib.tpuir_nss_scan_recur_bf16.restype = ci
        lib.tpuir_nss_scan_recur_scratch_numel.argtypes = [ci] * 6
        lib.tpuir_nss_scan_recur_scratch_numel.restype = ctypes.c_longlong
        lib.tpuir_mixer_epilogue_f32.argtypes = [vp] * 9 + [ci] * 4 + [vp]
        lib.tpuir_mixer_epilogue_f32.restype = ci
        lib.tpuir_mixer_epilogue_bf16.argtypes = lib.tpuir_mixer_epilogue_f32.argtypes
        lib.tpuir_mixer_epilogue_bf16.restype = ci
        lib.tpuir_scan_fused_proj_scratch_numel.argtypes = [ci] * 5
        lib.tpuir_scan_fused_proj_scratch_numel.restype = ctypes.c_longlong
        lib.tpuir_scan_fused_proj_f32.argtypes = [vp] * 8 + [ci] * 5 + [vp]
        lib.tpuir_scan_fused_proj_f32.restype = ci
        lib.tpuir_scan_fused_proj_bf16.argtypes = lib.tpuir_scan_fused_proj_f32.argtypes
        lib.tpuir_scan_fused_proj_bf16.restype = ci
        lib.tpuir_nss_scan_fused_f32.argtypes = [vp] * 9 + [ci] * 8 + [vp]
        lib.tpuir_nss_scan_fused_f32.restype = ci
        lib.tpuir_nss_scan_fused_bf16.argtypes = [vp] * 9 + [ci] * 9 + [vp]
        lib.tpuir_nss_scan_fused_bf16.restype = ci
        lib.tpuir_nss_scan_fused_bf16_resident_blocks.argtypes = [ci] * 2
        lib.tpuir_nss_scan_fused_bf16_resident_blocks.restype = ci
        lib.tpuir_selective_scan_scratch_numel.argtypes = [ci] * 5
        lib.tpuir_selective_scan_scratch_numel.restype = ctypes.c_longlong
        lib.tpuir_selective_scan_f32.argtypes = [vp] * 9 + [ci] * 5 + [vp]
        lib.tpuir_selective_scan_f32.restype = ci
        lib.tpuir_rate_probe_f32.argtypes = [vp, vp, ctypes.c_longlong, ci, ci, vp]
        lib.tpuir_rate_probe_f32.restype = ci
        ll = ctypes.c_longlong
        lib.tpuir_tc_gemm_f32.argtypes = ([vp, ll, ci, vp, ll, vp, vp, ci, vp, vp, vp]
                                          + [ci] * 5 + [vp])
        lib.tpuir_tc_gemm_f32.restype = ci
        lib.tpuir_tc_gemm_bf16_operands.argtypes = [vp, ll, ci, vp, ll, vp, vp] + [ci] * 5 + [vp]
        lib.tpuir_tc_gemm_bf16_operands.restype = ci
        lib.tpuir_cuda_error_string.argtypes = [ci]
        lib.tpuir_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        msg = library().tpuir_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
