"""Build and load the port's hand-written CUDA kernels.

Sources live in ``csrc/`` (one shared library per ``*.cu``). They are
compiled with ``nvcc -gencode arch=compute_90a,code=sm_90a -shared`` into a
plain-C shared library and loaded with :mod:`ctypes` (every pointer typed
``c_void_p``). The build runs at first use, or all at once through
:func:`build` (one ``nvcc`` per source, started together), into
``kernels/build/<hash of the sources>/``, which ``.gitignore`` lists.
Importing this module never needs a compiler.

``--fmad=false`` keeps the kernels' float arithmetic in the order the
source writes it, so the lattice math matches the plain PyTorch versions
bit for bit (a fused multiply-add would round differently and can flip a
point's simplex).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "build"
LIBRARIES = ("permuto_encoding", "occupancy_grid", "volume_rendering", "sphere_trace",
             "compaction", "importance_sampling", "marching_tets", "ray_sampler")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
_L = ctypes.c_longlong
MAX_ROW_ARRAYS = 12


class RowArrays(ctypes.Structure):
    """The arrays kernels H1 and H2 move, passed by value (``RowArrays`` in
    ``csrc/compaction.cu``)."""

    _fields_ = [("src", _P * MAX_ROW_ARRAYS), ("dst", _P * MAX_ROW_ARRAYS),
                ("row_bytes", _L * MAX_ROW_ARRAYS), ("fill", _U * MAX_ROW_ARRAYS),
                ("chunk", _I * MAX_ROW_ARRAYS), ("first_chunk", _I * MAX_ROW_ARRAYS),
                ("row_chunks", _I), ("count", _I)]


# The C signature of each library's exported launch functions; each returns
# a cudaError_t as an int.
SIGNATURES = {
    "permuto_encoding": {
        "psdf_encode_fwd": [_I, _P, _I, _P, _I, _P, _P, _P, _P, _I, _F, _I, _P, _I, _P],
        "psdf_encode_point_grad": [_I, _P, _I, _P, _I, _P, _P, _P, _P, _I, _F, _I, _P,
                                   _I, _P, _P],
        "psdf_encode_table_grad": [_I, _P, _I, _I, _P, _P, _P, _P, _I, _P, _I, _I, _I,
                                   _P, _P],
        "psdf_encode_double_backward": [_I, _P, _I, _P, _I, _P, _P, _P, _P, _I, _F, _I,
                                        _P, _I, _P, _I, _I, _P, _P, _P],
    },
    "occupancy_grid": {
        "psdf_probe_sampler": [_I] + [_P] * 6 + [_I] + [_F] * 6 + [_I, _I] + [_P] * 5,
        "psdf_grid_points": [_I, _U, _I] + [_F] * 5 + [_P] * 4,
        "psdf_grid_update": [_I, _P, _P] + [_F] * 3 + [_P] * 3,
        "psdf_first_occupied": [_I] + [_P] * 6 + [_I] + [_F] * 5 + [_I] + [_P] * 3,
        "psdf_density_update": [_I, _P, _P, _F, _F] + [_P] * 3,
        "psdf_grid_refresh": [_I, _U, _I] + [_F] * 5 + [_P] * 2 + [_F] * 3 + [_P] * 3,
    },
    "volume_rendering": {
        "psdf_render_weights": [_I] * 3 + [_P] * 6 + [_F] * 2 + [_P] * 6,
        "psdf_render_weights_bwd": [_I] * 3 + [_P] * 6 + [_F] * 2 + [_P] * 9,
        "psdf_train_lod_select": [_I] * 4 + [_P] * 4 + [_F] * 2 + [_P] * 3,
        "psdf_render_mixed": [_I] * 3 + [_P] * 9 + [_F] * 2 + [_P] * 6,
        "psdf_render_mixed_bwd": [_I] * 3 + [_P] * 9 + [_F] * 2 + [_P] * 9,
    },
    "sphere_trace": {
        "psdf_chebyshev_field": [_I, _I] + [_P] * 4,
        "psdf_jump_prepass": [_I, _I, _I, _P, _I] + [_F] * 5 + [_I] + [_P] * 5 + [_I]
                             + [_P] * 4,
        "psdf_trace_step": [_I, _I] + [_P] * 10 + [_I] + [_F] * 5 + [_I] + [_F] * 3
                           + [_I] + [_P] * 3,
        "psdf_trace_step_pos": [_I, _I] + [_P] * 8 + [_I] + [_F] * 5 + [_I] + [_F] * 7
                               + [_P] * 2,
        "psdf_trace_loop_pos": [_I, _I] + [_P] * 8 + [_I] + [_F] * 5
                               + [_I, _I] + [_F] * 7 + [_P],
        "psdf_trace_round": [_I, _I] + [_P] * 10 + [_I] + [_F] * 5
                            + [_I, _I] + [_F] * 3 + [_I] + [_P] * 2,
    },
    "compaction": {
        "psdf_compact": [_I, _P, _P, _I, _I, _L] + [_P] * 4,
        "psdf_take_rows": [RowArrays, _P, _I, _L, _P],
        "psdf_scatter_rows": [RowArrays, _P, _I, _L, _P],
    },
    "importance_sampling": {
        "psdf_importance_round": [_I] * 3 + [_P] * 6 + [_F] + [_P] * 3,
        "psdf_merge_samples": [_I] * 4 + [_P] * 9 + [_F, _I] + [_P] * 7,
    },
    "marching_tets": {
        "psdf_mt_count": [_P, _I, _I, _I, _F] + [_P] * 4,
        "psdf_mt_emit": [_P, _I, _I, _I, _F] + [_P] * 5 + [_F] * 6 + [_P] * 4 + [_L]
                        + [_P] * 3,
    },
    "ray_sampler": {
        "psdf_samples_fg": [_I, _I, _P, _P, _P] + [_F] * 5 + [_P] * 8,
    },
}

_loaded: dict = {}


def source_hash() -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / source_hash()


def library_path(name: str) -> Path:
    return build_dir() / f"lib{name}.so"


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.isfile(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built at first "
                           "use and need the CUDA toolkit")
    return nvcc


def build(names=LIBRARIES) -> dict:
    """Compile the named libraries that are not built yet, all in parallel.
    Returns {name: seconds} for what was compiled; the compiler's output
    (registers, spills) is kept in ``<build dir>/lib<name>.log``."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not library_path(n).is_file()]
    if not todo:
        return {}
    nvcc = find_nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        tmp = out_dir / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    seconds, failures = {}, []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        (out_dir / f"lib{name}.log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"--- {name} (exit {proc.returncode}) ---\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(name))
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return seconds


def build_log(name: str) -> str:
    path = build_dir() / f"lib{name}.log"
    return path.read_text() if path.is_file() else ""


def declare(lib: ctypes.CDLL, name: str) -> ctypes.CDLL:
    """Set the argument and result types of library ``name``'s exports."""
    lib.psdf_error_string.argtypes = [ctypes.c_int]
    lib.psdf_error_string.restype = ctypes.c_char_p
    for fn_name, argtypes in SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if needed)."""
    lib = _loaded.get(name)
    if lib is None:
        if not library_path(name).is_file():
            build([name])
        lib = _loaded[name] = declare(ctypes.CDLL(str(library_path(name))), name)
    return lib


def check(lib: ctypes.CDLL, err: int, what: str):
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = lib.psdf_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({err}: {msg})")


def dispatch(device, cuda_fn, plain_fn):
    """The kernel's wrapper for tensors on the card, its plain version for
    tensors on the CPU; any other device raises."""
    device = torch.device(device)
    if device.type == "cuda":
        return cuda_fn
    if device.type == "cpu":
        return plain_fn
    raise ValueError(f"unsupported device {device}: kernels run on cuda, plain versions on cpu")


def current_stream(device) -> ctypes.c_void_p:
    """The raw handle of ``device``'s current CUDA stream. Read through
    ``torch._C._cuda_getCurrentRawStream`` (as PyTorch's own generated
    kernels read it): ``torch.cuda.current_stream`` builds a Stream object
    per call, ~12 us of host time on an H100 host against ~0.2."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(index))


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t is not None else None)
