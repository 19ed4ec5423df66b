"""Build the CUDA kernels under `csrc/` with nvcc and load them with ctypes.

Every `csrc/*.cu` is compiled for Hopper (`sm_90a`) by its own nvcc
process, all started together, and the objects are linked into one shared
library under ``build/paddle_tpu_torch/<source-hash>/`` at the repository
root. The hash covers the sources and the flags, so an edited kernel gets
a fresh directory and an unchanged one is built once. The C entry points
take raw pointers, sizes and the CUDA stream, and return
``cudaGetLastError()``; `check` turns a non-zero code into an exception.

Nothing here runs at import time: `library()` builds on first call.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
_BUILD_ROOT = _PKG.parent / "build" / "paddle_tpu_torch"
_LIB_NAME = "libpaddle_tpu_torch.so"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMMON_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint32
_L = ctypes.c_int64

# argtypes of every kernel entry point; each returns cudaGetLastError()
SIGNATURES = {
    "ptt_quantized_matmul": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # (q, k, v, table, lens, active, out, b, h, h_kv, d, p, n_pages,
    # max_pages, scale, dtype, stages, device, stream)
    "ptt_paged_attention": [_P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P],
    # (q, k, v, o, lse, mask and its four strides, b, s, h, d, s_true,
    # causal, scale, dtype, dropout, seed, thresh, inv_keep, device, stream)
    "ptt_flash_attention_fwd": [_P, _P, _P, _P, _P, _P, _L, _L, _L, _L,
                                _I, _I, _I, _I, _I, _I, _F, _I, _I, _U, _U,
                                _F, _I, _P],
    # (q, k, v, o, lse, mask and its four strides, b, s, h, d, s_true,
    # causal, scale, dropout, seed, thresh, inv_keep, device, stream): the
    # bf16 build on wgmma and TMA
    "ptt_flash_attention_fwd_tc": [_P, _P, _P, _P, _P, _P, _L, _L, _L, _L,
                                   _I, _I, _I, _I, _I, _I, _F, _I, _U, _U,
                                   _F, _I, _P],
    # (q, k, v, table, ctx, starts, active, out, b, tq, h, h_kv, d, p,
    # n_pages, max_pages, scale, dtype, stages, device, stream)
    "ptt_ragged_paged_attention": [_P, _P, _P, _P, _P, _P, _P, _P,
                                   _I, _I, _I, _I, _I, _I, _I, _I, _F, _I,
                                   _I, _I, _P],
    # (q, k, v, table, ctx, starts, active, out, b, tq, h, h_kv, d, p,
    # n_pages, max_pages, scale, device, stream): the bf16 tensor-core build
    "ptt_ragged_paged_attention_tc": [_P, _P, _P, _P, _P, _P, _P, _P,
                                      _I, _I, _I, _I, _I, _I, _I, _I, _F,
                                      _I, _P],
    "ptt_rms_norm_fwd": [_P, _P, _P, _I, _I, _F, _I, _I, _I, _P],
    "ptt_flash_attention_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                _P, _L, _L, _L, _L,
                                _I, _I, _I, _I, _I, _I, _F, _I, _I, _U, _U,
                                _F, _I, _P],
    # (q, k, v, dout, lse, delta, dq, dk, dv, mask and its four strides, b,
    # s, h, d, s_true, causal, scale, dropout, seed, thresh, inv_keep,
    # device, stream): the bf16 tensor-core build, no dQ partial buffer
    "ptt_flash_attention_bwd_tc": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                   _P, _L, _L, _L, _L,
                                   _I, _I, _I, _I, _I, _I, _F, _I, _U, _U,
                                   _F, _I, _P],
    # (args struct, dtype, weight kind, device, stream, grid out)
    "ptt_decode_megakernel": [_P, _I, _I, _I, _P, _P],
    # (args struct, segment, weight kind, device, stream, grid out)
    "ptt_decode_megakernel_seg": [_P, _I, _I, _I, _P, _P],
}

_lock = threading.Lock()
_lib = None
_build_info = {}


def _nvcc():
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels of paddle_tpu_torch cannot be built")
    return found


def sources():
    return sorted(_CSRC.glob("*.cu"))


def source_hash():
    h = hashlib.sha256()
    for f in sources() + sorted(_CSRC.glob("*.cuh")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(ARCH_FLAGS + COMMON_FLAGS).encode())
    return h.hexdigest()[:16]


def build():
    """Compile every source in parallel and link the shared library.
    Returns its path; raises RuntimeError with nvcc's output on failure."""
    out_dir = _BUILD_ROOT / source_hash()
    lib_path = out_dir / _LIB_NAME
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tmp = Path(tempfile.mkdtemp(prefix="obj-", dir=out_dir))
    try:
        procs = []
        for src in sources():
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *ARCH_FLAGS, *COMMON_FLAGS, "-Xptxas", "-v",
                   "-I", str(_CSRC), "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, _, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {src.name} (rc {p.returncode})\n{out}")
            if p.returncode != 0:
                failed.append(src.name)
        log = "\n".join(logs)
        (out_dir / "build.log").write_text(log)
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{log}")
        tmp_lib = tmp / _LIB_NAME
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
             *[str(o) for _, o, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib_path)   # atomic: a reader sees all or none
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib_path


def library():
    """The loaded kernel library (built on first call, then cached)."""
    global _lib
    with _lock:
        if _lib is None:
            import time
            t0 = time.perf_counter()
            path = build()
            lib = ctypes.CDLL(str(path))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.ptt_error_string.argtypes = [ctypes.c_int]
            lib.ptt_error_string.restype = ctypes.c_char_p
            _build_info.update(path=str(path),
                               seconds=time.perf_counter() - t0)
            _lib = lib
        return _lib


def build_log():
    """nvcc's output (registers, shared memory, spills per kernel) of the
    current build, or None before `build()` ran."""
    log = _BUILD_ROOT / source_hash() / "build.log"
    return log.read_text() if log.exists() else None


def build_info():
    """{"path", "seconds"} of the loaded library (empty before loading)."""
    return dict(_build_info)


def check(code, name):
    """Raise if a C entry point reported a CUDA error (launch refused,
    bad configuration, or a fault from an earlier asynchronous launch)."""
    if code != 0:
        msg = library().ptt_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")


def aligned16(t):
    """t, or a copy of it when its data does not start on 16 bytes (the
    tensor-core builds copy rows in 16-byte pieces)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def stream_ptr(device):
    """The current CUDA stream of `device` (a torch.device with an index), as
    a pointer. Read through torch's raw-stream getter, the one its own
    generated kernels use: `torch.cuda.current_stream(device)` builds a
    Stream object on every call, several microseconds of a launch's host
    time."""
    import torch
    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(device.index))
