"""Build the port's CUDA kernels at first use and bind them with ctypes.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process (all started
together) for ``sm_90a`` into an object file, and the objects are linked into
one shared library with a plain C interface. The library lands in
``build/repro_torch_kernels/<hash of sources and flags>/`` at the root of the
checkout (git-ignored), so a later process with the same sources loads it
without compiling. Each source's compile time and ``ptxas -v`` output
(registers, shared memory, spills) are kept beside it in ``build.log``.
The sources include only the CUDA toolkit's headers (no CUTLASS or CuTe),
and the tensor maps' encoder is taken from the driver at run time, so the
library links against nothing but the CUDA runtime.

Nothing here runs at import: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "librepro_torch_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_int64
_D = ctypes.c_double
#: argument types of each exported C function (all return a cudaError_t)
SIGNATURES = {
    "repro_rmsnorm": [_P, _P, _P, _I, _I, _F, _I, _I, _I, _I, _I, _P],
    "repro_empty_kernel": [_P],
    "repro_flash_attention_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                  _F, _I, _I, _P],
    "repro_flash_attention_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                   _F, _I, _I, _P],
    "repro_flash_attention_bf16_lse": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                       _F, _I, _I, _P, _P],
    "repro_flash_attention_bwd": [_P] * 11 + [_I] * 6 + [_F, _I, _I, _P],
    "repro_decode_attention": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _I, _I, _I, _F, _I, _P],
    "repro_cap_bucket_scan": [_P, _P, _P, _L, _L, _L, _L, _L, _L, _L, _I, _I, _I, _I,
                              _I, _I, _P],
    "repro_downscale_replay": [_P, _P, _P, _P, _P, _P, _P, _P, _D, _P, _P,
                               _L, _L, _L, _L, _P, _P, _I, _I, _I, _P],
    "repro_ssm_scan": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       _I, _P],
    "repro_wkv6": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                   _I, _P],
    "repro_ssm_scan_bwd": [_P] * 16 + [_I] * 8 + [_P],
    "repro_wkv6_bwd": [_P] * 16 + [_I] * 5 + [_P],
    "repro_mark": [_I, _P],
}
#: element type codes shared with csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class KernelError(RuntimeError):
    """A kernel could not be built, loaded or launched: no ``nvcc``, a
    compile or link failure, no CUDA device, or a CUDA error from a launch.
    Its own class so that callers that survive bad *data* (the live
    controller's tick ladder) can tell a broken device path apart and let
    it propagate."""


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                       "kernels cannot be built")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _compile(cmd: list[str]) -> tuple[int, str, float]:
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc.returncode, proc.stdout, time.perf_counter() - t0


def build(out_dir: Path) -> Path:
    """Compile every source in parallel and link the shared library into
    ``out_dir``. Raises with the compiler's output if any step fails."""
    out_dir.mkdir(parents=True, exist_ok=True)
    cc = nvcc()
    srcs = sources()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in srcs]
        cmds = [[cc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                for src, obj in zip(srcs, objs)]
        with ThreadPoolExecutor(len(cmds)) as pool:
            results = list(pool.map(_compile, cmds))
        log = [f"== {src.name} (exit {rc}, {secs:.1f} s)\n{out}"
               for src, (rc, out, secs) in zip(srcs, results)]
        (out_dir / "build.log").write_text("\n".join(log))
        failed = [src.name for src, (rc, _, _) in zip(srcs, results) if rc]
        if failed:
            raise KernelError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [cc, "-shared", "-o", str(tmp_lib), *(str(o) for o in objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise KernelError(f"linking the kernels failed:\n{link.stdout}")
        os.replace(tmp_lib, out_dir / LIB_NAME)
    return out_dir / LIB_NAME


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this checkout has none."""
    if not torch.cuda.is_available():
        raise KernelError("the CUDA kernels need a CUDA device")
    out_dir = BUILD_ROOT / _digest()
    lib_path = out_dir / LIB_NAME
    if not lib_path.exists():
        build(out_dir)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def build_log() -> str:
    """``nvcc``/``ptxas`` output of the library :func:`library` loaded."""
    return (BUILD_ROOT / _digest() / "build.log").read_text()


def check(err: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err:
        msg = library().repro_cuda_error_string(err).decode()
        raise KernelError(f"{kernel} kernel launch failed: CUDA error {err} ({msg})")


def dtype_code(t: torch.Tensor) -> int:
    try:
        return DTYPE_CODES[t.dtype]
    except KeyError:
        raise ValueError(f"unsupported dtype {t.dtype}; the kernels take "
                         f"{sorted(str(d) for d in DTYPE_CODES)}") from None


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` if it is contiguous and on the 16-byte grid, else a contiguous
    copy (a fresh allocation is): for kernels that read it as float4s."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def on_grid(t: torch.Tensor) -> torch.Tensor:
    """``t`` if its last axis is contiguous, its other strides are multiples
    of 16 bytes and it starts on the 16-byte grid, else a contiguous copy:
    for kernels that copy its rows 16 bytes at a time through its strides
    (the copy is on the grid when a row is a multiple of 16 bytes long)."""
    row = 16 // t.element_size()
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(x % row == 0 for x in t.stride()[:-1])):
        return t
    return t.clone(memory_format=torch.contiguous_format)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(t: torch.Tensor) -> int:
    """The SMs of the CUDA device ``t`` lies on (launch plans size grids to
    whole waves of them)."""
    return _sm_count(t.device.index if t.device.index is not None
                     else torch.cuda.current_device())


#: devices on which a wrapper runs its kernel's plain version: the CPU, and
#: ``meta`` (shapes without storage: the dry-run traces a step there, and a
#: call there launches nothing and counts no launch)
PLAIN_DEVICES = ("cpu", "meta")

#: callables (op, flops, hbm_bytes) that a wrapper given ``meta`` tensors
#: charges what its plain version would have cost to, where that version
#: is not run there (the recurrences: ``roofline.op_count.OpCounter``
#: appends one while it counts a step)
META_CHARGES: list = []


def charge_meta(op: str, flops: float, hbm_bytes: float) -> None:
    for charge in META_CHARGES:
        charge(op, flops, hbm_bytes)


def require_cuda(*tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on one CUDA device."""
    devices = {t.device for t in tensors}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"expected tensors on one CUDA device, got {devices}")


def refuse_grad(kernel: str, *tensors: torch.Tensor, function: str | None = None) -> None:
    """Raise if grad mode is on and a tensor requires grad. A launch writes
    its result through a raw pointer, so the result would carry no gradient
    and cut every gradient upstream of it without a word. ``function`` names
    the ``torch.autograd.Function`` that runs the kernel with its backward
    (a ``RuntimeError`` then: K1, K2, K5, K6); without one the kernel has no
    backward (``NotImplementedError``: decode attention, the what-if kernels
    and the backward kernels themselves, which nothing differentiates)."""
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in tensors)):
        return
    if function is not None:
        raise RuntimeError(f"{kernel}: the kernel's result carries no gradient; under "
                           f"autograd call it through {function}")
    raise NotImplementedError(f"{kernel} has no backward: its kernel cannot run under "
                              f"autograd (its plain version can)")
