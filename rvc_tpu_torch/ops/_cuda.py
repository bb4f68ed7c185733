"""Build and load the CUDA kernels of ``csrc/``.

Route: each ``.cu`` file is compiled by ``nvcc`` for ``sm_90a`` (all started
together), linked into one shared library with a plain C interface, and
loaded with ``ctypes``. No PyTorch headers are involved, so a cold build
takes seconds. The library lands in ``rvc_tpu_torch/_build/<hash>/``, keyed
by a hash of the sources and flags, and is built at first use.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
SOURCES = ("resblock_group.cu", "resblock_chain.cu", "banded_attention.cu", "nearest_rows.cu",
           "resblock_bwd.cu", "wavenet.cu")
# in the build hash with the sources
HEADERS = ("rowconv.cuh", "tc_rowconv.cuh", "mma.cuh", "hopper.cuh", "tf32_conv.cuh")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_IP = ctypes.POINTER(ctypes.c_int)
_PP = ctypes.POINTER(ctypes.c_void_p)
# C entry points: name -> argtypes. Each returns a cudaError_t as int, but
# the *_workspace functions, which return a size in floats (RESTYPES).
SIGNATURES = {
    "rvc_resblock_unit": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                          _I, _I, _P],
    "rvc_resblock_unit_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                               _I, _I, _P],
    "rvc_resblock_unit_bf16_sync": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                    _I, _I, _P],
    "rvc_resblock_unit_simt": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                               _I, _I, _P],
    "rvc_banded_attention": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _F, _P],
    "rvc_banded_attention_simt": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                  _F, _P],
    "rvc_banded_attention_bf16": [_P] * 8 + [_I] * 5 + [_F, _P],
    "rvc_banded_attention_bf16_workspace": [_I] * 4,
    "rvc_banded_attention_bf16_sync": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                       _F, _P],
    "rvc_nearest_rows": [_P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "rvc_resblock1_fwd": [_P, _P, _P, _P, _PP, _P] + [_I] * 5 + [_IP, _F, _P],
    "rvc_resblock1_fwd_simt": [_P] * 5 + [_I] * 5 + [_IP, _P],
    "rvc_resblock1_bwd": [_P] * 10 + [_L] + [_I] * 5 + [_IP, _F, _P],
    "rvc_resblock1_bwd_workspace": [_I] * 4,
    "rvc_resblock1_bwd_simt": [_P] * 10 + [_L] + [_I] * 5 + [_IP, _P],
    "rvc_resblock1_bwd_simt_workspace": [_I] * 4,
    "rvc_wn_fwd": [_P] * 13 + [_I] * 5 + [_P],
    "rvc_wn_fwd_simt": [_P] * 13 + [_I] * 5 + [_P],
    "rvc_wn_bwd": [_P] * 18 + [_L] + [_I] * 5 + [_P],
    "rvc_wn_bwd_workspace": [_I] * 4,
    "rvc_wn_bwd_simt": [_P] * 17 + [_L] + [_I] * 5 + [_P],
    "rvc_wn_bwd_simt_workspace": [_I] * 4,
}
RESTYPES = {name: _L for name in SIGNATURES if name.endswith("_workspace")}

_lib: ctypes.CDLL | None = None
build_info: dict = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _kernel_name(mangled: str) -> str:
    """'_ZN..._20resblock_unit_kernelEPKf...' -> 'resblock_unit_kernel';
    template arguments as <3>, <int8>, <float>."""
    m = re.search(r"\d+([a-z_]+_kernel)(I(?:Li(\d+)E|(a)|(f))E)?", mangled)
    if not m:
        return mangled
    arg = m.group(3) or ("int8" if m.group(4) else "float" if m.group(5) else None)
    return m.group(1) + (f"<{arg}>" if arg else "")


def ptxas_summary(log: str) -> list[str]:
    """One line per kernel: registers, static shared memory, spills (from
    -Xptxas -v). The kernels' shared memory is dynamic, set at each launch."""
    out, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = _kernel_name(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = f"spill {m.group(1)}B/{m.group(2)}B"
            continue
        m = re.search(r"Used (\d+) registers(.*)", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", m.group(2))
            out.append(f"{name}: {m.group(1)} regs, "
                       f"{smem.group(1) if smem else 0}B static smem, {spill}")
            name, spill = None, ""
    return out


def serialized(log: str) -> list[str]:
    """The kernels in whose code ptxas serialized wgmma (its C7515 note)."""
    return sorted({_kernel_name(m.group(1))
                   for m in re.finditer(r"C7515[^\n]*?'(\w+)'", log)})


def _build(target: Path) -> None:
    nvcc = _nvcc()
    work = Path(tempfile.mkdtemp(dir=target.parent))
    try:
        t0 = time.perf_counter()
        objs = [work / (Path(name).stem + ".o") for name in SOURCES]
        procs = [subprocess.Popen([nvcc, *CFLAGS, "-c", str(CSRC / name), "-o", str(obj)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for name, obj in zip(SOURCES, objs)]
        logs = [p.communicate()[0] for p in procs]  # waits for every compile
        for name, p, log in zip(SOURCES, procs, logs):
            if p.returncode:
                raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(work / "librvc_kernels.so"),
                               *map(str, objs)], capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        (work / "ptxas.log").write_text("".join(logs))
        (work / "seconds").write_text(f"{time.perf_counter() - t0:.3f}")
        os.replace(work, target)
    except OSError:
        if not (target / "librvc_kernels.so").exists():
            raise
        # another process finished the same build first
    finally:
        shutil.rmtree(work, ignore_errors=True)


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    target = BUILD / _digest()
    cached = (target / "librvc_kernels.so").exists()
    if not cached:
        BUILD.mkdir(parents=True, exist_ok=True)
        _build(target)
    lib = ctypes.CDLL(str(target / "librvc_kernels.so"))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = RESTYPES.get(name, ctypes.c_int)
    log = (target / "ptxas.log").read_text()
    build_info.update(
        cached=cached, seconds=float((target / "seconds").read_text()),
        ptxas=ptxas_summary(log), serialized=serialized(log), path=str(target))
    _lib = lib
    return lib


def check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
