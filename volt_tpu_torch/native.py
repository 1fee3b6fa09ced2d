"""Build and bind the port's hand-written CUDA kernels.

The sources in ``csrc/`` have a plain C interface.  On first use each is
compiled with its own ``nvcc`` for Hopper (``sm_90a``), all at once, and
the objects are linked into one shared library under ``_build/`` (keyed
by a hash of the sources, their headers and the flags, so an edited source
rebuilds), which
is loaded with ``ctypes``.  Nothing here runs at import: the CPU never
needs the library.

:func:`launch` is the one place a kernel is launched: it passes tensor
pointers and PyTorch's current stream, raises on the ``cudaError_t`` the C
entry returns, and counts the launch in :data:`launches`.  A launch is on
the host's path of every kernel call, so it does little: each C entry is
resolved once, the device is switched only when the tensors' device is not
the current one, and the current stream is still read on every call (a
CUDA graph captures on a stream of its own).

:func:`on_card` is the port's one rule between a kernel and its plain
version: a call whose tensors lie on the card goes to the kernel, whose
wrapper raises on what the kernel does not take; a call on the CPU takes
the plain version.  Nothing falls back to the plain version on the card.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["library", "launch", "launches", "check_tensors", "build_log",
           "on_card", "size"]

_HERE = Path(__file__).resolve().parent
_CSRC = _HERE / "csrc"
_BUILD = _HERE / "_build"
_SOURCES = ("ewma_filter.cu", "kalman.cu", "volt_cov.cu", "gh_ell.cu",
            "gpcv_elbo.cu", "mt_gpcv_elbo.cu", "mt_vol_mll.cu",
            "bm_vol_mll.cu")
_HEADERS = ("affine_scan.cuh",)
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_L = ctypes.c_longlong
# C entry points: argument types, the trailing stream included.
_SIGNATURES = {
    "volt_ewma_filter": (_P, _P, _I, _I, _I, _D, _D, _D, _P),
    "volt_kalman_forward": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P),
    "volt_kalman_backward": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                             _I, _I, _P),
    "volt_covariance": (_P, _P, _I, _I, _P),
    "volt_gh_ell_forward": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "volt_gh_ell_backward": (_P, _P, _P, _P, _P, _P, _I, _P),
    "volt_gpcv_tridiag_elbo": (_P, _I, *(_P,) * 13, _I, _I, _P),
    "volt_mt_gpcv_tridiag_elbo": (*(_P,) * 20, _L, _I, _I, _I, _P),
    "volt_mt_vol_woodbury_blocks": (*(_P,) * 15, _L, _I, _I, _I, _P),
    "volt_mt_vol_woodbury_mll": (*(_P,) * 12, _I, _P, _I, _I, *(_P,) * 7,
                                 _L, _I, _I, _I, _P),
    "volt_bm_vol_spectral_mll": (*(_P,) * 6, _I, *(_P,) * 5, _I, _I, _P),
}

# C functions that launch nothing and return a size that only their source
# knows (a workspace's length): argument types.
_SIZES = {
    "volt_mt_gpcv_workspace_len": (_I, _I, _I),
    "volt_mt_vol_woodbury_workspace_len": (_I, _I, _I),
}

# What :func:`launch` passes as it is; everything else is a tensor.
_SCALARS = frozenset((int, float, type(None)))

# Launches per C entry point since the last ``launches.clear()``.
launches: collections.Counter = collections.Counter()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + [
            Path("/usr/local/cuda/bin/nvcc")]:
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA "
                           "toolkit to build the port's kernels")
    return found


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for name in _SOURCES + _HEADERS:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    return _BUILD / f"libvolt_kernels_{h.hexdigest()[:16]}.so"


def build_log() -> str:
    """The compiler's output (``ptxas -v`` register and shared-memory
    use per kernel) from the build of the current sources, if any."""
    log = _library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _run_all(cmds):
    """Run the commands at once; raise on the first that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    for cmd, proc, log in zip(cmds, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{log}")
    return "".join(logs)


@functools.cache
def _entries() -> dict:
    """The C entry points of :func:`library`, by name."""
    lib = library()
    return {name: getattr(lib, name) for name in (*_SIGNATURES, *_SIZES)}


@functools.cache
def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library."""
    so = _library_path()
    if not so.exists():
        _BUILD.mkdir(exist_ok=True)
        nvcc = _nvcc()
        tag = f"{so.stem}.{os.getpid()}"
        objs = [_BUILD / f"{tag}.{Path(s).stem}.o" for s in _SOURCES]
        log = _run_all([[nvcc, *_FLAGS, "-c", "-o", str(o), str(_CSRC / s)]
                        for s, o in zip(_SOURCES, objs)])
        tmp = so.with_name(f"{tag}.tmp")
        _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
        for o in objs:
            o.unlink()
        so.with_suffix(".log").write_text(log)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    for name, argtypes in _SIZES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_longlong
    lib.volt_cuda_error_string.argtypes = (ctypes.c_int,)
    lib.volt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def on_card(t: torch.Tensor) -> bool:
    """Whether a call on ``t`` goes to its kernel: ``t`` lies on the card.
    The kernel's wrapper then launches it or raises; only a tensor on the
    CPU takes the plain version."""
    return t.is_cuda


def size(symbol: str, *args: int) -> int:
    """The size that the C function ``symbol`` computes from ``args``."""
    return _entries()[symbol](*args)


def check_tensors(name: str, *tensors):
    """Raise unless every tensor is a contiguous float32 CUDA tensor on
    one device — the only layout the kernels take."""
    index = tensors[0].get_device()
    for t in tensors:
        if not (t.is_cuda and t.get_device() == index
                and t.dtype is torch.float32 and t.is_contiguous()
                and t.numel() < 2**31):
            _refuse(name, t, tensors[0])


def _refuse(name, t, first):
    if t.device.type != "cuda" or t.device != first.device:
        raise ValueError(f"{name}: expected CUDA tensors on one device, "
                         f"got {t.device} (and {first.device})")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous tensors")
    raise ValueError(f"{name}: {t.numel()} elements exceed the kernels' "
                     f"32-bit sizes")


def launch(symbol: str, *args, device: torch.device):
    """Call the C entry ``symbol`` on ``device``'s current stream.

    Tensors are passed as pointers, ``None`` as a null pointer, ints and
    floats as the entry's ``int`` and ``double``.  Raises ``RuntimeError``
    if the launch was refused.
    """
    fn = _entries()[symbol]
    # by type, not isinstance: a tensor's isinstance check goes through its
    # metaclass, and costs more than the rest of the launch's Python
    cargs = [a if type(a) in _SCALARS else a.data_ptr() for a in args]
    index = device.index
    # the current stream's handle, as PyTorch's own compiled kernels read
    # it (torch._inductor's get_raw_stream), without a Stream object
    if index == torch.cuda.current_device():
        rc = fn(*cargs, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(*cargs, torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        msg = library().volt_cuda_error_string(rc).decode()
        raise RuntimeError(f"{symbol}: CUDA error {rc} ({msg})")
    launches[symbol] += 1
