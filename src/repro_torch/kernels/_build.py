"""Build and load the hand-written Hopper kernels.

Each ``repro_torch/csrc/<name>.cu`` has a plain C interface and compiles on
its own with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
-Xcompiler -fPIC`` into ``build/<name>-<hash>.so`` at the repository root,
at first use; the hash covers the source and the flags, so a changed source
never loads a stale library. ``nvcc``'s output (``-Xptxas -v``: registers,
spills and static shared memory of every kernel body) is kept beside it as
``build/<name>-<hash>.log``. The library is loaded with ``ctypes``: a few
seconds of ``nvcc``, where ``torch.utils.cpp_extension`` spends minutes
compiling PyTorch's headers.

Every C entry returns ``cudaGetLastError()`` after its launch and
:meth:`Kernel.check` raises on a non-zero code. A missing ``nvcc`` or a
failed build raises too; nothing falls back to another implementation.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


class Kernel:
    """One CUDA source: its build, its loaded library and its launch count.

    ``launches`` is a plain integer the kernel's wrapper bumps once per
    launch, so a run can show that its main path went through the kernel.
    ``signatures`` maps each C entry to its ctypes argument types; every
    entry returns an ``int`` error code."""

    def __init__(self, name: str, signatures: dict):
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self.signatures = signatures
        self.launches = 0
        self.ptxas_log = ""
        self._lib = None

    def library_path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes()
                                + " ".join(NVCC_FLAGS).encode()).hexdigest()
        return BUILD / f"{self.name}-{digest[:16]}.so"

    def start_build(self):
        """Start ``nvcc`` for this source (None when already built)."""
        out = self.library_path()
        if out.exists():
            return None
        BUILD.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, tmp, out

    def finish_build(self, started) -> None:
        if started is None:
            return
        proc, tmp, out = started
        log, _ = proc.communicate()
        self.ptxas_log = log
        if proc.returncode != 0:
            Path(tmp).unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {self.source.name}:\n{log}")
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)

    def lib(self):
        """The loaded library, building it first if needed."""
        if self._lib is None:
            self.finish_build(self.start_build())
            log = self.library_path().with_suffix(".log")
            if not self.ptxas_log and log.exists():   # built by an earlier run
                self.ptxas_log = log.read_text()
            lib = ctypes.CDLL(str(self.library_path()))
            for entry, argtypes in self.signatures.items():
                fn = getattr(lib, entry)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def check(self, err: int) -> None:
        if err != 0:
            raise RuntimeError(f"{self.name}: CUDA launch failed with error "
                               f"{err} (cudaError_t)")


def build_all(kernels) -> None:
    """Build several kernels at once: one ``nvcc`` per source, all started
    together, then load each library."""
    started = [(k, k.start_build()) for k in kernels]
    for k, s in started:
        k.finish_build(s)
    for k in kernels:
        k.lib()


def stream_handle(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def fake_mode_active() -> bool:
    """True inside a dry run's ``FakeTensorMode``."""
    import torch
    return torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is not None


def is_fake(*tensors) -> bool:
    """True when any given tensor is a dry run's ``FakeTensor``: it has a
    shape, a type and a device but no data, so a wrapper allocates its
    outputs and launches nothing."""
    from torch._subclasses.fake_tensor import FakeTensor
    return any(isinstance(t, FakeTensor) for t in tensors)


def require_cuda_tensors(name: str, *tensors) -> None:
    """Raise unless every tensor lies on one CUDA device."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"{name}: kernel inputs must lie on one CUDA "
                         f"device, got {sorted(map(str, devs))}")
