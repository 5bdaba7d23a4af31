"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface. It is compiled with ``nvcc``
for ``sm_90a`` at first use into ``hands_tpu_torch/csrc/_build/`` (keyed by a
hash of the source, of every ``csrc/*.cuh`` header and of the flags) and
loaded with ``ctypes``; no PyTorch header is involved, so a build takes
seconds. Every C entry takes the device index
first and the stream last, launches on that stream without synchronising,
and returns the launch's ``cudaGetLastError()``.

:class:`KernelOp` binds a kernel's launch function (its checks, the
``ctypes`` launch and the launch count) as a CUDA-only ``torch.library`` op
``hands_tpu_torch::<name>`` with a shape function, so that ``torch.export``
records the kernel as one graph node and a loaded program launches it
through the same function. Eager calls skip the dispatcher and call the
launch function itself. :class:`TorchOpsLibrary` builds the same ops'
registration in C++ (``csrc/torch_ops.cpp``), which an AOTInductor package
calls with no Python.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Iterable, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
OP_NAMESPACE = "hands_tpu_torch"
BUILD_DIR = CSRC / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin)")
    return found


class CudaLibrary:
    """One ``csrc/<name>.cu`` -> one shared library. ``bind(lib)`` declares
    the argument types of its entries; ``error_string`` names the entry that
    maps an error code to text."""

    def __init__(self, name: str, bind: Callable[[ctypes.CDLL], None],
                 error_string: str, extra_flags: Sequence[str] = ()):
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self.flags = NVCC_FLAGS + tuple(extra_flags)
        self._bind = bind
        self._error_string = error_string
        self._lib: Optional[ctypes.CDLL] = None
        self._proc: Optional[subprocess.Popen] = None
        self._tmp: Optional[Path] = None

    def so_path(self) -> Path:
        key = hashlib.sha256(self.source.read_bytes())
        for header in sorted(CSRC.glob("*.cuh")):  # shared device code
            key.update(header.read_bytes())
        key.update(" ".join(self.flags).encode())
        key = key.hexdigest()
        return BUILD_DIR / f"{self.name}_{key[:16]}.so"

    def start_build(self) -> None:
        """Start ``nvcc`` unless a library for this exact source and flag
        set exists (or a build is already running); :meth:`build` waits."""
        so = self.so_path()
        if so.exists() or self._proc is not None:
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        self._tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        self._proc = subprocess.Popen(
            [_nvcc(), *self.flags, "-o", str(self._tmp), str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def build(self) -> str:
        """Compile if needed. Returns the compiler's report (registers,
        shared memory and spills per kernel from ``-Xptxas -v``), empty if
        the library was cached."""
        self.start_build()
        if self._proc is None:
            return ""
        proc, self._proc = self._proc, None
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source}:\n{err}")
        os.replace(self._tmp, self.so_path())
        return err

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            self.build()
            lib = ctypes.CDLL(str(self.so_path()))
            self._bind(lib)
            err = getattr(lib, self._error_string)
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def launch(self, entry: str, device: torch.device, *args) -> None:
        """Call ``entry(device index, *args, stream)`` on PyTorch's current
        stream; raises if the launch was refused."""
        lib = self.lib()
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, entry)(device.index, *args, stream)
        if err != 0:
            msg = getattr(lib, self._error_string)(err).decode()
            raise RuntimeError(f"{entry} launch failed: {msg} ({err})")


def _torch_lib_dir() -> Path:
    return Path(torch.__file__).resolve().parent / "lib"


def _cxx() -> str:
    return shutil.which("g++") or "g++"


class TorchOpsLibrary:
    """``csrc/<name>.cpp`` -> one shared library that registers the kernels'
    ops from C++ (``TORCH_LIBRARY``; ``csrc/torch_ops.cpp``). Compiled with
    ``g++`` against PyTorch's headers and libraries, with PyTorch's C++ ABI
    flag and no Python: no ``ninja``, no ``torch.utils.cpp_extension``. It
    calls the C entries of ``deps`` (their libraries link into it and are
    found beside it, ``$ORIGIN``), so :meth:`files` is what a package that
    calls the ops ships. Keyed by a hash of the source, the flags, the
    PyTorch version and the dependencies' keys; :meth:`start_build` starts
    the compile (which needs no dependency) and :meth:`build` links once the
    dependencies are built."""

    CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-w")

    def __init__(self, name: str, deps: Sequence[CudaLibrary]):
        self.name = name
        self.source = CSRC / f"{name}.cpp"
        self.deps = tuple(deps)
        self._proc: Optional[subprocess.Popen] = None
        self._tmp: Optional[Path] = None

    def _flags(self) -> tuple:
        abi = int(torch._C._GLIBCXX_USE_CXX11_ABI)
        inc = _torch_lib_dir().parent / "include"
        return (*self.CXX_FLAGS, f"-D_GLIBCXX_USE_CXX11_ABI={abi}",
                f"-I{inc}")

    def so_path(self) -> Path:
        key = hashlib.sha256(self.source.read_bytes())
        key.update(" ".join(self._flags()).encode())
        key.update(torch.__version__.encode())
        for dep in self.deps:
            key.update(dep.so_path().name.encode())
        return BUILD_DIR / f"{self.name}_{key.hexdigest()[:16]}.so"

    def _object(self) -> Path:
        return self.so_path().with_suffix(".o")

    def start_build(self) -> None:
        """Start compiling unless the library (or its object) exists or a
        compile is already running."""
        so = self.so_path()
        if so.exists() or self._object().exists() or self._proc is not None:
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        self._tmp = so.with_name(f"{so.stem}.{os.getpid()}.o")
        self._proc = subprocess.Popen(
            [_cxx(), *self._flags(), "-c", str(self.source), "-o",
             str(self._tmp)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def build(self) -> str:
        """Compile and link if needed; returns the compiler's report."""
        so = self.so_path()
        if so.exists():
            return ""
        self.start_build()
        err = ""
        if self._proc is not None:
            proc, self._proc = self._proc, None
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed on {self.source}:\n{err}")
            os.replace(self._tmp, self._object())
        for dep in self.deps:
            dep.build()
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        link = subprocess.run(
            [_cxx(), "-shared", str(self._object()),
             "-o", str(tmp), f"-L{BUILD_DIR}",
             *(f"-l:{dep.so_path().name}" for dep in self.deps),
             f"-L{_torch_lib_dir()}", "-ltorch_cpu", "-lc10",
             "-Wl,-rpath,$ORIGIN"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking {so.name} failed:\n{link.stderr}")
        os.replace(tmp, so)
        return err + link.stderr

    def files(self) -> list:
        """The library and the per-source libraries it links, built."""
        self.build()
        return [self.so_path()] + [dep.so_path() for dep in self.deps]


def build_all(libraries: Iterable[CudaLibrary]) -> dict:
    """Build several libraries side by side (one ``nvcc`` each, all started
    together). Returns {name: compiler report}."""
    libraries = list(libraries)
    for lib in libraries:
        lib.start_build()
    return {lib.name: lib.build() for lib in libraries}


def on_cpu(x: torch.Tensor) -> bool:
    """True for CPU tensors (plain-twin path), False for CUDA tensors (kernel
    path); any other device raises: nothing falls back silently."""
    if x.device.type == "cpu":
        return True
    if x.device.type == "cuda":
        return False
    raise ValueError(f"no kernel or twin for device {x.device}")


def check(t: torch.Tensor, name: str, dtype, shape, device,
          layout: bool = True) -> None:
    """Raise unless ``t`` is a contiguous, 16-byte aligned ``dtype`` tensor of
    ``shape`` on ``device``: what the kernels take. ``layout=False`` skips
    the contiguity and alignment tests (for a twin, which takes any
    layout)."""
    if (t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape)
            or layout and (not t.is_contiguous() or t.data_ptr() % 16)):
        want = "a contiguous 16-byte-aligned " if layout else "a "
        raise ValueError(
            f"{name}: want {want}{dtype} {tuple(shape)} "
            f"on {device}, got {t.dtype} {tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})")


def check_gemm_operands(a: torch.Tensor, w: torch.Tensor) -> None:
    """Raise unless the TMA-fed GEMM kernels (``csrc/gemm_sm90.cuh``) take
    ``a`` (M, K) and ``w`` (N, K): rows of a multiple of 16 bytes (K % 8 in
    bf16, K % 16 in int8) and 16-byte aligned base addresses."""
    K, size = a.shape[-1], a.element_size()
    if K * size % 16:
        raise ValueError(
            f"GEMM kernel needs rows of a multiple of 16 bytes (TMA): "
            f"K % {16 // size} == 0 for {a.dtype}, got K={K}")
    for name, t in (("a", a), ("w", w)):
        if t.data_ptr() % 16:
            raise ValueError(
                f"GEMM kernel needs 16-byte aligned base addresses (TMA): "
                f"{name} starts at {t.data_ptr():#x}")


def tracing() -> bool:
    """True while ``torch.export`` or ``torch.compile`` traces the caller:
    its tensors are fake, with no storage to launch on."""
    return torch.compiler.is_exporting() or torch.compiler.is_compiling()


class KernelOp:
    """A kernel's launch function ``launch`` (annotated: the op's schema is
    read from it) bound as the CUDA-only op ``hands_tpu_torch::<name>``;
    ``fake`` returns empty tensors of the shapes and dtypes ``launch``
    returns. A call runs the op while :func:`tracing`, else ``launch``
    directly: the same kernel, without the dispatcher's host time."""

    def __init__(self, name: str, launch: Callable, fake: Callable):
        self.name = f"{OP_NAMESPACE}::{name}"
        self.launch = launch
        self.op = torch.library.custom_op(self.name, launch, mutates_args=(),
                                          device_types="cuda")
        self.op.register_fake(fake)

    def __call__(self, *args):
        return (self.op if tracing() else self.launch)(*args)
