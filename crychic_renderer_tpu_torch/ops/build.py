"""Build and load the port's CUDA kernels: nvcc into a shared library with
a plain C interface, loaded with ctypes.

Each library lives at ``build/kernels/<hash>/lib<name>.so`` under the
repository root, where the hash covers its source and the nvcc flags, so a
changed source or flag never loads a stale library. A library is built at
its first use in a process (never at import: the CPU tests import every
module on machines without nvcc).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

from . import tally

CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# -Xptxas -v: the build log reports each kernel's registers, shared memory
# and spills
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


class KernelLibrary:
    """One ``csrc/<source>`` compiled to ``lib<name>.so``.

    ``load()`` builds on first use (or always with rebuild=True), binds the
    C functions with the given ctypes signatures and returns the CDLL;
    ``build_seconds`` is the nvcc wall time of the last build in this
    process (None when the library was already on disk) and
    ``build_log`` its compiler output (ptxas' resource report).

    Every C entry returns 0 or an error code, which the entry named
    ``error`` turns into the library's text. ``call`` calls an entry and
    ``launch`` launches a kernel on a device's current stream and counts
    it in the tally (ops/tally.py); both raise on a non-zero return."""

    def __init__(self, source: str, name: str, signatures: dict,
                 error: str):
        self.source = os.path.join(CSRC, source)
        self.name = name
        self.error = error
        # fn name -> (argtypes, restype)
        self.signatures = {**signatures,
                           error: ([ctypes.c_int], ctypes.c_char_p)}
        self.build_seconds = None
        self.build_log = None
        self._lib = None

    def path(self) -> str:
        with open(self.source, "rb") as f:
            src = f.read()
        key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
        return os.path.join(REPO_ROOT, "build", "kernels", key[:16],
                            f"lib{self.name}.so")

    def load(self, rebuild: bool = False):
        if self._lib is not None and not rebuild:
            return self._lib
        path = self.path()
        if rebuild or not os.path.exists(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            t0 = time.perf_counter()
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, self.source],
                capture_output=True, text=True)
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {self.source}:\n"
                                   f"{self.build_log}")
            self.build_seconds = time.perf_counter() - t0
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        for fn, (argtypes, restype) in self.signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        self._lib = lib
        return lib

    def _raise(self, lib, entry: str, rc: int):
        if rc != 0:
            raise RuntimeError(f"{entry} failed: "
                               + getattr(lib, self.error)(rc).decode())

    def call(self, entry: str, *args):
        """Call the C entry `entry` with args (an entry that launches no
        kernel); raise RuntimeError with the library's error text where
        it returns non-zero."""
        lib = self.load()
        self._raise(lib, entry, getattr(lib, entry)(*args))

    def launch(self, entry: str, device, *args, key, n: int = 1):
        """Launch the kernel entry `entry` on the CUDA `device`: args, then
        the device's current stream, inside torch.cuda.device(device).
        Raises like call; else adds n launches to the tally under `key`
        (None: not counted)."""
        lib = self.load()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = getattr(lib, entry)(*args, stream)
        self._raise(lib, entry, rc)
        if key is not None:
            tally.add({key: n})
