"""Build and bind the port's hand-written CUDA kernels.

Each kernel lives in ``csrc/<name>.cu`` with a plain C interface (shared
device code in ``csrc/*.cuh``).  At first use it is compiled by ``nvcc``
for ``sm_90a`` into a shared library under
``coinstac_dinunet_tpu_torch/_build/`` (named by a hash of the source, the
headers and the flags, so an edit rebuilds) and loaded with ``ctypes``.  Nothing
falls back: a missing ``nvcc``, a failed build or a refused launch raises.
Nothing here runs at import time.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# no --use_fast_math: the kernels' divisions must stay IEEE so they agree
# bit for bit with their plain PyTorch versions
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path():
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then ``PATH``, then
    ``/usr/local/cuda/bin/nvcc``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(source):
    """Where the shared library for ``csrc/<source>`` is (or will be) built:
    named by a hash of the source, the shared headers and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for name in [source, *headers]:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            digest.update(f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}.{digest.hexdigest()[:16]}.so")


def all_sources():
    """Every kernel source in ``csrc/``."""
    return sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def build(sources):
    """Compile every source not built yet, one ``nvcc`` per source, all
    started together.  Returns ``{source: compiler output}``; raises with
    the compiler's output when any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for source in sources:
        out = library_path(source)
        if os.path.exists(out):
            continue
        tmp = f"{out}.tmp.{os.getpid()}"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, source)]
        procs[source] = (out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for source, (out, tmp, proc) in procs.items():
        logs[source] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(source)
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[s] for s in failed)
        )
    return logs


class CudaKernel:
    """One C entry point of one ``csrc`` source, built and loaded at first
    call.  ``launches`` counts the launches the card accepted."""

    def __init__(self, source, symbol, argtypes):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        self._lib = None
        self._lock = threading.Lock()

    def _load(self):
        with self._lock:
            if self._fn is None:
                build([self.source])
                lib = ctypes.CDLL(library_path(self.source))
                fn = getattr(lib, self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                lib.coinn_cuda_error_string.argtypes = [ctypes.c_int]
                lib.coinn_cuda_error_string.restype = ctypes.c_char_p
                self._lib, self._fn = lib, fn
        return self._fn

    def launch(self, *args):
        """Launch once; raise if the card refused the launch."""
        rc = self._load()(*args)
        if rc != 0:
            msg = self._lib.coinn_cuda_error_string(rc).decode()
            raise RuntimeError(f"{self.symbol} launch failed: {msg} ({rc})")
        self.launches += 1
