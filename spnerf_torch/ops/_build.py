"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into a shared
library with a plain C interface, loaded with `ctypes`. Libraries go to
`spnerf_torch/_build/` under a name that carries a hash of the source and
the flags, so an edited source is rebuilt and an unchanged one is reused.
Nothing here runs at import time.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded = {}


def nvcc_path():
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return nvcc


def library_path(name):
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD / f"lib{name}-{tag}.so"


def _start(name):
    """Start nvcc on `csrc/<name>.cu` unless its library exists."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return name, out, tmp, proc


def build_all(names):
    """Compile every named source whose library is missing, one nvcc process
    per source, all started together. Returns {name: compiler output
    (ptxas register and spill counts), "" when it was already built}."""
    texts = dict.fromkeys(names, "")
    jobs = [job for job in map(_start, names) if job is not None]
    failed = []
    for name, out, tmp, proc in jobs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{text}")
        else:
            os.replace(tmp, out)
            texts[name] = text
    if failed:
        raise RuntimeError("\n".join(failed))
    return texts


def build(name):
    """Compile `csrc/<name>.cu` unless its library exists; see build_all."""
    return build_all([name])[name]


def load(name):
    """The loaded library of kernel `name`, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
