"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into a shared library, loaded with ``ctypes``.
Libraries are built at first use (never at import) into ``build/kernels``
at the root of the checkout, named by a hash of their source and flags,
so an edited source is rebuilt and an unchanged one is reused.
``build()`` starts one ``nvcc`` per missing library, all at once. Each
function takes another ``csrc`` directory (another version of the sources,
e.g. an earlier commit's, to time against), whose libraries get names of
their own hash beside the port's.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("flash_attention", "decode_attention", "ssd_scan", "moe_gmm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[Tuple[str, Path], ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin: "
                           "the CUDA kernels cannot be built")
    return nvcc


def library_path(name: str, csrc: Path = CSRC) -> Path:
    """Where the library built from ``csrc/<name>.cu`` (and the headers of
    ``csrc/``, which it may include) lives."""
    src = b"".join(p.read_bytes() for p in
                   [csrc / f"{name}.cu", *sorted(csrc.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def build(names: Iterable[str] = SOURCES, csrc: Path = CSRC) -> Dict[str, str]:
    """Compile every library of ``names`` that is not built yet, one
    ``nvcc`` per source, all started together.

    Returns: ``{name: compiler output}`` for the libraries built now (the
    ``-Xptxas -v`` register and shared-memory report).
    Raises: ``RuntimeError`` naming each source that failed, with the
    compiler's output.
    """
    procs = []
    for name in names:
        out = library_path(name, csrc)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(csrc / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    reports, errors = {}, []
    for name, out, tmp, proc in procs:
        text = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            errors.append(f"{name}: nvcc exited {proc.returncode}\n{text}")
        else:
            os.replace(tmp, out)
            reports[name] = text
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return reports


def load(name: str, csrc: Path = CSRC) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get((name, csrc))
    if lib is None:
        build((name,), csrc)
        lib = ctypes.CDLL(str(library_path(name, csrc)))
        _loaded[name, csrc] = lib
    return lib
