"""Builds the port's CUDA sources for Hopper and loads them with ctypes.

Each source under ``kernels/<name>/csrc/`` has a plain C interface and is
compiled by ``nvcc`` into its own shared library (no PyTorch headers, so a
build takes seconds). Libraries go to ``kernels/_build/``, which git
ignores, named by a hash of the source, the headers (``*.cuh``) beside it
and the flags, so an edited source or header is rebuilt and a stale
library is never loaded. Nothing is built when a
module is imported: the first launch builds what it needs, and
``build()`` builds several sources at once, one ``nvcc`` each, all started
together.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional

_KERNELS = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS / "_build"

SOURCES: Dict[str, Path] = {
    "paged_decode_attn": _KERNELS / "decode_attn" / "csrc"
    / "paged_decode_attn.cu",
    "wagg_fused": _KERNELS / "wagg" / "csrc" / "wagg_fused.cu",
    "rmsnorm": _KERNELS / "rmsnorm" / "csrc" / "rmsnorm.cu",
    "fused_ce": _KERNELS / "fused_ce" / "csrc" / "fused_ce.cu",
    "decode_attn": _KERNELS / "decode_attn" / "csrc" / "decode_attn.cu",
    "ssd_chunk": _KERNELS / "ssd_chunk" / "csrc" / "ssd_chunk.cu",
}

# --split-compile=0: each source's device optimizer spreads its kernels over
# the host's cores (the template-heavy decode sources build in about two
# thirds of the time)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
              "--split-compile=0")


@dataclasses.dataclass(frozen=True)
class Built:
    path: Path
    ptxas: List[str]            # ptxas -v lines: registers, stack, spills


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the toolkit's
    default install, else ``nvcc`` on PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return found


def _target(name: str) -> Path:
    src = SOURCES[name]
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _log(lib: Path) -> Path:
    return lib.with_suffix(".ptxas.txt")


def _ptxas_lines(text: str) -> List[str]:
    return [ln.strip() for ln in text.splitlines()
            if "ptxas" in ln or "spill" in ln]


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Built]:
    """Builds every named source (default: all) that is not built yet, all
    ``nvcc`` processes running at once; raises with the compiler's output
    if any fails."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: Dict[str, Built] = {}
    running = {}
    for name in names:
        lib = _target(name)
        if lib.exists():
            out[name] = Built(lib, _ptxas_lines(_log(lib).read_text()))
            continue
        tmp = lib.with_name(f".{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        running[name] = (lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (lib, tmp, proc) in running.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{text}")
            continue
        _log(lib).write_text(text)
        os.replace(tmp, lib)
        out[name] = Built(lib, _ptxas_lines(text))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The named kernel library, built on first use."""
    return ctypes.CDLL(str(build([name])[name].path))
