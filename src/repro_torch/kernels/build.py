"""Build the port's CUDA sources with ``nvcc`` and bind them with ``ctypes``.

One helper for every kernel: a source under ``csrc/`` is compiled for
``sm_90a`` into a shared library with a plain C interface, at first use,
under ``build/repro_torch/`` at the repository root (git-ignored).  The
library's name carries a hash of the source, of the headers it includes
from ``csrc/`` (``#include "hopper.cuh"``) and of the flags, so an edited
source or header builds anew and an unchanged one is reused.  ``build`` starts one
``nvcc`` per source that is not built yet, all at once, and waits for them.
Nothing is built or loaded at import.  The libraries link nothing beyond
the CUDA runtime: the tensor-core kernels find the driver-API function they
need (``cuTensorMapEncodeTiled``) in the loaded driver with ``dlsym``, so
no ``-lcuda`` is needed.  A kernel called through ``ctypes``
writes into a fresh tensor outside the autograd graph, so every wrapper
calls ``refuse_autograd`` first.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
BASE_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)
MAX_GRID_YZ = 65535             # the grid's y and z


def head_grid(h: int, b: int) -> tuple[int, int]:
    """The grid's y and z of the flash and SSD kernels for ``b`` x ``h``
    (batch, head) pairs (``h`` may count a kernel's own unit on y: a run
    of a group's heads): ``(h, b)`` while both fit ``MAX_GRID_YZ``, else
    the pair index ``b * h + head`` folded as ``y + Y * z``
    (``csrc/grid_fold.cuh`` ``head_grid``)."""
    if h <= MAX_GRID_YZ and b <= MAX_GRID_YZ:
        return h, b
    y = min(h * b, MAX_GRID_YZ)
    return y, -(-h * b // y)


def cuda_tool(name: str) -> str:
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``)."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", name), shutil.which(name)):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(f"{name} not found: set CUDA_HOME or put it on PATH")


def _sources(src: Path) -> list[Path]:
    """``src`` and, depth first, every file it includes with quotes
    (``#include "name"``, looked up beside it), each once."""
    found = [src]
    for name in re.findall(r'^\s*#\s*include\s+"([^"]+)"', src.read_text(),
                           re.MULTILINE):
        for path in _sources(src.parent / name):
            if path not in found:
                found.append(path)
    return found


def library_path(src: Path, flags: tuple[str, ...]) -> Path:
    """Where the library of ``src`` (with the headers it includes) built
    with ``flags`` lives."""
    key = hashlib.sha256(b"".join(p.read_bytes() for p in _sources(src))
                         + " ".join(flags).encode())
    return BUILD_DIR / f"lib{src.stem}-{key.hexdigest()[:16]}.so"


def build(*sources: tuple[Path, tuple[str, ...]]) -> list[dict]:
    """Compile each ``(source, flags)`` pair unless it was built already.

    Returns one ``{"path", "seconds", "log"}`` per pair, in order;
    ``seconds`` is None when an existing build was reused, and ``log`` holds
    nvcc's ``-Xptxas -v`` report (registers, shared memory and spills of
    each kernel).  Raises if any nvcc fails.
    """
    out: list[dict | None] = [None] * len(sources)
    running = []
    for i, (src, flags) in enumerate(sources):
        path = library_path(src, flags)
        if path.exists():
            out[i] = {"path": path, "seconds": None, "log": ""}
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [cuda_tool("nvcc"), *flags, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((i, src, path, tmp, proc, time.perf_counter()))
    failed = []
    for i, src, path, tmp, proc, t0 in running:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed building {src} (exit "
                          f"{proc.returncode}):\n{log}")
            continue
        os.replace(tmp, path)
        out[i] = {"path": path, "seconds": seconds, "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def load(src: Path, flags: tuple[str, ...]) -> ctypes.CDLL:
    """The library of ``src``, built if needed.  The caller declares
    ``argtypes`` and ``restype`` of what it calls, and keeps the library
    (``functools.cache`` on its own loader) so that it loads once."""
    return ctypes.CDLL(str(build((src, flags))[0]["path"]))


def edited_copies(src: Path, edits: dict[str, list[tuple[str, str]]],
                  into: Path) -> dict[str, Path]:
    """Copies of the source ``src`` in the directory ``into``, one for each
    name of ``edits`` with each of its ``(old, new)`` replacements made,
    beside copies of the ``csrc/`` headers they include; from here on
    ``build`` writes its libraries to ``into / "lib"``.  For the scripts
    that time a kernel with a piece cut, or check that a broken kernel
    fails its checks.  Raises ValueError where an ``old`` is not in the
    source exactly once."""
    global BUILD_DIR
    BUILD_DIR = into / "lib"
    for header in CSRC.glob("*.cuh"):
        shutil.copy(header, into)
    text = src.read_text()
    paths = {}
    for name, pairs in edits.items():
        out = text
        for old, new in pairs:
            if out.count(old) != 1:
                raise ValueError(f"{src.name} no longer has one {old!r} to "
                                 f"edit for {name!r}")
            out = out.replace(old, new)
        slug = re.sub(r"\W+", "_", name).strip("_")
        paths[name] = into / f"{src.stem}_{slug}.cu"
        paths[name].write_text(out)
    return paths


def use_copy(module, path: Path, src: str = "SRC",
             loader: str = "_library") -> ctypes.CDLL:
    """Point the kernel module's source ``module.<src>`` at ``path`` and its
    cached loader ``module.<loader>`` at the library built from it, bound
    by the module's own loader; returns that library."""
    current = getattr(module, loader)
    load = getattr(current, "__wrapped__", current)
    setattr(module, src, path)
    lib = load()

    def cached() -> ctypes.CDLL:
        return lib

    cached.__wrapped__ = load
    setattr(module, loader, cached)
    return lib


def refuse_autograd(name: str, **tensors: torch.Tensor) -> None:
    """Raise where autograd would record a kernel's output: the ctypes call
    writes into a fresh tensor that has no ``grad_fn``, so the gradient of
    every input that requires one would be lost without a word."""
    if not torch.is_grad_enabled():
        return
    need = [k for k, t in tensors.items() if t.requires_grad]
    if need:
        raise RuntimeError(
            f"{name} has no backward: the gradient of {', '.join(need)} "
            "would be lost.  Call it under torch.no_grad(), or through a "
            "differentiable form")


# the kernels' ops (``repro_torch::*``), defined by the kernel modules
_OPS = torch.library.Library("repro_torch", "FRAGMENT")


def define_op(schema: str, body) -> None:
    """The op ``repro_torch::<schema>`` with ``body`` as its CPU and CUDA
    kernel: ``torch.library``'s ``define`` and ``impl``, one dispatcher hop
    a call, without ``custom_op``'s Python wrapper around it (a few times
    the hop's cost).  A meta or fake tensor reaches the fake implementation
    the module registers (``torch.library.register_fake``) instead."""
    _OPS.define(schema)
    for key in ("CPU", "CUDA"):
        _OPS.impl(schema.split("(", 1)[0], body, key)
