"""Seconds ``nvcc`` takes to build the port's kernel libraries, one at a time,
on the machine with the CUDA toolkit.

    python3 scripts/build_times.py [CSRC_DIR_OR_SOURCE ...]

Builds every ``*.cu`` of each directory given, or each source given
(default: the package's own ``src/repro_torch/csrc``), with
``kernels/build.py``'s flags, one ``nvcc`` after the other so that no build
shares the host's cores with another, into
a temporary directory, and prints one line a library: its directory, name,
seconds, and the number of kernels ``ptxas`` compiled.  Give a second
directory (say an unpacked older tree's ``csrc``) to set two versions of the
sources side by side in one call.  Imports nothing of JAX or of the JAX
package.
"""
from __future__ import annotations

import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build as kbuild  # noqa: E402


def main(argv: list[str]) -> None:
    dirs = [Path(a) for a in argv] or [kbuild.CSRC]
    nvcc = kbuild.cuda_tool("nvcc")
    with tempfile.TemporaryDirectory() as tmp:
        for i, d in enumerate(dirs):
            for src in [d] if d.is_file() else sorted(d.glob("*.cu")):
                out = Path(tmp) / f"{i}-{src.stem}.so"
                t0 = time.perf_counter()
                proc = subprocess.run([nvcc, *kbuild.BASE_FLAGS, "-o", str(out),
                                       str(src)], capture_output=True,
                                      text=True, timeout=900)
                seconds = time.perf_counter() - t0
                if proc.returncode != 0:
                    raise SystemExit(f"nvcc failed on {src}:\n"
                                     f"{proc.stdout}{proc.stderr}")
                kernels = sum("Compiling entry function" in line for line in
                              (proc.stdout + proc.stderr).splitlines())
                print(f"{src}: built in {seconds:.2f} s, {kernels} kernels",
                      flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
