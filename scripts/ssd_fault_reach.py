"""How far ``chip_smoke.py``'s checks of the bf16 SSD scan reach, on one
NVIDIA GPU.

    python3 scripts/ssd_fault_reach.py

Builds four broken copies of ``src/repro_torch/csrc/ssd_scan.cu`` in a
temporary directory (beside a copy of the headers it includes), one nvcc
each, started together, each with one fault a chunk-parallel scan can have:

* ``stale_state``: chunks past the ninth read the state entering the chunk
  before them (phase 3 loads the wrong ``h_in``);
* ``missed_decay``: past the ninth chunk the state pass carries the state
  without its decay ``exp(seg)``;
* ``dropped_keys``: the second warpgroup of a 128-row tile skips the last
  16 key columns of ``W x`` (the rows next to the diagonal lose their most
  recent inputs);
* ``off_diagonal``: ``W`` is masked to ``j < i``, dropping each row's own
  input.

Runs the sound kernel and each copy at ``chip_smoke.py``'s bf16 shapes and
prints, for each, the largest elementwise error and whether the elementwise
2e-2 check passes, and the relative error of the whole output and of its
worst (b, h) slice against chip_smoke's limits.  Exits non-zero if the sound
kernel fails a check or a broken copy passes them all.  Every line carries
the card's name and power limit.  Imports nothing of JAX or of the JAX
package.
"""
from __future__ import annotations

import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (exits without a CUDA device)
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402

H_IN = "static_cast<int>(bh * nc + c)"
DECAY = "expf(seg[c * Q])"
KEYS = "if (kk >= 4 * (wg + 1)) break;"
MASK = "acc_s[e] = j <= i && i < Q"
FAULTS = {
    "stale_state": (H_IN, "static_cast<int>(bh * nc + (c > 8 ? c - 1 : c))"),
    "missed_decay": (DECAY, "(c > 8 ? 1.f : expf(seg[c * Q]))"),
    "dropped_keys": (KEYS, "if (kk >= 4 * (wg + 1) - wg) break;"),
    "off_diagonal": (MASK, "acc_s[e] = j < i && i < Q"),
}


def readings(name: str) -> bool:
    """Every bf16 shape through the kernel the wrapper has loaded; True if
    chip_smoke's checks give the verdict this kernel should get."""
    right = True
    for i, (label, shape, dtype, chunk, _) in enumerate(cs.SSD_SHAPES):
        if dtype != torch.bfloat16:
            continue
        args = cs.ssd_inputs(shape, dtype, seed=200 + i)
        out = ssd.ssd_scan_cuda(*args, chunk=chunk).float()
        want = ref.ssd_scan_ref(*args, chunk=chunk).float()
        err = float((out - want).abs().max())
        close = bool(torch.allclose(out, want, rtol=cs.SSD_TOL[dtype],
                                    atol=cs.SSD_TOL[dtype]))
        rel, worst = cs.relative_errors(out, want)
        passes = (close and rel < cs.SSD_REL_TOL[dtype]
                  and worst < cs.SSD_SLICE_TOL[dtype])
        right &= passes if name == "sound" else not passes
        cs.say(name, f"{label} {list(shape)} chunk {chunk}: max |err| "
               f"{err!r} (elementwise {cs.SSD_TOL[dtype]}: "
               f"{'passes' if close else 'fails'}); relative error {rel!r} "
               f"(limit {cs.SSD_REL_TOL[dtype]}), worst (b, h) slice "
               f"{worst!r} (limit {cs.SSD_SLICE_TOL[dtype]}); "
               f"{'passes' if passes else 'fails'} chip_smoke's checks")
        del args, out, want
        torch.cuda.empty_cache()
    return right


def main() -> None:
    right = readings("sound")
    src = ssd.SRC.read_text()
    tmp = Path(tempfile.mkdtemp(prefix="ssd_faults_"))
    kbuild.BUILD_DIR = tmp / "lib"
    for header in kbuild.CSRC.glob("*.cuh"):      # what the copies include
        (tmp / header.name).write_text(header.read_text())
    paths = {}
    for name, (old, new) in FAULTS.items():
        if src.count(old) != 1:
            sys.exit(f"ssd_fault_reach: the source no longer has one "
                     f"{old!r} to break")
        paths[name] = tmp / f"ssd_scan_{name}.cu"
        paths[name].write_text(src.replace(old, new))
    kbuild.build(*((path, ssd.NVCC_FLAGS) for path in paths.values()))
    load = ssd._library.__wrapped__  # the uncached loader, to rebind SRC
    for name, path in paths.items():
        ssd.SRC = path
        lib = load()
        ssd._library = lambda lib=lib: lib
        right &= readings(name)
    print(cs.CARD)
    if not right:
        sys.exit("ssd_fault_reach: a check gave the wrong verdict")


if __name__ == "__main__":
    main()
