"""Where the SSD backward's time goes, on one NVIDIA GPU.

    python3 scripts/ssd_bwd_cuts.py [--f32] [--json PATH]

Builds copies of ``csrc/ssd_scan_bwd.cu`` (beside copies of the headers,
in a temporary directory, one nvcc each, all started together) with one
piece of a launch switched off, loads each in place of the wrapper's
library, and times every launch of the backward at chip_smoke.py's bf16
SSD shapes from a profile of 5 calls (device time a call), the sound
kernel first and last.  A cut kernel computes wrong gradients; only its
time is read.  The cuts, of the dx / dS launch unless named:

* ``no S R``: the products S^T = B C^T and R^T = x dy^T are skipped;
* ``no B G^T``: dx's state product is skipped;
* ``no M^T dy``: dx's register-operand product is skipped;
* ``no exp``: the decay L = exp(cum_i - cum_j) is 1 (no exponential);
* ``no column sums``: the column sums of M R are not formed;
* ``no dx stores``: dx is not written;
* ``no block sum``: dD's block sum is one barrier;
* ``states: no stores``: the chunk-states launch writes no f32 state;
* ``states: no scaling``: it scales no rows of x and dy;
* ``dB/dC: no scaling``: the dB / dC launch scales no rows;
* ``dB/dC: no rise``: it forms no exp(cum) C . (dy h).

With ``--f32`` the cuts are of the f32 launches, at chip_smoke.py's f32
SSD shapes, of dx / dS unless named:

* ``no S^T``, ``no R^T``, ``no B G^T``, ``no M^T dy``: that product is
  skipped;
* ``no exp``: the decay is 1;
* ``no column sums``: the column sums of M R are not formed;
* ``no dS^T stores``: the run's dS^T is not written;
* ``no block sum``: dD's block sum is one barrier;
* ``dB/dC: no closing product``: dB / dC skips + dS^T C and + dS B.

Prints one line per variant and shape, then the card's name and power
limit.  Needs a CUDA device; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (exits without a CUDA device)
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402

NEVER = "if (a.Q < 0) "   # a condition the compiler cannot fold away
CUTS = {
    "sound": [],
    "no S R": [("wgmma_ss_n64(s_, ", NEVER + "wgmma_ss_n64(s_, "),
               ("wgmma_ss_n64(r_, ", NEVER + "wgmma_ss_n64(r_, ")],
    "no B G^T": [("mma_ss<Pp>(ax, ", NEVER + "mma_ss<Pp>(ax, ")],
    "no M^T dy": [("mma_rs<Pp>(ax, ", NEVER + "mma_rs<Pp>(ax, ")],
    "no exp": [("exp2f((sCum[i] - sCum[j]) * kLog2e)", "1.f")],
    "no column sums": [("cs[2 * (e / 4) + (e & 1)] += m * r_[e];", "")],
    "no dx stores": [("*reinterpret_cast<__nv_bfloat162*>(dxrow + p) = ",
                      NEVER + "*reinterpret_cast<__nv_bfloat162*>(dxrow + p)"
                      " = ")],
    "no block sum": [("dd = block_sum(dd, red, kThreads, tid / 32, lane, "
                      "tid);", "__syncthreads();")],
    "states: no stores": [("*reinterpret_cast<float2*>(out + p * a.N + n) =",
                           NEVER + "*reinterpret_cast<float2*>(out + p * a.N"
                           " + n) =")],
    "states: no scaling": [("scale_rows(xt, kXB * QT * 8, QT, sW, tid, 256);"
                            "\n    scale_rows(xt + kTileP, kXB * QT * 8, QT, "
                            "sE, tid, 256);", "")],
    "dB/dC: no scaling": [("scale_rows(tiles + (xs - base), kXB * QT * 8, QT,"
                           " sV, tid, kThreads);", "")],
    "dB/dC: no rise": [("if (side) {  // erow_i", "if (side && a.Q < 0) {  "
                        "// erow_i")],
}


F32_CUTS = {
    "sound": [],
    "no S^T": [("mm_dots(sT, ", NEVER + "mm_dots(sT, ")],
    "no R^T": [("mm_dots(r, ", NEVER + "mm_dots(r, ")],
    "no B G^T": [("    mm_dots(acc, sB, LN, sG, LN, N);",
                  "    " + NEVER + "mm_dots(acc, sB, LN, sG, LN, N);")],
    "no M^T dy": [("mm_rows(acc, sM, ", NEVER + "mm_rows(acc, sM, ")],
    "no exp": [("expf(sCum[ir] - cj)", "1.f")],
    "no column sums": [("colp[j] += m * rv;", "")],
    "no dS^T stores": [("out[(j0 + 4 * ty + i) * QT + j0 + tx + 16 * j] = ",
                        NEVER + "out[(j0 + 4 * ty + i) * QT + j0 + tx + 16 * j]"
                        " = ")],
    "no block sum": [("dd = block_sum(dd, red2, kCcThreads, warp, lane, "
                      "tid);", "__syncthreads();")],
    "dB/dC: no closing product": [
        ("    mm_rows(acc, room, ", "    " + NEVER + "mm_rows(acc, room, "),
        ("    mm_cols(acc, room, ", "    " + NEVER + "mm_cols(acc, room, ")],
}


def launches_ms(shape, chunk, args) -> dict[str, float]:
    """Device ms a call of each launch, and their sum, over 5 profiled
    calls after 2 warm-up calls."""
    for _ in range(2):
        ssd.ssd_scan_bwd_cuda(*args, chunk=chunk)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            ssd.ssd_scan_bwd_cuda(*args, chunk=chunk)
        torch.cuda.synchronize()
    per = cs.ssd_phase_ms(cs.device_time_by_name(prof), 5)
    per["total"] = sum(per.values())
    return per


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--f32", action="store_true",
                    help="cut the f32 launches, at the f32 shapes")
    ap.add_argument("--json", type=Path)
    opts = ap.parse_args()
    cuts = F32_CUTS if opts.f32 else CUTS
    dtype_cut = torch.float32 if opts.f32 else torch.bfloat16
    paths = kbuild.edited_copies(
        ssd.SRC_BWD, cuts, Path(tempfile.mkdtemp(prefix="ssd_bwd_cuts_")))
    kbuild.build(*((path, ssd.NVCC_FLAGS) for path in paths.values()))
    shapes = [(i, label, shape, dtype, chunk)
              for i, (label, shape, dtype, chunk, _) in enumerate(cs.SSD_SHAPES)
              if dtype == dtype_cut]
    inputs = {label: cs.ssd_bwd_inputs(shape, dtype, seed=500 + i)
              for i, label, shape, dtype, chunk in shapes}
    record = []
    for name in [*cuts, "sound"]:
        kbuild.use_copy(ssd, paths[name], "SRC_BWD", "_bwd_library")
        for _, label, shape, dtype, chunk in shapes:
            per = launches_ms(shape, chunk, inputs[label])
            record.append({"variant": name, "shape": label, "ms": per})
            cs.say("cuts", f"{name}, {label} {list(shape)}: " + ", ".join(
                f"{k} {v!r}" for k, v in per.items()))
    print(cs.CARD)
    if opts.json:
        opts.json.write_text(json.dumps({"card": cs.CARD, "runs": record},
                                        indent=1))


if __name__ == "__main__":
    main()
