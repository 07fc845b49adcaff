"""How far ``chip_smoke.py``'s checks of the SSD scan and its backward
reach, on one NVIDIA GPU.

    python3 scripts/ssd_fault_reach.py

Builds broken copies of ``src/repro_torch/csrc/ssd_scan.cu`` and
``ssd_scan_bwd.cu`` in a temporary directory (beside copies of the headers
they include), one nvcc each, all started together, each with one fault a
chunk-parallel scan or its gradient can have.  The forward's six:

* ``stale_state``: in the bf16 chunk scan, chunks past the ninth read the
  state entering the chunk before them (the wrong ``h_in``);
* ``missed_decay``: past the ninth chunk the state pass (both dtypes')
  carries the state without its decay ``exp(seg)``;
* ``dropped_keys``: the second warpgroup of a 128-row bf16 tile skips the
  last 16 key columns of ``W x`` (the rows next to the diagonal lose their
  most recent inputs);
* ``off_diagonal``: the bf16 ``W`` is masked to ``j < i``, dropping each
  row's own input;
* ``cc_stale_state``: the f32 chunk scan reads the state entering the
  chunk before its own, past the first chunk;
* ``cc_off_diagonal``: the f32 ``W`` is masked to ``j < i``.

The backward's five:

* ``grad_missed_decay``: the state chain (both dtypes') carries the
  gradient ``G`` back from chunks past the ninth without its decay
  ``exp(seg)``;
* ``no_reverse_cumsum``: ``ddt`` and ``dA`` take ``dcum`` itself for its
  reverse cumsum ``da`` within the chunk (both dtypes);
* ``skipped_head``: the bf16 dB / dC launch stacks the state terms of all
  but the last head of each run;
* ``run_sum_drops_head``: the bf16 dx / dS launch's sum of dS over a run
  of heads (the one product with C and B a run) leaves out the run's first
  head;
* ``cc_run_sum_drops_head``: the f32 dx / dS launch's sum likewise.

Runs the sound kernels and each copy at every shape of ``chip_smoke.py``'s
``SSD_SHAPES`` (bf16 and f32; its corners among them: chunks off the
instantiations, P and N padded or sliced, a batch of 66,000 folded on the
grid, each through ``ssd_scan.ssd_decomposed``) and prints, for each: the
forward's largest
elementwise error and whether the elementwise check passes, and the
relative error of the whole output and of its worst (b, h) slice against
chip_smoke's limits; the backward's errors per gradient (max |err| /
largest, relative error of the whole tensor and of its worst slice) and the
limits they break.  A fault applies at a shape whose dtype runs the code it
breaks and that reaches it (more than nine chunks of the chunk that runs,
``ssd_scan.run_chunk``, for the faults past the ninth, more than one for
``cc_stale_state`` and ``skipped_head``, whose state terms a single chunk
does not have, 128-row tiles for ``dropped_keys``).  Exits non-zero if a
sound kernel fails a check or a broken copy passes them all at a shape
where its fault applies.  Every line carries the card's name and power
limit.  Imports nothing of JAX or of the JAX package.
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
CC_H_IN = "const int64_t slot = (bh0 + h) * nc + c;"
CC_MASK = "cj <= ri && ri < rows"
FAULTS = {
    "stale_state": (H_IN, "static_cast<int>(bh * nc + (c > 8 ? c - 1 : c))"),
    "missed_decay": (DECAY, "(c > 8 ? 1.f : expf(seg[c * Q]))"),
    "dropped_keys": (KEYS, "if (kk >= 4 * (wg + 1) - wg) break;"),
    "off_diagonal": (MASK, "acc_s[e] = j < i && i < Q"),
    "cc_stale_state": (CC_H_IN, "const int64_t slot = (bh0 + h) * nc + "
                                "(c > 0 ? c - 1 : c);"),
    "cc_off_diagonal": (CC_MASK, "cj < ri && ri < rows"),
}
KEEP = "const float keep_c = dec[u];"
DA = "const float da = in ? sDa[i] : 0.f;"
STACK = "      mma_ss<Np, 0, 1>(acc, gmma_desc(xs + "
DS_SUM = "dsum[ih][e] += r_[e] * L * dtj;"
CC_DS_SUM = "dsum[i][j] += rv * L * dtj;"
BWD_FAULTS = {
    "grad_missed_decay": (KEEP, "const float keep_c = c > 8 ? 1.f : dec[u];"),
    "no_reverse_cumsum": (DA, "const float da = in ? sDc[i] : 0.f;"),
    "skipped_head": (STACK, "      if (k + 1 < nh) mma_ss<Np, 0, 1>(acc, "
                            "gmma_desc(xs + "),
    "run_sum_drops_head": (DS_SUM, "if (k > 0) " + DS_SUM),
    "cc_run_sum_drops_head": (CC_DS_SUM, "if (k > 0) " + CC_DS_SUM),
}


def applies(name: str, shape, dtype, chunk) -> bool:
    """Whether the fault ``name`` is reached at a shape of SSD_SHAPES."""
    s = shape[1]
    if name == "sound":
        return True
    shared = ("missed_decay", "grad_missed_decay", "no_reverse_cumsum")
    if name not in shared and name.startswith("cc_") != (dtype ==
                                                         torch.float32):
        return False
    run = ssd.run_chunk(chunk)     # the chunk the kernels run
    nc = -(-s // run)
    if name in ("stale_state", "missed_decay", "grad_missed_decay"):
        return nc > 9
    if name in ("cc_stale_state", "skipped_head"):
        return nc > 1   # one chunk has no state entering it or leaving it
    if name == "dropped_keys":
        return run > 64
    return True


def verdict(name: str, passes: bool, hit: bool) -> bool:
    """True if chip_smoke's checks gave the verdict this kernel should get
    at a shape (a fault that does not apply there may pass or fail)."""
    if name == "sound":
        return passes
    return not passes if hit else True


def readings(name: str) -> bool:
    """Every SSD shape through the forward kernel the wrapper has loaded;
    True if chip_smoke's checks give the verdict this kernel should get."""
    right = True
    for i, (label, shape, dtype, chunk, _) in enumerate(cs.SSD_SHAPES):
        args = cs.ssd_inputs(shape, dtype, seed=200 + i)
        out = ssd.ssd_scan_cuda(*args, chunk=chunk).float()
        want = ref.ssd_scan_ref(*args, chunk=chunk).float()
        err = float((out - want).abs().max())
        close = bool(torch.allclose(out, want, rtol=cs.SSD_TOL[dtype],
                                    atol=cs.SSD_TOL[dtype]))
        rel, worst = cs.relative_errors(out, want)
        passes = (close and rel < cs.SSD_REL_TOL[dtype]
                  and worst < cs.SSD_SLICE_TOL[dtype])
        hit = applies(name, shape, dtype, chunk)
        right &= verdict(name, passes, hit)
        cs.say(name, f"{label} {list(shape)} chunk {chunk}: max |err| "
               f"{err!r} (elementwise {cs.SSD_TOL[dtype]}: "
               f"{'passes' if close else 'fails'}); relative error {rel!r} "
               f"(limit {cs.SSD_REL_TOL[dtype]}), worst (b, h) slice "
               f"{worst!r} (limit {cs.SSD_SLICE_TOL[dtype]}); "
               f"{'passes' if passes else 'fails'} chip_smoke's checks"
               f"{'' if hit else ' (the fault does not apply here)'}")
        del args, out, want
        torch.cuda.empty_cache()
    return right


def bwd_readings(name: str) -> bool:
    """Every SSD shape through the backward kernel the wrapper has loaded,
    against ``ref.ssd_scan_bwd_ref`` with chip_smoke's phase-2 inputs and
    limits; True if the checks give the verdict this kernel should get."""
    right = True
    for i, (label, shape, dtype, chunk, _) in enumerate(cs.SSD_SHAPES):
        args = cs.ssd_bwd_inputs(shape, dtype, seed=500 + i)
        got = ssd.ssd_scan_bwd_cuda(*args, chunk=chunk)
        want = ref.ssd_scan_bwd_ref(*args, chunk=chunk)
        finite = all(bool(g.isfinite().all()) for g in got)
        errs = cs.ssd_bwd_errors(got, want)
        bad = cs.ssd_bwd_failures(errs, dtype)
        passes = finite and not bad
        hit = applies(name, shape, dtype, chunk)
        right &= verdict(name, passes, hit)
        cs.say(name, f"backward {label} {list(shape)} chunk {chunk}: "
               f"finite {finite}; (max |err| / largest, relative error, "
               f"worst slice) {errs}; breaks {bad or 'no limit'}; "
               f"{'passes' if passes else 'fails'} chip_smoke's checks"
               f"{'' if hit else ' (the fault does not apply here)'}")
        del args, got, want
        torch.cuda.empty_cache()
    return right


def main() -> None:
    right = readings("sound") & bwd_readings("sound")
    tmp = Path(tempfile.mkdtemp(prefix="ssd_faults_"))
    fwd = kbuild.edited_copies(
        ssd.SRC, {k: [fault] for k, fault in FAULTS.items()}, tmp)
    bwd = kbuild.edited_copies(
        ssd.SRC_BWD, {k: [fault] for k, fault in BWD_FAULTS.items()}, tmp)
    kbuild.build(*((path, ssd.NVCC_FLAGS)
                   for path in [*fwd.values(), *bwd.values()]))
    for name, path in fwd.items():
        kbuild.use_copy(ssd, path)
        right &= readings(name)
    for name, path in bwd.items():
        kbuild.use_copy(ssd, path, "SRC_BWD", "_bwd_library")
        right &= bwd_readings(name)
    print(cs.CARD)
    if not right:
        sys.exit("ssd_fault_reach: a check gave the wrong verdict")


if __name__ == "__main__":
    main()
