"""How far ``chip_smoke.py``'s checks of the flash backward reach, on one
NVIDIA GPU.

    python3 scripts/flash_bwd_fault_reach.py

Builds nine broken copies of ``src/repro_torch/csrc/flash_attention_bwd.cu``
in a temporary directory (beside a copy of the headers it includes), each
with one fault the backward can have:

* ``dropped_tile``: in the dQ kernel, blocks whose rows see more than 16
  key tiles (of 64 keys) skip their first;
* ``wrong_head``: in the dK/dV kernel, the last query head of a GQA group
  reads the group's first head instead of its own;
* ``missed_softcap``: the dQ kernel leaves the softcap's factor
  ``1 - (s / c)^2`` out of dS;
* ``slice_only_s`` (the wide kernels past 256 columns): the dQ kernel
  forms S over its block's own slice of columns only, not the whole head
  width;
* ``native_half_s`` (the native kernels, bf16 widths 136-256): the dQ
  kernel forms S over the first 128 columns only;
* ``native_wrong_head``: the native dK/dV kernel's last query head of a
  share reads the share's first head instead of its own;
* ``native_missed_share``: the native kernels' combine adds up every share
  of a GQA group's dK and dV parts but the last;
* ``f32_half_s`` (the f32 whole-width kernels, f32 widths past 128): the
  dQ kernel forms S over the first 128 columns only;
* ``f32_wrong_head``: the f32 whole-width dK/dV kernel's last query head of
  a GQA group reads the group's first head instead of its own.

The first two are faults of the narrow bf16 kernels, the softcap's of all
three bf16 ones (``dq_probs`` is shared), ``slice_only_s`` of the wide dQ
kernel, the next three of the native kernels, the last two of the f32
whole-width kernels: each applies only at the shapes its kernel runs
(``native_wrong_head`` where a share holds more than one head,
``native_missed_share`` where a group is shared, ``f32_wrong_head`` where
a group has more than one head).

Runs the sound kernel and each copy at ``chip_smoke.py``'s bf16 backward
shapes and the f32 shapes of the whole-width kernels, on the inputs
chip_smoke gives them, and prints for each tensor the relative error of the
whole tensor and of its worst row against chip_smoke's bf16 limits, and
each tensor's largest error over its largest |value| against the f32
limit.  Exits non-zero if the sound kernel fails a check or a broken copy
passes them all at a shape where its fault applies.  Every line carries the
card's name and power limit.  Imports nothing of JAX or of the JAX package.
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
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

KEY_TILES = "  mask.key_tiles(q0, q_rows, kTile, &kt_lo, &kt_hi);\n"
HEAD = ("  auto tile_head = [&](int i) { return b * Hq + hk * group + i / nq; "
        "};\n")
CAP_Q = "    sc[e] = p * fac;\n"
WIDE_S = ("        piece_item(sc, ring, i, min(kSlice, d - p * kSlice), "
          "p == 0);\n")
NAT_S = "    product_abt_256(sc, opaque(q_wg), kQBox, k_t, d);\n"
NAT_HEAD = ("  auto tile_head = [&](int i) { return b * Hq + hk * group + h_lo + "
            "i / nq; };\n")
NAT_SHARES = "  for (int s = 1; s < shares; ++s) {\n"
F32_S = ("        dot_piece<4, 4, 1, 16>(sc, qp + row0 * ldq, ldq, a + lx * "
         "kLdPiece, kLdPiece, n);")
F32_HEAD = ("    return (static_cast<size_t>(b) * Hq + hk * group + t / nq) * "
            "mask.Sq + q_first(t);")
FAULTS = {
    "dropped_tile": (KEY_TILES,
                     KEY_TILES + "  if (kt_hi - kt_lo > 16) ++kt_lo;\n"),
    "wrong_head": (HEAD, HEAD.replace(
        "i / nq; };", "(i / nq == group - 1 ? 0 : i / nq); };")),
    "missed_softcap": (CAP_Q, CAP_Q.replace(" * fac;", ";")),
    "slice_only_s": (WIDE_S, "        piece_item(sc, ring, i, p * kSlice == "
                     "c0 ? min(kSlice, d - p * kSlice) : 0, p * kSlice == c0);"
                     "\n"),
    "native_half_s": (NAT_S, NAT_S.replace(", d);", ", d < 128 ? d : 128);")),
    "native_wrong_head": (NAT_HEAD, NAT_HEAD.replace(
        "i / nq; };", "(i / nq > 0 && i / nq == h_hi - h_lo - 1 ? 0 : i / nq); "
        "};")),
    "native_missed_share": (NAT_SHARES, NAT_SHARES.replace(
        "s < shares;", "s < shares - 1;")),
    "f32_half_s": (F32_S, F32_S.replace("kLdPiece, n);",
                                        "kLdPiece, pp < 2 ? n : 0);")),
    "f32_wrong_head": (F32_HEAD, F32_HEAD.replace(
        "t / nq)", "(t / nq == group - 1 ? 0 : t / nq))")),
}


def applies(name: str, shape, kw, dtype) -> bool:
    b, hq, hk, sq, sk, d = shape
    if dtype == torch.float32:
        return (name == "f32_half_s" and fa.padded_width(d) > 128
                or name == "f32_wrong_head" and hq // hk > 1)
    if name.startswith("f32_"):
        return False
    bf16 = torch.bfloat16
    native = fa.native(d, bf16)
    wide = fa.slices(d, bf16) > 1
    shares = fa.head_split(b, hk, sk, hq // hk, cs.N_SM) if native else 1
    if name == "slice_only_s":
        return wide
    if name == "native_half_s":
        return native
    if name == "native_wrong_head":
        return native and -(-(hq // hk) // shares) > 1
    if name == "native_missed_share":
        return native and shares > 1
    if name == "dropped_tile":
        return not (wide or native) and -(-sk // 64) > 16
    if name == "wrong_head":
        return not (wide or native) and hq // hk > 1
    if name == "missed_softcap":
        return kw.get("softcap", 0.0) > 0.0
    return True


def readings(name: str) -> bool:
    """Every bf16 backward shape and every f32 shape of the whole-width
    kernels through the library the wrapper has loaded; True if
    chip_smoke's checks give the verdict this kernel should get."""
    right = True
    for i, (label, shape, dtype, kw) in enumerate(cs.FLASH_BWD_SHAPES):
        f32 = dtype == torch.float32
        if f32 and not fa.native(shape[5], dtype):
            continue
        q, k, v, do = cs.flash_bwd_inputs(label, shape, dtype, i)
        out, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
        grads = fa.flash_attention_bwd_cuda(q, k, v, out, lse, do, **kw)
        want = ref.attention_bwd_ref(q, k, v, out, lse, do, **kw)
        errs = {g: cs.grad_errors(x, y)
                for g, x, y in zip(("dq", "dk", "dv"), grads, want)}
        if f32:   # chip_smoke's f32 check: elementwise, of the largest value
            passes = all(e[0] <= cs.FLASH_BWD_TOL for e in errs.values())
        else:
            passes = all(rel < cs.FLASH_BWD_REL_TOL
                         and row < cs.FLASH_BWD_ROW_TOL
                         for _, rel, row in errs.values())
        hit = applies(name, shape, kw, dtype)
        if name == "sound":
            right &= passes
        elif hit:
            right &= not passes
        cs.say(name, f"{label} {list(shape)} {kw}: (max |err| / largest, "
               f"relative error, worst row) {errs} (limits "
               f"{cs.FLASH_BWD_TOL if f32 else ''}"
               f"{'' if f32 else (cs.FLASH_BWD_REL_TOL, cs.FLASH_BWD_ROW_TOL)}"
               f"); "
               f"{'passes' if passes else 'fails'} chip_smoke's checks"
               f"{'' if hit else ' (the fault does not apply here)'}")
        del q, k, v, do, out, lse, grads, want
        torch.cuda.empty_cache()
    return right


def main() -> None:
    right = readings("sound")
    paths = kbuild.edited_copies(
        fa.SRC_BWD, {k: [fault] for k, fault in FAULTS.items()},
        Path(tempfile.mkdtemp(prefix="flash_bwd_faults_")))
    kbuild.build(*((path, fa.NVCC_FLAGS) for path in paths.values()))
    for name, path in paths.items():
        kbuild.use_copy(fa, path, "SRC_BWD", "_bwd_library")
        right &= readings(name)
    print(cs.CARD)
    if not right:
        sys.exit("flash_bwd_fault_reach: a check gave the wrong verdict")


if __name__ == "__main__":
    main()
