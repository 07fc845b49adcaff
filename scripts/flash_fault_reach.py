"""How far ``chip_smoke.py``'s checks of the flash forward reach, on one
NVIDIA GPU.

    python3 scripts/flash_fault_reach.py

Builds ten broken copies of ``src/repro_torch/csrc/flash_attention.cu`` in
a temporary directory (beside a copy of the headers it includes), each with
one fault a pipelined kernel can have:

* ``dropped_tile``: rows that see more than 16 key tiles skip their first;
* ``stale_stage``: the last key tile of a row of more than 9 tiles takes V
  from the other stage of the shared-memory ring;
* ``missed_rescale``: every fourth key tile leaves O unrescaled;
* ``slice_only_s`` (the wide kernel past 256 columns): a block forms S
  over its own slice's columns only, not the whole head width;
* ``native_half_s`` (the native kernel, bf16 widths 136-256): S over the
  first 128 columns only;
* ``native_stale_v``: the native kernel's last P V of a row of more than 9
  key tiles (of 64) reads V from the other stage;
* ``native_missed_rescale``: the native kernel leaves O unrescaled after
  every fourth key tile;
* ``f32_half_s`` (the f32 whole-width kernel, f32 widths past 128): S over
  the first 128 columns only;
* ``f32_stale_v``: its last P V of a row of more than 9 key tiles (of 64)
  reads V from another stage of the ring;
* ``f32_missed_rescale``: it leaves O unrescaled after every fourth key
  tile.

The first three are faults of the narrow bf16 kernel, ``slice_only_s`` of
the wide one, the next three of the native one, the last three of the f32
whole-width one: each applies only at the shapes its kernel runs, and
where its rows (a key split's share of them) are long enough.

Runs the sound kernel and each copy at ``chip_smoke.py``'s bf16 shapes and
the f32 shapes of the whole-width kernel, and prints, for each, the
largest elementwise error and whether the elementwise check (2e-2 bf16,
2e-5 f32) passes, and the relative error of the whole output and of its
worst row against chip_smoke's limits.  Exits non-zero if the sound kernel
fails a check or a broken copy passes them all at a shape where its fault
applies.  Every line carries the card's name and power limit.  Imports
nothing of JAX or of the JAX package.
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

ANCHOR = "    kt_lo = first_col <= 0 ? 0 : first_col / kBk;\n  }\n"
RESCALE = "    for (int e = 0; e < kNo; ++e) acc_o[e] *= alpha[(e / 2) & 1];"
V_STAGE = "gmma_desc(v_s + s * kKVTile + kk * 16 * 128, kKVBox)"
WIDE_S = ("      piece_item(acc_s, ring, i, min(kSlice, d - p * kSlice), "
          "p == 0);  // S (+)= Q K^T\n")
NAT_S = ("      if (16 * kk >= d) break;  // the slices past d are zeros\n"
         "      wgmma_ss_n64(acc_s, k_major(qs, kNatQBox, kk)")
NAT_V = ("    const uint32_t vs = opaque(v_s + s * kNatKTile);\n"
         "    wgmma_fence();\n")
NAT_RESCALE = ("      for (int e = 0; e < kNatCols / 2; ++e) acc_o[e] *= "
               "alpha[(e / 2) & 1];")
F32_S = "                             min(kPiece, d - p * kPiece));\n"
F32_V = ("        acc_piece<4, 1>(acc[gg], ps + row0 * kLdS, kLdS, a + 4 * lx, "
         "kLdPiece, k_end);")
F32_RESCALE = "          for (int e = 0; e < 4; ++e) acc[g][r][e] *= alpha;"
FAULTS = {
    "dropped_tile": (ANCHOR, ANCHOR + "  if (kt_hi - kt_lo > 16) ++kt_lo;\n"),
    "stale_stage": (V_STAGE, "gmma_desc(v_s + ((i == n_tiles - 1 && i > 8) "
                    "? s ^ 1 : s) * kKVTile + kk * 16 * 128, kKVBox)"),
    "missed_rescale": (RESCALE, "    if (i % 4 != 3)\n" + RESCALE),
    "slice_only_s": (WIDE_S, "      piece_item(acc_s, ring, i, p * kSlice == "
                     "c0 ? min(kSlice, d - p * kSlice) : 0, p * kSlice == c0);"
                     "\n"),
    "native_half_s": (NAT_S, NAT_S.replace("16 * kk >= d)",
                                           "16 * kk >= (d < 128 ? d : 128))")),
    "native_stale_v": (NAT_V, NAT_V.replace(
        "v_s + s * kNatKTile)", "v_s + ((i == n_tiles - 1 && i > 8) ? s ^ 1 "
        ": s) * kNatKTile)")),
    "native_missed_rescale": (NAT_RESCALE, "      if (i % 4 != 3)\n"
                              + NAT_RESCALE),
    "f32_half_s": (F32_S, F32_S.replace("min(kPiece, d - p * kPiece)",
                                        "p < 2 ? min(kPiece, d - p * kPiece) "
                                        ": 0")),
    "f32_stale_v": (F32_V, F32_V.replace(
        "a + 4 * lx", "(i / per_tile == n_items / per_tile - 1 && n_items / "
        "per_tile > 9 ? ring + (i + 1) % kF32Stages * stage : a) + 4 * lx")),
    "f32_missed_rescale": (F32_RESCALE, F32_RESCALE.replace(
        "acc[g][r][e] *= alpha;", "if (i / per_tile % 4 != 3) acc[g][r][e] "
        "*= alpha;")),
}
# key tiles a row needs before the fault applies (128 keys a narrow tile,
# 64 a native or f32 whole-width one; the f32 kernel's rows within one key
# split)
MIN_TILES = {"sound": 0, "dropped_tile": 17, "stale_stage": 10,
             "missed_rescale": 4, "slice_only_s": 0, "native_half_s": 0,
             "native_stale_v": 10, "native_missed_rescale": 4,
             "f32_half_s": 0, "f32_stale_v": 10, "f32_missed_rescale": 4}


def f32_wide(shape, dtype) -> bool:
    """Whether ``shape`` in ``dtype`` runs the f32 whole-width kernel."""
    return dtype == torch.float32 and fa.native(shape[5], dtype)


def applies(name: str, shape, dtype) -> bool:
    """Whether the fault is in the kernel that runs ``shape`` in ``dtype``
    and the rows are long enough for it."""
    if name == "sound":
        return True
    if dtype == torch.float32:
        if not name.startswith("f32_"):
            return False
        b, hq, hk, sq, sk, d = shape
        split = fa.kernel_plan(b, hq, hk, sq, sk, d, dtype)["split"]
        tiles = -(-sk // 64)
        return -(-tiles // split) >= MIN_TILES[name] and (
            name != "f32_half_s" or fa.padded_width(d) > 128)
    native = fa.native(shape[5], torch.bfloat16)
    wide = fa.slices(shape[5], torch.bfloat16) > 1
    if name.startswith("f32_"):
        return False
    if name == "slice_only_s":
        return wide
    if name.startswith("native_"):
        return native and -(-shape[4] // 64) >= MIN_TILES[name]
    return not (wide or native) and \
        -(-shape[4] // fa.WGMMA_BLOCK_K) >= MIN_TILES[name]


def readings(name: str) -> bool:
    """Every bf16 shape and every f32 shape of the whole-width kernel
    through the library the wrapper has loaded; True if chip_smoke's checks
    give the verdict this kernel should get."""
    right = True
    for i, (label, shape, dtype, kw) in enumerate(cs.FLASH_SHAPES):
        if dtype != torch.bfloat16 and not f32_wide(shape, dtype):
            continue
        args = cs.flash_inputs(shape, dtype, seed=100 + i)
        out = fa.flash_attention_cuda(*args, **kw).float()
        want = ref.attention_ref(*args, **kw).float()
        diff = out - want
        err = float(diff.abs().max())
        close = bool(torch.allclose(out, want, rtol=cs.FLASH_TOL[dtype],
                                    atol=cs.FLASH_TOL[dtype]))
        rel = float(diff.norm() / want.norm())
        row = float((diff.norm(dim=-1)
                     / want.norm(dim=-1).clamp_min(1e-30)).max())
        passes = (close and rel < cs.FLASH_REL_TOL[dtype]
                  and row < cs.FLASH_ROW_TOL[dtype])
        hit = applies(name, shape, dtype)
        if name == "sound":
            right &= passes
        elif hit:
            right &= not passes
        cs.say(name, f"{label} {list(shape)} {kw}: max "
               f"|err| {err!r} (elementwise {cs.FLASH_TOL[dtype]}: "
               f"{'passes' if close else 'fails'}); relative error {rel!r} "
               f"(limit {cs.FLASH_REL_TOL[dtype]}), worst row {row!r} "
               f"(limit {cs.FLASH_ROW_TOL[dtype]}); "
               f"{'passes' if passes else 'fails'} chip_smoke's checks"
               f"{'' if hit else ' (the fault does not apply here)'}")
        del args, out, want, diff
        torch.cuda.empty_cache()
    return right


def main() -> None:
    right = readings("sound")
    paths = kbuild.edited_copies(
        fa.SRC, {k: [fault] for k, fault in FAULTS.items()},
        Path(tempfile.mkdtemp(prefix="flash_faults_")))
    kbuild.build(*((path, fa.NVCC_FLAGS) for path in paths.values()))
    for name, path in paths.items():
        kbuild.use_copy(fa, path)
        right &= readings(name)
    print(cs.CARD)
    if not right:
        sys.exit("flash_fault_reach: a check gave the wrong verdict")


if __name__ == "__main__":
    main()
