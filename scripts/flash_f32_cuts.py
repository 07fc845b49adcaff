"""Where the f32 flash forward's time goes, on one NVIDIA GPU.

    python3 scripts/flash_f32_cuts.py [--json PATH]

Builds copies of ``csrc/flash_attention.cu`` (beside copies of the headers,
in a temporary directory) with one phase of the narrow ``flash_fwd_f32``
or of the whole-width ``flash_fwd_f32_256`` switched off, loads each in
place of the wrapper's library, and times the forward with chip_smoke.py's
``device_ms`` (CUDA-graph replay), twice in turns: the narrow kernel's cuts
at chip_smoke.py's f32 shapes "padded width 80", "offset rows" and "f32
ragged", the whole-width kernel's at "f32 D 256", "f32 D 520" and "f32
qwen3-next layer".  A cut kernel computes wrong outputs; only its time is
read.  The cuts, of either kernel:

* ``no P V``: the accumulating product O += P V is skipped;
* ``no S``: the score product S = Q K^T is skipped (scores of 0);
* ``no S, no P V``: both; what is left is the softmax, the loads, the
  barriers, the prologue and epilogue of each block, and the launch;
* ``no loads``: the next key tile's cp.async loads are not issued;
* ``no barrier``: the one ``__syncthreads`` a tile (an item of the
  whole-width kernel's ring) is dropped.

Then the sound kernel with the key split's minimum of 4 key tiles instead
of ``flash_attention.SPLIT_MIN_TILES`` (2), at the ragged shape and the
Pallas MQA shape.  Prints one line per variant and shape, then the card's
name and power limit.  Needs a CUDA device; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import functools
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (exits without a CUDA device)
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

PV = "    acc_quads<D, kAny, 4, kLdP>(acc, ps"
S = "    float sc[4][4];\n    dot_4x4<D, 4, 8>("
NO_PV = (PV, "    if (n_split < 0) " + PV.lstrip())
NO_S = (S, "    float sc[4][4] = {};\n"
             "    if (n_split < 0) dot_4x4<D, 4, 8>(")
NO_LOADS = ("    if (i + 1 < n_tiles) load_kv(i + 1, s ^ 1);",
            "    if (n_split < 0) load_kv(i + 1, s ^ 1);")
NO_BARRIER = ("    __syncthreads();  // tile i is in; every thread is done "
              "with tile i - 1", "")
# the whole-width kernel's (past 128 columns)
PV_256 = "      if (gg == g)\n        acc_piece<4, 1>(acc[gg], ps"
S_256 = "      dot_piece<4, 4, 1, 16>(sc, qp + row0 * ldq,"
LOADS_256 = "    if (i + kF32Stages - 1 < n_items) load("
BARRIER_256 = ("    __syncthreads();  // item i is in; every thread is done "
               "with item i - 1\n")
NO_PV_256 = (PV_256, PV_256.replace("(gg == g)", "(gg == g && n_split < 0)"))
NO_S_256 = (S_256, "      if (n_split < 0) " + S_256.lstrip())
NO_LOADS_256 = (LOADS_256, LOADS_256.replace("if (", "if (n_split < 0 && "))
NO_BARRIER_256 = (BARRIER_256, "")
CUTS = {"sound": [], "no P V": [NO_PV], "no S": [NO_S],
        "no S, no P V": [NO_PV, NO_S], "no loads": [NO_LOADS],
        "no barrier": [NO_BARRIER],
        "whole width: no P V": [NO_PV_256], "whole width: no S": [NO_S_256],
        "whole width: no S, no P V": [NO_PV_256, NO_S_256],
        "whole width: no loads": [NO_LOADS_256],
        "whole width: no barrier": [NO_BARRIER_256]}
CUT_SHAPES = ("padded width 80 D 80 float32", "offset rows", "f32 ragged")
WHOLE_SHAPES = ("f32 D 256", "f32 D 520", "f32 qwen3-next layer")
SPLIT_SHAPES = ("f32 ragged", "pallas MQA D 32 float32")


def time_shapes(names, reps: int = 20) -> dict[str, float]:
    """Device ms per forward call at chip_smoke.py's shapes ``names``."""
    out = {}
    for name, shape, dtype, kw in cs.FLASH_SHAPES:
        if name in names:
            args = cs.flash_inputs(shape, dtype, seed=1)
            out[name] = cs.device_ms(
                functools.partial(fa.flash_attention_cuda, **kw), args, reps)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", help="also write the readings here")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        paths = kbuild.edited_copies(fa.SRC, CUTS, Path(tmp))
        kbuild.build(*((path, fa.NVCC_FLAGS) for path in paths.values()))
        readings: dict = {}
        for _ in range(2):                       # two rounds, in turns
            for name, path in paths.items():
                kbuild.use_copy(fa, path)
                shapes = (WHOLE_SHAPES if name.startswith("whole width")
                          else CUT_SHAPES + WHOLE_SHAPES if name == "sound"
                          else CUT_SHAPES)
                for shape, ms in time_shapes(shapes).items():
                    readings.setdefault(name, {}).setdefault(
                        shape, []).append(ms)
        kbuild.use_copy(fa, paths["sound"])
        for min_tiles in (fa.SPLIT_MIN_TILES, 4):
            fa.SPLIT_MIN_TILES = min_tiles
            for shape, ms in time_shapes(SPLIT_SHAPES).items():
                readings.setdefault(f"split of {min_tiles}+ key tiles", {})[
                    shape] = [ms]
    for name, by_shape in readings.items():
        for shape, ms in by_shape.items():
            print(f"{name}: {shape}: {', '.join(f'{x!r}' for x in ms)} ms")
    print(cs.CARD)
    if args.json:
        Path(args.json).write_text(
            json.dumps({"card": cs.CARD, "readings": readings}, indent=1))


if __name__ == "__main__":
    main()
