"""The flash kernels in two checkouts, in turns, on one NVIDIA GPU: whether a
change to the kernels moved their times, shape by shape.

    python3 scripts/flash_width_ab.py OTHER_CHECKOUT [--json PATH]

Runs in OTHER_CHECKOUT, this checkout, this checkout and OTHER_CHECKOUT
again, each in a process of its own that builds both flash libraries of its
checkout, then times the forward (``flash_attention_cuda``) and the
backward (``flash_attention_bwd_cuda``) at every shape of this checkout's
chip_smoke.py phases 1-2 (``FLASH_SHAPES``, ``FLASH_BWD_SHAPES``: bf16
and f32, the narrow, padded, native (bf16 136-256) and wide widths among
them; both checkouts run the same shapes, each through its own plan, so a
width the two route to different kernels sets one against the other), on
the inputs each checkout's chip_smoke.py makes, with chip_smoke.py's
``device_ms`` (CUDA-graph replay: eager calls of many milliseconds, timed
with events, spread by ~10% between runs at some shapes; 5 replays of
those, 200 of calls under 2^22 (query, key) pairs, whose ~10 us a graph of
20 left within ~5% of each other).  Each process drives its own checkout's
wrappers, so the C
entry points may differ between the two.  Prints one JSON line per
checkout and run, then, per kernel and shape both checkouts have, the two
runs of each and the change's mean over the other's, then the card's name
and power limit; ``--json`` also writes all of it to PATH.  Comparing two
commits in one call, in turns, keeps the card and its host the same for
both.  Needs a CUDA device; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

RUN = """
import json, sys
sys.path.insert(0, '.')
sys.path.insert(0, 'src')
import torch
import chip_smoke as cs
from repro_torch.kernels import build, flash_attention as fa
build.build((fa.SRC, fa.NVCC_FLAGS), (fa.SRC_BWD, fa.NVCC_FLAGS))


def timer(shape):
    b, hq, hk, sq, sk, d = shape
    pairs = b * hq * sq * sk
    return cs.device_ms, 5 if pairs >= 2**27 else 20 if pairs >= 2**22 else 200


fwd_shapes, bwd_shapes = json.loads(sys.argv[1])
out = {"forward": {}, "backward": {}}
for i, (name, shape, dtype, kw) in enumerate(fwd_shapes):
    dtype = getattr(torch, dtype)
    q, k, v = cs.flash_inputs(shape, dtype, seed=100 + i)
    fn, reps = timer(shape)
    out["forward"][name] = fn(lambda *a: fa.flash_attention_cuda(*a, **kw),
                              (q, k, v), reps)
    del q, k, v
for i, (name, shape, dtype, kw) in enumerate(bwd_shapes):
    dtype = getattr(torch, dtype)
    q, k, v, do = cs.flash_bwd_inputs(name, shape, dtype, i)
    o, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    fn, reps = timer(shape)
    out["backward"][name] = fn(
        lambda *a: fa.flash_attention_bwd_cuda(*a, **kw),
        (q, k, v, o, lse, do), reps)
    del q, k, v, do, o, lse
    torch.cuda.empty_cache()
print(json.dumps(out))
"""


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="the other checkout (e.g. an unpacked "
                    "git archive of the parent under build/)")
    ap.add_argument("--json", help="also write the runs and the summary here")
    args = ap.parse_args()
    here = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(here))
    import chip_smoke as cs  # exits without a CUDA device
    shapes = json.dumps([[(name, shape, str(dtype).split(".")[1], kw)
                          for name, shape, dtype, kw in table]
                         for table in (cs.FLASH_SHAPES, cs.FLASH_BWD_SHAPES)])
    other = Path(args.other).resolve()
    runs = []
    for tree in (other, here, here, other):
        proc = subprocess.run([sys.executable, "-c", RUN, shapes], cwd=tree,
                              capture_output=True, text=True, timeout=1200)
        if proc.returncode != 0:
            sys.exit(f"{tree} failed:\n{proc.stdout[-2000:]}"
                     f"{proc.stderr[-4000:]}")
        run = {"checkout": str(tree),
               **json.loads(proc.stdout.splitlines()[-1])}
        runs.append(run)
        print(json.dumps(run), flush=True)
    summary = []
    for kernel in ("forward", "backward"):
        for name in runs[1][kernel]:
            if name not in runs[0][kernel]:
                continue
            theirs = [runs[0][kernel][name], runs[3][kernel][name]]
            mine = [runs[1][kernel][name], runs[2][kernel][name]]
            summary.append({"kernel": kernel, "shape": name,
                            "other_ms": theirs, "this_ms": mine,
                            "ratio": sum(mine) / sum(theirs)})
            print(f"{kernel} {name}: other {theirs[0]!r}, {theirs[1]!r} ms; "
                  f"this {mine[0]!r}, {mine[1]!r} ms; this / other "
                  f"{summary[-1]['ratio']:.4f}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(
            {"card": card, "runs": runs, "summary": summary}, indent=1))


if __name__ == "__main__":
    main()
