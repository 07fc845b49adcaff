"""The flash kernels at the head widths they took before (64, 96, 128) in two
checkouts, in turns, on one NVIDIA GPU: whether widening the kernels to
every width moved the times of the old ones.

    python3 scripts/flash_width_ab.py OTHER_CHECKOUT

Runs in OTHER_CHECKOUT, this checkout, this checkout and OTHER_CHECKOUT
again, each in a process of its own that builds both flash libraries of its
checkout, then times the forward (``flash_attention_cuda``) and the
backward (``flash_attention_bwd_cuda``) at chip_smoke.py's shapes of those
widths (the serving prefill, 8,192 tokens, a gemma2-27b local layer, phi3's
D 96, granite-moe's and whisper's D 64, the f32 ones; the backward at
internlm2's, phi3's, granite-moe's and whisper's training shapes and the
f32 offset rows), with chip_smoke.py's own timers (``device_ms``: CUDA-graph
replay; ``events_ms`` for calls of many milliseconds).  The kernels' C entry
points have the same signature in both, so each process drives its own
checkout's wrappers.  Prints one JSON line per checkout and run, then the
card's name and power limit.  Comparing two commits in one call, in turns,
keeps the card and its host the same for both.  Needs a CUDA device;
imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

FWD = [
    ("serving prefill", (1, 16, 8, 512, 512, 128), "bfloat16", {}),
    ("long prefill", (1, 16, 8, 8192, 8192, 128), "bfloat16", {}),
    ("gemma2-27b local layer", (1, 32, 16, 8192, 8192, 128), "bfloat16",
     {"window": 4096, "softcap": 50.0}),
    ("phi3 head dim", (2, 32, 32, 1024, 1024, 96), "bfloat16", {}),
    ("granite-moe prefill", (1, 16, 8, 512, 512, 64), "bfloat16", {}),
    ("whisper encoder", (2, 20, 20, 1500, 1500, 64), "bfloat16",
     {"causal": False}),
    ("whisper cross decode", (2, 20, 20, 1, 1500, 64), "bfloat16",
     {"causal": False}),
    ("f32 ragged", (2, 4, 2, 300, 300, 64), "float32", {}),
    ("offset rows", (1, 16, 8, 128, 1000, 128), "float32", {}),
]
BWD = [
    ("internlm2 training", (8, 16, 8, 2048, 2048, 128), "bfloat16", {}),
    ("phi3 head dim", (1, 32, 32, 1024, 1024, 96), "bfloat16", {}),
    ("granite-moe training", (4, 16, 8, 2048, 2048, 64), "bfloat16", {}),
    ("whisper cross", (2, 20, 20, 64, 1500, 64), "bfloat16",
     {"causal": False}),
    ("f32 offset rows", (1, 16, 16, 128, 1000, 128), "float32", {}),
]

RUN = """
import json, sys
sys.path.insert(0, '.')
sys.path.insert(0, 'src')
import torch
import chip_smoke as cs
from repro_torch.kernels import build, flash_attention as fa
build.build((fa.SRC, fa.NVCC_FLAGS), (fa.SRC_BWD, fa.NVCC_FLAGS))
fwd, bwd = json.loads(sys.argv[1]), json.loads(sys.argv[2])


def timer(shape):
    b, hq, hk, sq, sk, d = shape
    return (cs.events_ms, 3) if b * hq * sq * sk >= 2**27 else (cs.device_ms, 20)


out = {"forward": {}, "backward": {}}
for name, shape, dtype, kw in fwd:
    kw = {"causal": True, **kw}
    q, k, v = cs.flash_inputs(tuple(shape), getattr(torch, dtype), seed=1)
    fn, reps = timer(shape)
    out["forward"][name] = fn(lambda *a: fa.flash_attention_cuda(*a, **kw),
                              (q, k, v), reps)
    del q, k, v
for name, shape, dtype, kw in bwd:
    kw = {"causal": True, **kw}
    b, hq, hk, sq, sk, d = shape
    q, k, v = cs.flash_inputs(tuple(shape), getattr(torch, dtype), seed=2)
    do = cs.flash_inputs((b, hq, hq, sq, sq, d), getattr(torch, dtype),
                         seed=3)[0]
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
    if len(sys.argv) != 2:
        sys.exit("usage: flash_width_ab.py OTHER_CHECKOUT")
    here = Path(__file__).resolve().parents[1]
    other = Path(sys.argv[1]).resolve()
    for tree in (other, here, here, other):
        proc = subprocess.run(
            [sys.executable, "-c", RUN, json.dumps(FWD), json.dumps(BWD)],
            cwd=tree, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            sys.exit(f"{tree} failed:\n{proc.stdout[-2000:]}"
                     f"{proc.stderr[-4000:]}")
        print(json.dumps({"checkout": str(tree),
                          **json.loads(proc.stdout.splitlines()[-1])}),
              flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())


if __name__ == "__main__":
    main()
