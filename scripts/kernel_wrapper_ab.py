"""The kernels' wrappers in two checkouts, in turns, on one NVIDIA GPU: what
the host adds to a call.

    python3 scripts/kernel_wrapper_ab.py OTHER_CHECKOUT

Runs in OTHER_CHECKOUT, this checkout, this checkout and OTHER_CHECKOUT
again, each in a process of its own that builds the SSD scan and the flash
forward first, then times, at the training shapes chip_smoke.py times
(mamba2-130m's scan, bf16 (8, 2048, 24, 64, 1, 128) in chunks of 128;
internlm2-1.8b's attention, bf16 (8, 16, 8, 2048, 2048, 128), causal):

- ``events``: CUDA events around 5 eager calls after a warm-up, as
  chip_smoke.py's ``events_ms`` times the kernels (host cost shows only
  where it outlasts the device's);
- ``graph``: 5 calls captured in one CUDA graph and replayed
  (``device_ms``), the device's time alone;
- ``host_us``: wall time per call of 200 eager calls at a tiny shape (the
  scan at (1, 64, 2, 64, 1, 64), attention at (1, 1, 1, 64, 64, 64)), each
  call's device work a few microseconds, so the loop is the host's own
  cost: the wrapper's checks, its plan and its dispatch.

Prints one JSON line per checkout and run.  Comparing two commits in one
call, in turns, keeps the card and its host the same for both.  Needs a
CUDA device; imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

RUN = """
import json, sys, time
sys.path.insert(0, '.')
sys.path.insert(0, 'src')
import torch
import chip_smoke as cs
from repro_torch.kernels import build, flash_attention as fa, ssd_scan as ssd
build.build((ssd.SRC, ssd.NVCC_FLAGS), (fa.SRC, fa.NVCC_FLAGS))


def host_us(fn, args, reps=200):
    for _ in range(20):
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    return wall / reps * 1e6


def scan(*a):
    return ssd.ssd_scan_cuda(*a, chunk=128)


def attn(*a):
    return fa.flash_attention_cuda(*a, causal=True)


out = {}
with torch.no_grad():
    for name, fn, big, tiny in (
            ("ssd_scan", scan,
             cs.ssd_inputs((8, 2048, 24, 64, 1, 128), torch.bfloat16, 1),
             cs.ssd_inputs((1, 64, 2, 64, 1, 64), torch.bfloat16, 2)),
            ("flash_fwd", attn,
             cs.flash_inputs((8, 16, 8, 2048, 2048, 128), torch.bfloat16, 3),
             cs.flash_inputs((1, 1, 1, 64, 64, 64), torch.bfloat16, 4))):
        out[name] = {"events_ms": [], "graph_ms": [], "host_us": []}
        for _ in range(3):
            out[name]["events_ms"].append(cs.events_ms(fn, big, 5))
            out[name]["graph_ms"].append(cs.device_ms(fn, big, 5))
            out[name]["host_us"].append(host_us(fn, tiny))
print("AB " + json.dumps(out))
"""


def main() -> None:
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    here = Path(__file__).resolve().parents[1]
    other = Path(sys.argv[1]).resolve()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for name, root in (("other", other), ("this", here), ("this", here),
                       ("other", other)):
        out = subprocess.run([sys.executable, "-c", RUN], cwd=root,
                             capture_output=True, text=True, timeout=900)
        if out.returncode:
            sys.exit(f"{root}: exit {out.returncode}\n{out.stderr[-3000:]}")
        for line in out.stdout.splitlines():
            if line.startswith("AB "):
                print(json.dumps({"checkout": name, "root": str(root),
                                  **json.loads(line[3:])}), flush=True)


if __name__ == "__main__":
    main()
