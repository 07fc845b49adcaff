"""The SSD scan's kernels in two checkouts, in turns, on one NVIDIA GPU:
whether a change to the kernels moved their times, shape by shape.

    python3 scripts/ssd_kernel_ab.py OTHER_CHECKOUT [--json PATH]

Runs in OTHER_CHECKOUT, this checkout, this checkout and OTHER_CHECKOUT
again, each in a process of its own that builds its checkout's two SSD
libraries, then times the forward (``ssd_scan_cuda``) and the backward
(``ssd_scan_bwd_cuda``) at every shape of this checkout's chip_smoke.py
``SSD_SHAPES`` (bf16 and f32) that both checkouts' plans take (an older
checkout refuses the corners of the Pallas kernel's domain), on the inputs
chip_smoke.py makes for them:
the device time a call by CUDA-graph replay (chip_smoke's ``device_ms``:
the host's enqueue drops out), and each launch's device time from a
profile of 3 eager calls.  Each process drives its own checkout's
wrappers, so the C entry points may differ between the two.  Prints one
JSON line per checkout and run, then, per kernel and shape, the two runs of
each and the change's mean over the other's, then the card's name and
power limit; ``--json`` also writes all of it to PATH.  Needs a CUDA
device; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

RUN = """
import json, re, sys
sys.path.insert(0, '.')
sys.path.insert(0, 'src')
import torch
import chip_smoke as cs
from repro_torch.kernels import build, ssd_scan as ssd
build.build((ssd.SRC, ssd.NVCC_FLAGS), (ssd.SRC_BWD, ssd.NVCC_FLAGS))
shapes = json.loads(sys.argv[1])


def inputs(shape, dtype, seed):
    b, s, h, p, g, n = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *d: torch.randn(*d, device="cuda", generator=gen)
    x = (rnd(b, s, h, p) * 0.5).to(dtype)
    dt = torch.rand(b, s, h, device="cuda", generator=gen) * 0.099 + 0.001
    A = -torch.linspace(1.0, 16.0, h, device="cuda")
    Bm, Cm = ((rnd(b, s, g, n) * 0.3).to(dtype) for _ in range(2))
    D = torch.rand(h, device="cuda", generator=gen)
    dy = torch.randn(b, s, h, p, device="cuda",
                     generator=torch.Generator("cuda").manual_seed(seed + 1)
                     ).to(dtype)
    return (x, dt, A, Bm, Cm, D), dy


def profiled(fn, args):
    fn(*args)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn(*args)
        torch.cuda.synchronize()
    return cs.ssd_phase_ms(cs.device_time_by_name(prof), 3)


out = {"forward": {}, "backward": {}, "forward_launches": {},
       "backward_launches": {}}
for i, (name, shape, dtype, chunk) in enumerate(shapes):
    dtype = getattr(torch, dtype)
    try:    # a checkout whose kernels do not take the shape skips it
        ssd.kernel_plan(*shape, chunk, dtype)
    except ValueError:
        continue
    args, dy = inputs(shape, dtype, 700 + i)
    fwd = lambda *a: ssd.ssd_scan_cuda(*a, chunk=chunk)
    bwd = lambda *a: ssd.ssd_scan_bwd_cuda(*a, chunk=chunk)
    out["forward"][name] = cs.device_ms(fwd, args, 5)
    out["backward"][name] = cs.device_ms(bwd, args + (dy,), 3)
    out["forward_launches"][name] = profiled(fwd, args)
    out["backward_launches"][name] = profiled(bwd, args + (dy,))
    del args, dy
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
    shapes = json.dumps([(name, shape, str(dtype).split(".")[1], chunk)
                         for name, shape, dtype, chunk, _ in cs.SSD_SHAPES])
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
            if not all(name in r[kernel] for r in runs):
                continue    # a shape one checkout does not take
            theirs = [runs[0][kernel][name], runs[3][kernel][name]]
            mine = [runs[1][kernel][name], runs[2][kernel][name]]
            launches = {k: sum(r[f"{kernel}_launches"][name].values())
                        for k, r in (("other", runs[0]), ("this", runs[1]))}
            summary.append({"kernel": kernel, "shape": name,
                            "other_ms": theirs, "this_ms": mine,
                            "ratio": sum(mine) / sum(theirs),
                            "launches_ms": launches})
            print(f"{kernel} {name}: other {theirs[0]!r}, {theirs[1]!r} ms; "
                  f"this {mine[0]!r}, {mine[1]!r} ms; this / other "
                  f"{summary[-1]['ratio']:.4f}; profiled launches other "
                  f"{launches['other']!r} ms, this {launches['this']!r} ms")
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
