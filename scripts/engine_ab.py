"""Row events/s of the engine campaign in two checkouts, in turns, on one
NVIDIA GPU.

    python3 scripts/engine_ab.py OTHER_CHECKOUT

Runs chip_smoke.py's phases 3 and 4 (the paper anchors, then the 1024-row
Fig. 9/10 campaign at 10,000 hosts, three times) in OTHER_CHECKOUT, this
checkout, this checkout and OTHER_CHECKOUT again, each in a process of its
own that builds the advance-sweep kernel first, and prints each campaign's
line (wall time, batch steps, row events/s).  Comparing two commits in one
call, in turns, keeps the card and its host the same for both.  Needs a
CUDA device; imports nothing of JAX.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

RUN = """
import sys
sys.path.insert(0, '.')
import chip_smoke as cs
from repro_torch.kernels import build, vm_update
build.build((vm_update.SRC, vm_update.NVCC_FLAGS))
solo, _ = cs.phase_anchors()
for _ in range(3):
    cs.phase_campaign(solo)
"""


def main() -> None:
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    here = Path(__file__).resolve().parents[1]
    other = Path(sys.argv[1]).resolve()
    for name, root in (("other", other), ("this", here), ("this", here),
                       ("other", other)):
        print(f"=== {name}: {root}", flush=True)
        out = subprocess.run([sys.executable, "-c", RUN], cwd=root,
                             capture_output=True, text=True, timeout=600)
        if out.returncode:
            sys.exit(f"{root}: exit {out.returncode}\n{out.stderr[-3000:]}")
        for line in out.stdout.splitlines():
            if "campaign:" in line:
                print(line, flush=True)


if __name__ == "__main__":
    main()
