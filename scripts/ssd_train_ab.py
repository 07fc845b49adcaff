"""mamba2-130m's training in two checkouts, in turns, on one NVIDIA GPU:
whether a change to the SSD kernels moved a training step.

    python3 scripts/ssd_train_ab.py OTHER_CHECKOUT [--json PATH]

Runs in OTHER_CHECKOUT, this checkout, this checkout and OTHER_CHECKOUT
again, each in a process of its own that builds its checkout's SSD
libraries and trains mamba2-130m at full width and depth with
``run_training`` as chip_smoke.py's phase 8 does (``TRAIN``: 20 steps of
8 x 2,048 tokens, bf16 compute, f32 weights and AdamW, remat), then
profiles 2 more steps.  Each process prints one JSON line: the mean step
time after the first, tokens/s, the peak device memory, the SSD kernels'
launches, the first and last losses, and the profiled steps' device time,
idle share and SSD kernels' device time.  Prints the four lines, then each
checkout's mean of its two runs and the change's over the other's, then the
card's name and power limit; ``--json`` also writes all of it to PATH.
Needs a CUDA device; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

RUN = """
import json, re, sys, time
sys.path.insert(0, '.')
sys.path.insert(0, 'src')
import torch
import chip_smoke as cs
from repro_torch.configs import get_config
from repro_torch.data import ShardedLoader
from repro_torch.kernels import build, ssd_scan as ssd
from repro_torch.launch.train import run_training
from repro_torch.models import build_model
from repro_torch.train import OptConfig, adamw_init, make_train_step

sources = [(ssd.SRC, ssd.NVCC_FLAGS)]
if hasattr(ssd, "SRC_BWD"):
    sources.append((ssd.SRC_BWD, ssd.NVCC_FLAGS))
build.build(*sources)
cfg = get_config(cs.TRAIN_ARCH)
torch.cuda.reset_peak_memory_stats()
out = run_training(cfg, **{**cs.TRAIN, "log_every": 0})
peak = torch.cuda.max_memory_allocated() / 2**30
after = out["step_seconds"][1:]
model = build_model(cfg)
step_fn = make_train_step(model, OptConfig(lr=cs.TRAIN["lr"]))
params, opt_state = out["params"], adamw_init(out["params"])
loader = ShardedLoader(cfg.vocab, cs.TRAIN["global_batch"],
                       cs.TRAIN["seq_len"], seed=1)
batches = [{k: torch.from_numpy(v).cuda() for k, v in next(loader).items()}
           for _ in range(2)]
loader.close()
torch.cuda.synchronize()
with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    for batch in batches:
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        float(metrics["loss"])
    wall = time.perf_counter() - t0
by_name = cs.device_time_by_name(prof)
busy = sum(ms for ms, _ in by_name.values())
ssd_ms = {}
for name, (ms, _) in by_name.items():
    found = re.search(r"ssd_(?:fwd|bwd)\\w*", name)
    if found:
        ssd_ms[found.group(0)] = ssd_ms.get(found.group(0), 0.0) + ms / 2
print(json.dumps({
    "step_s": sum(after) / len(after), "tokens_per_s": out["tokens_per_sec"],
    "peak_gib": peak, "ssd_launches": out["ssd_launches"],
    "ssd_bwd_launches": out.get("ssd_bwd_launches"),
    "first_loss": out["losses"][0], "last_loss": out["losses"][-1],
    "profiled_device_ms_a_step": busy / 2,
    "profiled_idle_share": 1 - busy / 1e3 / wall,
    "ssd_device_ms_a_step": ssd_ms}))
"""


def run(where: Path) -> dict:
    proc = subprocess.run([sys.executable, "-c", RUN], cwd=where,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        sys.exit(f"ssd_train_ab: the run in {where} failed:\n"
                 f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", type=Path)
    ap.add_argument("--json", type=Path)
    args = ap.parse_args()
    here = Path(__file__).resolve().parents[1]
    other = args.other.resolve()
    runs = {"other": [], "this": []}
    for which in ("other", "this", "this", "other"):
        rec = run(other if which == "other" else here)
        runs[which].append(rec)
        print(which, json.dumps(rec), flush=True)
    mean = {which: {k: sum(r[k] for r in recs) / len(recs)
                    for k in ("step_s", "tokens_per_s", "peak_gib",
                              "profiled_device_ms_a_step",
                              "profiled_idle_share")}
            for which, recs in runs.items()}
    ratio = {k: mean["this"][k] / mean["other"][k] for k in mean["this"]}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print("mean", json.dumps(mean))
    print("this over other", json.dumps(ratio))
    print(card)
    if args.json:
        args.json.write_text(json.dumps({"runs": runs, "mean": mean,
                                         "ratio": ratio, "card": card},
                                        indent=1))


if __name__ == "__main__":
    main()
