"""Render the dry-run JSON cache into the roofline tables: the port of
``repro.analysis.report``.

    PYTHONPATH=src python -m repro_torch.analysis.report [RESULTS_DIR]

A cell record carries the reference's fields (``compile_s`` is the trace's
wall time in the port), so the same records give the same rows.
"""
from __future__ import annotations

import glob
import json
import os
import sys

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
ARCH_ORDER = [
    "phi3-mini-3.8b", "qwen3-32b", "gemma2-27b", "internlm2-1.8b",
    "jamba-v0.1-52b", "whisper-large-v3", "mamba2-130m",
    "qwen3-moe-235b-a22b", "granite-moe-1b-a400m", "qwen2-vl-72b",
]
RESULTS_DIR = "results/dryrun_torch"


def load_cells(results_dir: str = RESULTS_DIR) -> list[dict]:
    cells = []
    for path in sorted(glob.glob(os.path.join(results_dir, "*.json"))):
        with open(path) as f:
            cells.append(json.load(f))
    return cells


def _fmt_ms(s: float) -> str:
    if s >= 1.0:
        return f"{s:.2f}s"
    return f"{s * 1e3:.1f}ms"


def roofline_table(cells: list[dict], mesh: str) -> str:
    rows = [
        "| arch | shape | compute | memory | collective | bottleneck | "
        "useful-FLOP frac | MFU bound | resid GB |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    index = {(c["arch"], c["shape"]): c for c in cells
             if c.get("mesh") == mesh}
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            c = index.get((arch, shape))
            if c is None:
                continue
            if "skipped" in c:
                rows.append(f"| {arch} | {shape} | — | — | — | "
                            f"skipped: {c['skipped'][:46]} | — | — | — |")
                continue
            if "error" in c:
                rows.append(f"| {arch} | {shape} | ERROR | | | | | | |")
                continue
            r = c["roofline"]
            rows.append(
                f"| {arch} | {shape} | {_fmt_ms(r['compute_s'])} | "
                f"{_fmt_ms(r['memory_s'])} | {_fmt_ms(r['collective_s'])} | "
                f"{r['bottleneck']} | {r['useful_flop_fraction']:.2f} | "
                f"{100 * r['roofline_fraction']:.1f}% | "
                f"{c['memory_model']['residency_bytes'] / 1e9:.2f} |"
            )
    return "\n".join(rows)


def dryrun_table(cells: list[dict], mesh: str) -> str:
    rows = [
        "| arch | shape | compile | HLO flops/dev | coll eff bytes/dev | "
        "collective mix | params |",
        "|---|---|---|---|---|---|---|",
    ]
    index = {(c["arch"], c["shape"]): c for c in cells
             if c.get("mesh") == mesh}
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            c = index.get((arch, shape))
            if c is None or "skipped" in c or "error" in c:
                continue
            r = c["roofline"]
            mix = ", ".join(
                f"{k}:{int(v)}" for k, v in sorted(
                    r["collective_counts"].items())
            )
            rows.append(
                f"| {arch} | {shape} | {c['compile_s']:.0f}s | "
                f"{r['flops_per_device']:.2e} | "
                f"{r['collective_effective_bytes']:.2e} | {mix} | "
                f"{c['params'] / 1e9:.1f}B |"
            )
    return "\n".join(rows)


def main(results_dir: str = RESULTS_DIR) -> None:
    cells = load_cells(results_dir)
    for mesh in ("single", "multi"):
        n_ok = sum(1 for c in cells if c.get("mesh") == mesh
                   and "roofline" in c)
        n_skip = sum(1 for c in cells if c.get("mesh") == mesh
                     and "skipped" in c)
        n_err = sum(1 for c in cells if c.get("mesh") == mesh
                    and "error" in c)
        print(f"== {mesh}: {n_ok} traced, {n_skip} skipped, "
              f"{n_err} errors ==")
        print(roofline_table(cells, mesh))
        print()


if __name__ == "__main__":
    main(*sys.argv[1:2])
