"""Pod-scale dry-run: trace every (arch x shape x mesh) cell on tensors
without data (the port of ``repro.launch.dryrun``).

For each cell this builds the full-size configuration and the production
mesh over a process group of the mesh's size, places shape-only parameters,
AdamW moments and inputs by ``repro_torch.dist``'s rule trees (``DTensor``s
whose local tensors are ``FakeTensorMode`` tensors: nothing is allocated),
runs the step once inside ``analysis.trace.StepTrace`` (torch's
``FlopCounterMode``, ``CommDebugMode`` and ``MemTracker``, counting this
rank's dot FLOPs, collectives and live bytes), and records them with the
analytic memory model and the roofline terms.  Train traces the sharded
step of ``train.make_train_step`` with ``param_shardings`` (forward, the
backward with the remat replay, AdamW); prefill and decode trace
``Model.prefill`` / ``decode_step``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internlm2-1.8b --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh multi

Without a process group it starts a ``"fake"`` one of 256 (or 512) ranks,
whose collectives move nothing, and destroys it at the end; it needs no
card, as the reference's needs no TPU (it lowers on 512 fake host
devices).  ``lower_cell`` traces the card's program on fake meta tensors,
which ``kernels.ops`` routes to the kernels' ops and their fake
implementations (a CPU-only torch cannot run autograd on fake CUDA
tensors); its ``device="cpu"`` traces the plain versions on fake CPU
tensors instead, which the FLOP comparison with the reference's HLO walk
reads.
Results are cached as JSON under ``results/dryrun_torch/`` (git-ignored),
with the reference's fields; ``compile_s`` holds the trace's wall time.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_leaves
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch import tree
from repro_torch.analysis import memory as memest, roofline
from repro_torch.analysis.trace import StepTrace
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.dist import activation_shardings
from repro_torch.dist import spmd
from repro_torch.dist.sharding import (
    axis_sizes, input_pspec_tree, named, param_pspec_tree, placements,
    spec_leaves)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import ALL_SHAPES, build_model, shape_applicable
from repro_torch.models.config import ShapeSpec
from repro_torch.train import OptConfig, make_train_step

RESULTS_DIR = "results/dryrun_torch"


def _shape_by_name(name: str) -> ShapeSpec:
    for s in ALL_SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


@contextlib.contextmanager
def fake_world(n: int):
    """A ``"fake"`` process group of ``n`` ranks (this process is rank 0)
    while inside, unless one exists already; destroyed on exit."""
    if dist.is_initialized():
        yield False
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield True
    finally:
        dist.destroy_process_group()


def _tensor_device(device) -> str:
    """Where the fake tensors live: meta for the card's program
    (``None``), the CPU for the plain versions (``"cpu"``)."""
    if device is None:
        return "meta"
    if device != "cpu":
        raise ValueError(f"device {device!r}: None (the card's program) or "
                         "'cpu' (the plain versions)")
    return "cpu"


def _placed(stand_ins, specs, mesh, device: str, dtype=None):
    """A tree of ``DTensor``s of the stand-ins' global shapes laid out by
    ``specs``, each holding an empty local block on ``device`` (inside a
    ``FakeTensorMode``: a fake one)."""
    from torch.distributed.tensor import DTensor

    sizes = axis_sizes(mesh)

    def one(leaf, spec):
        shape = list(leaf.shape)
        for d, entry in enumerate(spec):
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                if a is not None:
                    shape[d] //= sizes[a]
        dt = dtype if dtype is not None and leaf.dtype.is_floating_point \
            else leaf.dtype
        local = torch.empty(shape, dtype=dt, device=device)
        return DTensor.from_local(local, mesh, placements(mesh, spec),
                                  run_check=False, shape=leaf.shape,
                                  stride=_strides(leaf.shape))

    return tree.map_tree(one, stand_ins, specs)


def _strides(shape) -> tuple[int, ...]:
    out, acc = [], 1
    for d in reversed(tuple(shape)):
        out.append(acc)
        acc *= d
    return tuple(reversed(out))


def lower_cell(arch: str, shape: ShapeSpec, mesh, *, microbatches: int = 4,
               device=None, master_bf16: bool = False,
               sequence_parallel: bool = False, strategy: str = "2d",
               cfg=None) -> tuple[StepTrace, dict]:
    """Build and trace one cell on ``mesh`` (a ``DeviceMesh`` over a
    process group of its size).  Returns (the trace, meta: cfg, model,
    trace seconds, argument bytes)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = cfg if cfg is not None else get_config(arch, dtype="bfloat16")
    model = build_model(cfg)
    dev = _tensor_device(device)
    pshapes = model.param_specs()
    pspecs = param_pspec_tree(pshapes, mesh, strategy)
    # training holds f32 master weights; serving holds bf16 weights
    p_dtype = (torch.bfloat16 if master_bf16 or shape.kind != "train"
               else None)
    specs = model.input_specs(shape)
    in_specs = input_pspec_tree(specs, mesh, strategy)
    # a group over several mesh dims (the batch's ("pod", "data"), which
    # the microbatch split's all-to-all runs over) is a flattened mesh,
    # built from real rank tensors: made here, before the fake mode, and
    # kept by the mesh
    for spec in spec_leaves(in_specs):
        for entry in spec:
            if isinstance(entry, tuple) and len(entry) > 1:
                spmd.axis_group(mesh, entry)
    trace = StepTrace()
    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = _placed(pshapes, pspecs, mesh, dev, p_dtype)
        inputs = _placed(specs, in_specs, mesh, dev)
        held = [params, inputs]
        if shape.kind == "train":
            opt = {"mu": _placed(pshapes, pspecs, mesh, dev),
                   "nu": _placed(pshapes, pspecs, mesh, dev),
                   "step": torch.zeros((), dtype=torch.int32, device=dev)}
            held.append(opt)
        trace.track(held)
        arg_bytes = sum(_local_bytes(t) for t in tree_leaves(held))
        with activation_shardings(mesh, sequence_parallel=sequence_parallel,
                                  strategy=strategy), \
                implicit_replication(), trace:
            if shape.kind == "train":
                step = make_train_step(model, OptConfig(),
                                       microbatches=microbatches,
                                       param_shardings=named(mesh, pspecs))
                out = step(params, opt, inputs["batch"])
            elif shape.kind == "prefill":
                out = model.prefill(params, inputs["batch"], shape.seq_len)
            else:
                out = model.decode_step(params, inputs["caches"],
                                        inputs["token"], inputs["pos"])
        del out, held, params, inputs
    seconds = time.perf_counter() - t0
    return trace, {"cfg": cfg, "model": model, "trace_s": seconds,
                   "argument_bytes": arg_bytes}


def _local_bytes(t) -> int:
    if not isinstance(t, torch.Tensor):
        return 0
    local = getattr(t, "_local_tensor", t)
    return local.numel() * local.element_size()


def run_cell(arch: str, shape: ShapeSpec, mesh_kind: str,
             microbatches: int = 4, tag: str = "",
             sequence_parallel: bool = False, master_bf16: bool = False,
             moments_bf16: bool = False, strategy: str = "2d") -> dict:
    """One cell's record on the production mesh (``"single"``: (16, 16),
    ``"multi"``: (2, 16, 16)), over a fake process group of its size unless
    one of that size exists."""
    n = 512 if mesh_kind == "multi" else 256
    cfg = get_config(arch)
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape.name, "mesh": mesh_kind,
                "skipped": why}
    with fake_world(n):
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
        n_chips = math.prod(tuple(mesh.shape))
        walk, meta = lower_cell(
            arch, shape, mesh, microbatches=microbatches,
            master_bf16=master_bf16, sequence_parallel=sequence_parallel,
            strategy=strategy)
        est = memest.estimate(
            meta["model"], meta["cfg"], shape, mesh,
            microbatches=microbatches, sequence_parallel=sequence_parallel,
            master_bf16=master_bf16, moments_bf16=moments_bf16,
            strategy=strategy)
    rl = roofline.analyze_walk(walk, est, n_chips,
                               roofline.model_flops_for(meta["cfg"], shape))
    return {
        "arch": arch,
        "shape": shape.name,
        "mesh": mesh_kind,
        "n_chips": int(n_chips),
        "compile_s": meta["trace_s"],
        "microbatches": microbatches if shape.kind == "train" else None,
        "tag": tag,
        "memory": {
            "argument_bytes": int(meta["argument_bytes"]),
            "temp_bytes": int(walk.peak_bytes - meta["argument_bytes"]),
            "peak_bytes_est": int(walk.peak_bytes),
        },
        "params": int(meta["cfg"].param_count()),
        "active_params": int(meta["cfg"].active_param_count()),
        "memory_model": est.as_dict(),
        "trace_raw": {"kernel_calls": walk.kernel_calls,
                      "dot_flops": walk.dot_flops,
                      "coll_eff_by_kind": walk.coll_eff_by_kind},
        "roofline": rl.as_dict(),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS))
    ap.add_argument("--shape", choices=[s.name for s in ALL_SHAPES])
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    os.makedirs(RESULTS_DIR, exist_ok=True)
    if args.all:
        cells = [(a, s) for a in ARCH_IDS for s in ALL_SHAPES]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, _shape_by_name(args.shape))]

    for arch, shape in cells:
        path = os.path.join(RESULTS_DIR,
                            f"{arch}__{shape.name}__{args.mesh}.json")
        if os.path.exists(path) and not args.force:
            print(f"[skip cached] {arch} x {shape.name} x {args.mesh}")
            continue
        print(f"[dryrun] {arch} x {shape.name} x {args.mesh} ...", flush=True)
        try:
            out = run_cell(arch, shape, args.mesh,
                           microbatches=args.microbatches)
        except Exception:
            out = {"arch": arch, "shape": shape.name, "mesh": args.mesh,
                   "error": traceback.format_exc()}
        with open(path, "w") as f:
            json.dump(out, f, indent=2)
        if "error" in out:
            print(f"  ERROR (see {path})")
            print("  " + out["error"].strip().splitlines()[-1])
        elif "skipped" in out:
            print(f"  SKIPPED: {out['skipped']}")
        else:
            r = out["roofline"]
            print(
                "  ok trace=%.0fs resid=%.2fGB traced_peak=%.2fGB "
                "comp=%.1fms memT=%.1fms coll=%.1fms bneck=%s "
                "MFU-bound=%.1f%%"
                % (
                    out["compile_s"],
                    out["memory_model"]["residency_bytes"] / 1e9,
                    out["memory"]["peak_bytes_est"] / 1e9,
                    r["compute_s"] * 1e3,
                    r["memory_s"] * 1e3,
                    r["collective_s"] * 1e3,
                    r["bottleneck"],
                    100 * r["roofline_fraction"],
                ),
                flush=True,
            )


if __name__ == "__main__":
    main()
