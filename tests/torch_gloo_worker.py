"""One rank of a multi-process test of ``repro_torch.dist`` over gloo.

    PYTHONPATH=src python tests/torch_gloo_worker.py CASE RANK WORLD DIR

Reads ``DIR/in.npz`` and ``DIR/args.json``, joins a gloo world of WORLD
ranks through a ``FileStore`` in DIR, runs CASE and writes ``DIR/out<RANK>
.npz``.  It imports torch, numpy and ``repro_torch`` only; the tests of
``tests/test_torch_dist_gloo.py`` compute the reference's values in their
own process and start one of these per rank.
"""
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.dist import activation_shardings
from repro_torch.launch.mesh import make_host_mesh


def _tree_from(flat: dict, prefix: str) -> dict:
    """The nested dict of tensors stored under ``prefix/...`` keys."""
    out: dict = {}
    for k, v in flat.items():
        if not k.startswith(prefix + "/"):
            continue
        node = out
        parts = k[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.from_numpy(v)
    return out


def _flat(values, prefix: str) -> dict:
    return {f"{prefix}/{tree.key(p)}": v.detach().numpy()
            for p, v in tree.leaves_with_path(values)}


def case_moe(mesh, args, data) -> dict:
    """The expert-parallel MoE layer against the local path: outputs, the
    balance loss and the gradients of a weighted sum of both."""
    from repro_torch.models import moe

    cfg = get_config(args["arch"], smoke=True)
    params = _tree_from(data, "params")
    x = torch.from_numpy(data["x"])
    w = torch.from_numpy(data["w"])
    out = {}
    for name in ("local", "ep"):
        p = tree.map_tree(lambda t: t.clone().requires_grad_(True), params)
        xx = x.clone().requires_grad_(True)
        if name == "local":
            y, aux = moe._moe_local(p, cfg, xx)
        else:
            with activation_shardings(
                    mesh, sequence_parallel=args["sequence_parallel"]):
                y, aux = moe.moe_apply(p, cfg, xx)
            out["schedule"] = np.array(moe._moe_shard_map.schedule)
        ((y * w).sum() + 3.0 * aux).backward()
        out[f"{name}/y"] = y.detach().numpy()
        out[f"{name}/aux"] = aux.detach().numpy()
        out[f"{name}/dx"] = xx.grad.numpy()
        out.update(_flat(tree.map_tree(lambda t: t.grad, p),
                         f"{name}/grads"))
    return out


def case_decode(mesh, args, data) -> dict:
    """One decode step after a prefill, with the caches split on their
    length over ``model`` and without."""
    from repro_torch.models import build_model

    cfg = get_config(args["arch"], smoke=True)
    model = build_model(cfg)
    params = _tree_from(data, "params")
    toks = torch.from_numpy(data["tokens"])
    S, L = args["S"], args["L"]
    out = {}
    with torch.no_grad():
        _, caches = model.prefill(params, {"tokens": toks[:, :S - 2]}, L)
        pos = torch.full((toks.shape[0],), S - 2, dtype=torch.int32)
        for name in ("plain", "sharded"):
            c = tree.map_tree(torch.clone, caches)
            if name == "plain":
                logits, c = model.decode_step(params, c,
                                              toks[:, S - 2][:, None], pos)
            else:
                with activation_shardings(mesh):
                    logits, c = model.decode_step(
                        params, c, toks[:, S - 2][:, None], pos)
            out[f"{name}/logits"] = logits.float().numpy()
            out.update(_flat(c, f"{name}/caches"))
    return out


def case_campaign(mesh, args, data) -> dict:
    """Fig. 4's four policy pairs twice over: the local run, and the
    campaign sharded over ``data`` whole, in chunks and folded."""
    from repro_torch.convert import result_to_numpy
    from repro_torch.core import (
        ArgBestReducer, SumReducer, ValuesReducer, run_campaign,
        run_campaign_sharded, scenarios, stack_scenarios)

    batched = stack_scenarios([
        scenarios.fig4_scenario(hp, vp, device="cpu")
        for hp in (0, 1) for vp in (0, 1)] * 2)
    runs = {
        "local": run_campaign(batched, device="cpu"),
        "sharded": run_campaign_sharded(batched, mesh, device="cpu"),
        "chunked": run_campaign(batched, chunk_size=4, device="cpu",
                                mesh=mesh),
    }
    out = {f"{name}/{k}": v for name, res in runs.items()
           for k, v in result_to_numpy(res).items()}
    reducers = lambda: {  # noqa: E731
        "events": SumReducer("n_events"),
        "best": ArgBestReducer("makespan"),
        "values": ValuesReducer("mean_turnaround", 8),
    }
    for name, kw in (("fold_local", {}), ("fold_sharded", {"mesh": mesh})):
        summary = run_campaign(batched, chunk_size=4, reduce=reducers(),
                               device="cpu", **kw)
        out[f"{name}/events"] = summary["events"].numpy()
        for k, v in summary["values"].items():
            out[f"{name}/values/{k}"] = v.numpy()
        out[f"{name}/best"] = np.array([float(summary["best"]["value"]),
                                        float(summary["best"]["index"])])
    return out


CASES = {"moe": case_moe, "decode": case_decode, "campaign": case_campaign}


def main() -> None:
    case, rank, world, where = sys.argv[1], int(sys.argv[2]), \
        int(sys.argv[3]), Path(sys.argv[4])
    args = json.loads((where / "args.json").read_text())
    data = dict(np.load(where / "in.npz"))
    dist.init_process_group("gloo", store=dist.FileStore(
        str(where / "store"), world), rank=rank, world_size=world)
    try:
        mesh = make_host_mesh(tuple(args["mesh"]),
                              tuple(args.get("axes", ("data", "model"))))
        out = CASES[case](mesh, args, data)
    finally:
        dist.destroy_process_group()
    np.savez(where / f"out{rank}.npz", **out)


if __name__ == "__main__":
    main()
