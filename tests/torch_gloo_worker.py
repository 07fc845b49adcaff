"""One rank of a multi-process test of ``repro_torch.dist`` over gloo.

    PYTHONPATH=src python tests/torch_gloo_worker.py CASE RANK WORLD DIR

Reads ``DIR/in.npz`` and ``DIR/args.json``, joins a gloo world of WORLD
ranks through a ``FileStore`` in DIR, runs CASE and writes ``DIR/out<RANK>
.npz``.  It imports torch, numpy and ``repro_torch`` only; the tests of
``tests/test_torch_dist_gloo.py`` compute the reference's values in their
own process and start one of these per rank (and so do those of
``tests/test_torch_train_sharded.py``).
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


def _nested(flat: dict, prefix: str) -> dict:
    """The nested dict of arrays stored under ``prefix/...`` keys."""
    out: dict = {}
    for k, v in flat.items():
        if k.startswith(prefix + "/"):
            node = out
            parts = k[len(prefix) + 1:].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = v
    return out


def case_train_sharded(mesh, args, data) -> dict:
    """``steps`` train steps of a smoke model in one process, then the same
    steps sharded over the mesh from the same parameters and batches:
    ``DTensor`` parameters from ``distribute`` of the one-process values by
    ``param_pspec_tree``, AdamW moments from ``adamw_init`` of them, each
    batch placed by ``input_pspec_tree``, ``param_shardings`` the
    parameters' placements (``named``), the step run inside
    ``activation_shardings``.  Each step's loss and grad norm, the last
    parameters of both, and whether every gradient reached AdamW in its
    parameter's placements and every updated leaf and moment kept them."""
    from repro_torch.convert import params_from_arrays
    from repro_torch.dist import (
        distribute, input_pspec_tree, named, param_pspec_tree)
    from repro_torch.models import build_model
    from repro_torch.train import OptConfig, adamw_init, make_train_step
    from repro_torch.train import step as step_mod

    cfg = get_config(args["arch"], smoke=True)
    model = build_model(cfg)
    opt_cfg = OptConfig(lr=args["lr"], warmup_steps=0)
    mb = args["microbatches"]
    params = params_from_arrays(_nested(data, "params"), device="cpu")
    batches = [{k: torch.from_numpy(data[f"{k}{i}"])
                for k in ("tokens", "labels")} for i in range(args["steps"])]
    out = {}
    step = make_train_step(model, opt_cfg, microbatches=mb)
    new, state = params, adamw_init(params)
    for i, batch in enumerate(batches):
        new, state, metrics = step(new, state, batch)
        out[f"plain/loss{i}"] = metrics["loss"].numpy()
        out[f"plain/grad_norm{i}"] = metrics["grad_norm"].numpy()
    out.update(_flat(new, "plain/params"))

    specs = param_pspec_tree(params, mesh)
    placed = distribute(mesh, params, specs)
    state = adamw_init(placed)
    step = make_train_step(model, opt_cfg, microbatches=mb,
                           param_shardings=named(mesh, specs))
    same = lambda a, b: tuple(a.placements) == tuple(b.placements)  # noqa
    seen = []
    adamw = step_mod.adamw_update

    def spy(grads, opt_state, ps, opt_cfg):
        seen.append([same(g, p) for g, p in zip(tree.leaves(grads),
                                                  tree.leaves(ps))])
        return adamw(grads, opt_state, ps, opt_cfg)

    step_mod.adamw_update = spy
    new = placed
    try:
        for i, batch in enumerate(batches):
            batch = distribute(mesh, batch, input_pspec_tree(
                {"batch": batch}, mesh)["batch"])
            with activation_shardings(mesh):
                new, state, metrics = step(new, state, batch)
            out[f"sharded/loss{i}"] = metrics["loss"].full_tensor().numpy()
            out[f"sharded/grad_norm{i}"] = (
                metrics["grad_norm"].full_tensor().numpy())
    finally:
        step_mod.adamw_update = adamw
    out["sharded/grads_placed"] = np.array([all(s) for s in seen])
    out["sharded/kept_placed"] = np.array(
        [same(a, b) for a, b in zip(tree.leaves(new), tree.leaves(placed))]
        + [same(a, b) for m in ("mu", "nu")
           for a, b in zip(tree.leaves(state[m]), tree.leaves(placed))])
    out.update(_flat(tree.map_tree(lambda t: t.full_tensor(), new),
                     "sharded/params"))
    return out


def _at(node, path):
    for k in path:
        node = node[k]
    return node


def case_serve_sharded(mesh, args, data) -> dict:
    """A prefill and one decode step of a smoke model in one process, then
    on the mesh: ``DTensor`` parameters placed by ``param_pspec_tree``, the
    prompt, the caches (the prefill's, laid out by ``input_pspec_tree`` as
    the dry-run lays them), the token and the position placed by
    ``input_pspec_tree``, inside ``activation_shardings``.  The logits of
    both calls and the caches after the decode step, of both runs."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.dist import distribute, input_pspec_tree, param_pspec_tree
    from repro_torch.dist.sharding import placements
    from repro_torch.models import build_model

    cfg = get_config(args["arch"], smoke=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(data["tokens"])
    S, L = toks.shape[1], args["L"]
    prompt, token = toks[:, :S - 1], toks[:, S - 1:]
    pos = torch.full((toks.shape[0],), S - 1, dtype=torch.int32)
    out = {}
    with torch.no_grad():
        logits, caches = model.prefill(params, {"tokens": prompt}, L)
        step, caches = model.decode_step(params, caches, token, pos)
        out["plain/prefill"], out["plain/decode"] = logits.numpy(), step.numpy()
        out.update(_flat(caches, "plain/caches"))

        placed = distribute(mesh, params, param_pspec_tree(params, mesh))
        batch = {"tokens": prompt}
        batch = distribute(mesh, batch,
                           input_pspec_tree({"batch": batch}, mesh)["batch"])
        with activation_shardings(mesh), implicit_replication():
            logits, caches = model.prefill(placed, batch, L)
            specs = input_pspec_tree({"caches": caches, "token": token,
                                      "pos": pos}, mesh)
            caches = tree.map_with_path(
                lambda path, c: c.redistribute(mesh, placements(
                    mesh, _at(specs["caches"], path))), caches)
            placed_in = distribute(mesh, {"token": token, "pos": pos},
                                   {k: specs[k] for k in ("token", "pos")})
            step, caches = model.decode_step(placed, caches,
                                             placed_in["token"],
                                             placed_in["pos"])
        out["sharded/prefill"] = logits.full_tensor().numpy()
        out["sharded/decode"] = step.full_tensor().numpy()
        out.update(_flat(tree.map_tree(lambda t: t.full_tensor(), caches),
                         "sharded/caches"))
    return out


CASES = {"moe": case_moe, "decode": case_decode, "campaign": case_campaign,
         "train_sharded": case_train_sharded,
         "serve_sharded": case_serve_sharded}


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
        # every rank done with its collectives before any tears gloo down
        dist.barrier()
    finally:
        dist.destroy_process_group()
    np.savez(where / f"out{rank}.npz", **out)


if __name__ == "__main__":
    main()
