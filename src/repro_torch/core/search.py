"""Policy search over campaign grids: random search and successive halving
(the port of ``repro.core.search``, DESIGN.md §12).

A policy study is an optimisation loop around ``run_campaign``: sample
candidate ``Policy`` / workload knobs, simulate each candidate as one row of
a stacked campaign, score a ``SimResult`` metric, iterate.  The knobs are
data, so a new candidate table (or a smaller rung) runs through the same
engine with no new shapes.

Knob spaces are plain dicts ``{name: candidate values}``.  Names that are
``Policy`` fields become ``[n]`` leaves of the campaign's policy; anything
else (workload knobs such as an MTBF) goes to the caller's
``instantiate(template, extras, n, generator)`` hook, which returns
``broadcast_campaign`` overrides.  Draws come from a CPU
``torch.Generator``, as ``core/workload.py``'s do: the same seed gives the
same table on every device, but not the reference's ``jax.random`` table.

Successive halving keeps its shapes fixed across rungs: scores scatter into
one ``ValuesReducer(n_slots=n0)``, the chunk size stays ``chunk_size or
n0`` (a smaller rung pads to it) and the per-rung fidelity (default the
``Policy.horizon``) rides as data.  Survivors are picked on the host from
the rung's score table.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import Tensor

from repro_torch.core.campaign import broadcast_campaign, run_campaign
from repro_torch.core.entities import Policy, Scenario
from repro_torch.core.reducers import ValuesReducer

_POLICY_FIELDS = frozenset(f.name for f in dataclasses.fields(Policy))


def _values(vals) -> Tensor:
    """A knob's value list as a tensor, with the reference's 32-bit
    dtypes (Python floats -> float32, ints -> int32)."""
    if isinstance(vals, Tensor):
        return vals
    a = np.asarray(vals)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    elif a.dtype == np.int64:
        a = a.astype(np.int32)
    return torch.from_numpy(a)


def grid_params(space: dict) -> dict:
    """Full cartesian product of a knob space -> ``{name: [prod] tensor}``
    (first knob slowest)."""
    if not space:
        raise ValueError("empty search space")
    axes = {k: _values(v) for k, v in space.items()}
    index = torch.meshgrid(*[torch.arange(a.shape[0]) for a in axes.values()],
                           indexing="ij")
    return {k: a[i.reshape(-1)] for (k, a), i in zip(axes.items(), index)}


def sample_params(generator: torch.Generator, space: dict, n: int) -> dict:
    """``n`` candidates drawn uniformly from each knob's value list, one
    independent draw per knob in sorted name order."""
    if not space:
        raise ValueError("empty search space")
    params = {}
    for name, vals in sorted(space.items()):
        vals = _values(vals)
        idx = torch.randint(0, vals.shape[0], (n,), generator=generator)
        params[name] = vals[idx]
    return params


def build_campaign(template: Scenario, params: dict, *, instantiate=None,
                   generator: torch.Generator | None = None) -> Scenario:
    """Candidate table -> stacked campaign.

    ``params`` maps knob names to aligned ``[n]`` values.  ``Policy``
    fields replace the template's (cast to its dtypes, on its device); the
    rest go to ``instantiate(template, extras, n, generator)``, which
    returns a dict of ``broadcast_campaign`` overrides."""
    n = int(next(iter(params.values())).shape[0])
    dev = template.policy.horizon.device
    pol_kw = {k: _values(v) for k, v in params.items() if k in _POLICY_FIELDS}
    extras = {k: _values(v) for k, v in params.items()
              if k not in _POLICY_FIELDS}
    overrides = {}
    if pol_kw:
        base = template.policy.map(lambda x: x.expand((n,) + tuple(x.shape)))
        overrides["policy"] = base.replace(**{
            k: v.to(dtype=getattr(base, k).dtype, device=dev)
            for k, v in pol_kw.items()}).map(lambda x: x.clone())
    if extras:
        if instantiate is None:
            raise ValueError(
                f"knobs {sorted(extras)} are not Policy fields; pass "
                "instantiate=(template, extras, n, generator) -> overrides "
                "to build their scenario subtrees")
        more = instantiate(template, extras, n, generator)
        overlap = set(more) & set(overrides)
        if overlap:
            raise ValueError(f"instantiate returned {sorted(overlap)}, "
                             "already produced from Policy knobs")
        overrides.update(more)
    return broadcast_campaign(template, n, **overrides)


def _take(params: dict, idx) -> dict:
    return {k: v[idx] for k, v in params.items()}


def _fresh(generator: torch.Generator | None, state):
    """A generator at ``state`` (every rung instantiates from the same draw
    state, as the reference reuses one key)."""
    if generator is None:
        return None
    g = torch.Generator(device=generator.device)
    g.set_state(state)
    return g


def random_search(template: Scenario, space: dict, *,
                  generator: torch.Generator, n: int, metric="total_cost",
                  mode: str = "min", chunk_size: int | None = None,
                  instantiate=None, device=None) -> dict:
    """Score ``n`` uniformly drawn candidates in one streamed campaign.

    Returns ``{"params", "values", "best_params", "best_value",
    "best_index"}``: the candidate table and its scores, never the ``[n,
    ...]`` results.  ``chunk_size`` streams as in ``run_campaign``.
    """
    params = sample_params(generator, space, n)
    batched = build_campaign(template, params, instantiate=instantiate,
                             generator=generator)
    out = run_campaign(batched, chunk_size=chunk_size, device=device,
                       reduce=ValuesReducer(metric, n_slots=n))
    values = out["values"]
    sign = 1.0 if mode == "min" else -1.0
    best = int((sign * values).argmin())
    return {"params": params, "values": values,
            "best_params": _take(params, best),
            "best_value": values[best], "best_index": best}


def successive_halving(template: Scenario, space: dict, *,
                       generator: torch.Generator, n0: int, fidelities,
                       eta: int = 2, metric="total_cost", mode: str = "min",
                       fidelity_knob: str = "horizon",
                       chunk_size: int | None = None, instantiate=None,
                       device=None) -> dict:
    """Successive halving: score everyone cheaply, promote the best ``1 /
    eta`` to the next (dearer) fidelity, repeat.

    ``fidelities`` gives ``fidelity_knob`` (a ``Policy`` field; default
    the simulation ``horizon``, which bounds the event loop) one value per
    rung, cheapest first.  The score table is one ``ValuesReducer`` of
    ``n0`` slots and the chunk size stays ``chunk_size or n0``.

    Returns ``{"params", "best_params", "best_value", "best_index",
    "rungs"}``: the ``[n0]`` candidate table, the winner, and per-rung
    ``{fidelity, candidates, values}`` records (``candidates``: the
    surviving global indices into ``params``).
    """
    if fidelity_knob not in _POLICY_FIELDS:
        raise ValueError(f"fidelity knob {fidelity_knob!r} is not a Policy "
                         "field")
    if fidelity_knob in space:
        raise ValueError(f"fidelity knob {fidelity_knob!r} cannot also be "
                         "a search dimension")
    if n0 < eta ** (len(tuple(fidelities)) - 1):
        raise ValueError(f"n0={n0} cannot halve {len(tuple(fidelities)) - 1}"
                         f" times by eta={eta}")
    params = sample_params(generator, space, n0)
    inst_state = generator.get_state()
    chunk = chunk_size or n0
    reducer = ValuesReducer(metric, n_slots=n0)
    sign = 1.0 if mode == "min" else -1.0
    knob_dtype = getattr(template.policy, fidelity_knob).dtype

    alive = torch.arange(n0)
    rungs = []
    for fid in fidelities:
        cand = _take(params, alive)
        cand[fidelity_knob] = torch.full((alive.shape[0],), fid,
                                         dtype=knob_dtype)
        batched = build_campaign(template, cand, instantiate=instantiate,
                                 generator=_fresh(generator, inst_state))
        out = run_campaign(batched, chunk_size=chunk, device=device,
                           reduce=reducer)
        values = out["values"][: alive.shape[0]]
        rungs.append({"fidelity": fid, "candidates": alive,
                      "values": values})
        order = torch.argsort(sign * values.cpu(), stable=True)
        keep = max(alive.shape[0] // eta, 1)
        alive = alive[order[:keep]]
    best = int(alive[0])
    last = rungs[-1]["values"]
    return {"params": params,
            "best_params": _take(params, best),
            "best_value": last[int((sign * last).argmin())],
            "best_index": best, "rungs": rungs}
