"""Carry scenarios, results and model parameters across from the JAX
package, through numpy.

``scenario_from_arrays`` reads any object with the field names of
``repro.core.Scenario`` (a JAX ``Scenario`` included) leaf by leaf with
``np.asarray`` and builds the port's ``Scenario``.  It imports nothing of
JAX: a JAX array converts itself.  Workloads and outage schedules drawn with
``jax.random`` (the reference's generated scenarios) come across as data;
the port never redraws them.  Each of the scenario's extra instruments maps
to the port's instrument of the same ``name``, its tensor fields copied; a
name the port lacks raises ``NotImplementedError``.  ``params_from_arrays`` maps a parameter (or cache)
tree of nested dicts leaf by leaf; ``opt_state_from_arrays`` carries an
AdamW state of either package (``mu``, ``nu``, a 0-d int32 ``step``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import step
from repro_torch.core.energy import PowerModel, Topology
from repro_torch.core.entities import (
    Cloudlets, Hosts, Market, Outages, Policy, Scenario, VMRequests,
    resolve_device)

# the port's extra instruments, by the ``name`` the reference gives them
_INSTRUMENTS = {cls.name: cls for cls in (
    step.AutoscaleInstrument, step.MigrationInstrument,
    step.ReliabilityInstrument, step.TraceInstrument,
    step.UtilizationTimelineInstrument)}


def _tree(cls, src, dev):
    kw = {}
    for f in dataclasses.fields(cls):
        leaf = getattr(src, f.name)
        kw[f.name] = (None if leaf is None else
                      torch.from_numpy(np.array(leaf)).to(dev))
    return cls(**kw)


def _instrument(obj, dev) -> step.Instrument:
    """The port's instrument of ``obj``'s name, holding its data fields."""
    name = getattr(obj, "name", type(obj).__name__)
    if name not in _INSTRUMENTS:
        raise NotImplementedError(
            f"instrument {name!r} ({type(obj).__name__}) has no counterpart "
            f"in repro_torch; ported: {sorted(_INSTRUMENTS)}")
    return _tree(_INSTRUMENTS[name], obj, dev)


def scenario_from_arrays(obj, device=None) -> Scenario:
    """The port's ``Scenario`` holding ``obj``'s arrays on ``device``."""
    dev = resolve_device(device)
    return Scenario(
        hosts=_tree(Hosts, obj.hosts, dev),
        vms=_tree(VMRequests, obj.vms, dev),
        cloudlets=_tree(Cloudlets, obj.cloudlets, dev),
        market=_tree(Market, obj.market, dev),
        policy=_tree(Policy, obj.policy, dev),
        power=None if obj.power is None else _tree(PowerModel, obj.power, dev),
        topology=(None if obj.topology is None
                  else _tree(Topology, obj.topology, dev)),
        outages=(None if obj.outages is None
                 else _tree(Outages, obj.outages, dev)),
        instruments=tuple(_instrument(i, dev)
                          for i in obj.instruments),
        max_steps=int(obj.max_steps),
    )


def result_to_numpy(res) -> dict[str, np.ndarray]:
    """A ``SimResult`` (or ``History``) of either package as numpy arrays,
    by field name."""
    out = {}
    for f in dataclasses.fields(res):
        x = getattr(res, f.name)
        out[f.name] = (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                       else np.asarray(x))
    return out


def _leaf(x, dev) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":      # numpy has no bf16: carry the bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a)).to(dev)


def params_from_arrays(tree, device=None):
    """The port's tensors for a nested dict of arrays (the JAX package's
    parameter or cache tree, or any leaves ``np.asarray`` reads), on
    ``device``; the dict structure is kept."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_arrays(v, dev) for k, v in tree.items()}
    return _leaf(tree, dev)


def opt_state_from_arrays(state, device=None) -> dict:
    """The port's AdamW state (``train.optimizer.adamw_init`` /
    ``adamw_update``) for the JAX package's: the moment trees leaf by leaf
    and the step as a 0-d int32 tensor, on ``device``."""
    if set(state) != {"mu", "nu", "step"}:
        raise ValueError(f"an AdamW state has keys mu, nu and step, not "
                         f"{sorted(state)}")
    out = params_from_arrays(state, device)
    if out["step"].shape != () or out["step"].dtype != torch.int32:
        raise ValueError(f"AdamW step is {out['step'].dtype} of shape "
                         f"{tuple(out['step'].shape)}, expected a 0-d int32")
    return out
