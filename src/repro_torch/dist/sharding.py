"""Sharding rule trees: parameter, input and campaign partition specs from
path and shape rules (the port of ``repro.dist.sharding``, DESIGN.md §6).

Every array dimension gets a *logical* axis: ``tp`` (tensor parallel, the
``"model"`` mesh axis), ``fsdp`` (parameters sharded over ``"data"``) or
``batch`` (data parallelism over ``("pod", "data")``).  Logical axes resolve
to mesh axes leaf by leaf with a divisibility fallback: candidate axes are
taken left to right, each only if the dimension stays divisible by the
product so far, and a dimension that no candidate fits is replicated (never
sharded unevenly: whisper's 51,866-row vocabulary stays whole).  No mesh
axis is used twice in one spec.  So one rule table serves every
architecture on every mesh, from ``(1, 1)`` to the ``(2, 16, 16)``
multi-pod mesh.

A spec is a ``P``: one entry per dimension, a mesh axis name, a tuple of
them (major first) or ``None``.  The functions read only a mesh's
``mesh_dim_names`` and ``shape``, so a ``DeviceMesh`` and an
``AbstractMesh`` (names and sizes, no process group) serve alike.
``named`` binds specs to a ``DeviceMesh`` as DTensor placements.
"""
from __future__ import annotations

import dataclasses
import re

from repro_torch import tree


class P(tuple):
    """A partition spec: ``P("data", None, ("pod", "data"))``; one entry
    per dimension, as ``jax.sharding.PartitionSpec`` holds them."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes without devices: enough to derive specs."""

    mesh_dim_names: tuple[str, ...]
    shape: tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class Rules:
    """Mesh-axis roles for one (mesh, strategy) pair: ``tp`` and ``dp``
    name single mesh axes (or None), ``batch`` is every axis carrying data
    parallelism, slowest (inter-pod) first, ``fsdp`` the axes parameters
    shard over."""

    tp: str | None
    dp: str | None
    batch: tuple[str, ...]
    fsdp: tuple[str, ...]


def axis_sizes(mesh) -> dict[str, int]:
    """Axis name -> size, for a ``DeviceMesh`` or an ``AbstractMesh``."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def rules_for_mesh(mesh, strategy: str = "2d") -> Rules:
    """``"2d"``: ``model`` is tensor parallel, ``data`` (and ``pod``) carry
    the batch and FSDP.  ``"fsdp"``: no tensor parallelism, every axis is
    data parallel and parameters shard over all of them (the MoE checks
    ``rules.tp is None`` to skip expert parallelism)."""
    names = tuple(mesh.mesh_dim_names)
    if strategy == "2d":
        tp = "model" if "model" in names else None
        batch = tuple(a for a in names if a != "model")
        fsdp = ("data",) if "data" in names else batch
        dp = "data" if "data" in names else (batch[0] if batch else None)
        return Rules(tp=tp, dp=dp, batch=batch, fsdp=fsdp)
    if strategy == "fsdp":
        return Rules(tp=None, dp=names[0] if names else None,
                     batch=names, fsdp=names)
    raise ValueError(f"unknown sharding strategy {strategy!r}: '2d' | 'fsdp'")


# ---------------------------------------------------------------------------
# logical -> mesh axis resolution (the divisibility fallback)
# ---------------------------------------------------------------------------

def resolve_dim(dim: int, candidates, sizes: dict, used: set):
    """The spec entry of a dimension of size ``dim``: the candidate axes
    (left to right, skipping unknown and used ones) that keep it divisible
    by their running product; one name, a tuple of names, or ``None``.  The
    picked axes join ``used``."""
    picked: list[str] = []
    prod = 1
    for a in candidates:
        if a is None or a not in sizes or a in used:
            continue
        if dim % (prod * sizes[a]) == 0:
            picked.append(a)
            prod *= sizes[a]
    used.update(picked)
    if not picked:
        return None
    return picked[0] if len(picked) == 1 else tuple(picked)


def _spec_from_template(shape, template, rules: Rules, sizes: dict) -> P:
    """Right-align ``template`` on ``shape`` and resolve its logical axes;
    leading dimensions it does not reach are replicated."""
    template = tuple(template)[max(len(template) - len(shape), 0):]
    entries: list = [None] * (len(shape) - len(template))
    used: set = set()
    candidates = {"tp": (rules.tp,), "fsdp": rules.fsdp, "batch": rules.batch}
    for dim, logical in zip(shape[len(shape) - len(template):], template):
        if logical is None:
            entries.append(None)
        elif logical in candidates:
            entries.append(resolve_dim(dim, candidates[logical], sizes, used))
        else:
            raise ValueError(f"unknown logical axis {logical!r}")
    return P(*entries)


# ---------------------------------------------------------------------------
# rule tables
# ---------------------------------------------------------------------------

def _kv_cache_template(leaf):
    """KV caches ``[..., B, H, S, Dh]``: heads over tp when the head count
    divides, else the length axis (the length-sharded decode of
    ``models/attention.py``), else neither."""

    def build(rules: Rules, sizes: dict):
        ntp = sizes.get(rules.tp, 1) if rules.tp else 1
        H, S = leaf.shape[-3], leaf.shape[-2]
        if ntp > 1 and H % ntp == 0:
            return ("batch", "tp", None, None)
        if ntp > 1 and S % ntp == 0:
            return ("batch", None, "tp", None)
        return ("batch", None, None, None)

    return build


# (regex, template), first match wins.  A dict template selects by the
# leaf's rank; a function receives the leaf and returns a
# builder(rules, sizes) -> template.
_PARAM_RULES = (
    (r"(^|/)embed$", ("tp", "fsdp")),
    (r"(^|/)head$", ("fsdp", "tp")),
    (r"(enc_pos|dec_pos)$", ("fsdp", "tp")),
    (r"mlp/router$", ()),
    (r"mlp/w_(gate|up)$", {4: ("tp", None, "fsdp"),     # MoE [L, E, D, F]
                           3: ("fsdp", "tp"),           # dense [L, D, F]
                           2: ("fsdp", "tp")}),
    (r"mlp/w_down$", {4: ("tp", "fsdp", None),          # MoE [L, E, F, D]
                      3: ("tp", "fsdp"),
                      2: ("tp", "fsdp")}),
    (r"(wq|wk|wv|w_z|w_x|w_B|w_C|w_dt|w_gate|w_up)$", ("fsdp", "tp")),
    (r"(wo|out_proj|w_down)$", ("tp", "fsdp")),
    (r"conv_w$", (None, "tp")),
)

_INPUT_RULES = (
    (r"(^|/)(tokens|labels)$", ("batch", None)),
    (r"positions$", (None, "batch", None)),
    (r"(frames|frontend_embeds)$", ("batch", None, "tp")),
    (r"(^|/)token$", ("batch", None)),
    (r"(^|/)pos$", ("batch",)),
    (r"caches.*/(k|v|ck|cv)$", _kv_cache_template),
    (r"caches.*/conv$", (None, "batch", None, "tp")),
    (r"caches.*/state$", (None, "batch", None, None, "tp")),
)


def _match_template(table, path: str, leaf):
    for pattern, template in table:
        if re.search(pattern, path):
            if callable(template):
                return template(leaf)
            if isinstance(template, dict):
                return template.get(len(leaf.shape), ())
            return template
    return ()                                   # unmatched: replicate


def _pspec_tree(shapes, mesh, strategy: str, table):
    rules = rules_for_mesh(mesh, strategy)
    sizes = axis_sizes(mesh)

    def spec(path, leaf):
        template = _match_template(table, tree.key(path), leaf)
        if callable(template):
            template = template(rules, sizes)
        return _spec_from_template(tuple(leaf.shape), template, rules, sizes)

    return tree.map_with_path(spec, shapes)


def param_pspec_tree(shapes, mesh, strategy: str = "2d"):
    """The spec tree of a parameter tree (tensors or ``ShapeDtype``s from
    ``Model.param_specs``)."""
    return _pspec_tree(shapes, mesh, strategy, _PARAM_RULES)


def input_pspec_tree(specs, mesh, strategy: str = "2d"):
    """The spec tree of a ``Model.input_specs`` tree (batch, caches, token,
    pos)."""
    return _pspec_tree(specs, mesh, strategy, _INPUT_RULES)


def campaign_pspec_tree(batched, mesh, axis: str = "data"):
    """Specs sharding a stacked campaign's leading axis over ``mesh[axis]``,
    every other dimension replicated.  A leading dimension the axis does
    not divide resolves to ``None``, which ``core/campaign.py`` refuses:
    replicating a whole sweep onto every rank is never what a caller wants.
    ``batched`` is a ``Scenario`` (or any tree of tensors); only ``.shape``
    is read."""
    sizes = axis_sizes(mesh)

    def spec(x):
        shape = tuple(x.shape)
        if not shape:
            return P()
        return P(resolve_dim(shape[0], (axis,), sizes, set()),
                 *([None] * (len(shape) - 1)))

    if hasattr(batched, "map"):                 # a Scenario
        return batched.map(spec)
    return tree.map_tree(spec, batched)


def spec_leaves(specs) -> list[P]:
    """Every ``P`` of a spec tree (dicts, tuples, dataclasses such as a
    ``Scenario`` of specs), in field order."""
    if isinstance(specs, P):
        return [specs]
    if isinstance(specs, dict):
        return [s for v in specs.values() for s in spec_leaves(v)]
    if isinstance(specs, (tuple, list)):
        return [s for v in specs for s in spec_leaves(v)]
    if dataclasses.is_dataclass(specs):
        return [s for f in dataclasses.fields(specs)
                for s in spec_leaves(getattr(specs, f.name))]
    return []


# ---------------------------------------------------------------------------
# binding specs to a DeviceMesh
# ---------------------------------------------------------------------------

def placements(mesh, spec: P) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: one per mesh
    dimension, ``Shard(d)`` where tensor dimension d takes that axis, else
    ``Replicate()``.  A dimension that takes several axes must list them in
    the mesh's order (DTensor shards them major first in mesh order)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        at = [names.index(a) for a in axes]
        if at != sorted(at):
            raise ValueError(
                f"spec {spec!r}: dimension {d} takes axes {axes} out of the "
                f"mesh's order {names}")
        for i in at:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec!r} uses axis {names[i]!r} twice")
            out[i] = Shard(d)
    return tuple(out)


def _map_specs(fn, specs, *rest):
    """``fn(spec, *leaves of rest)`` over a spec tree of dicts and tuples
    (a ``P`` is a leaf, not a tuple to walk)."""
    if isinstance(specs, P):
        return fn(specs, *rest)
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v, *(r[k] for r in rest))
                for k, v in specs.items()}
    return type(specs)(_map_specs(fn, v, *(r[i] for r in rest))
                       for i, v in enumerate(specs))


def named(mesh, pspec_tree):
    """A spec tree -> a tree of placement tuples on ``mesh``."""
    return _map_specs(lambda s: placements(mesh, s), pspec_tree)


def distribute(mesh, values, pspec_tree):
    """``distribute_tensor`` every leaf of ``values`` on ``mesh`` by its
    spec; the result is a tree of DTensors (``full_tensor()`` gives each
    value back)."""
    from torch.distributed.tensor import distribute_tensor

    sizes = axis_sizes(mesh)

    def place(spec: P, x):
        for d, entry in enumerate(spec):
            n = 1
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                n *= sizes[a] if a is not None else 1
            if x.shape[d] % n:       # DTensor would shard it unevenly
                raise ValueError(f"dimension {d} of {tuple(x.shape)} does "
                                 f"not divide over {entry} ({n} ranks)")
        return distribute_tensor(x, mesh, placements(mesh, spec))

    return _map_specs(place, pspec_tree, values)


__all__ = [
    "AbstractMesh", "P", "Rules", "axis_sizes", "campaign_pspec_tree",
    "distribute", "input_pspec_tree", "named", "param_pspec_tree",
    "placements", "resolve_dim", "rules_for_mesh", "spec_leaves",
]
