"""repro_torch.dist — sharding rule trees, activation sharding and SPMD over
a ``DeviceMesh`` (the port of ``repro.dist``, DESIGN.md §6).

* ``sharding`` — the static layout: partition-spec trees from path and
  shape rules with divisibility fallbacks (``param_pspec_tree``,
  ``input_pspec_tree``, ``campaign_pspec_tree``, ``rules_for_mesh``) and
  ``named`` / ``distribute`` to bind them to a mesh as DTensor placements.
* ``act_sharding`` — the dynamic layout: the ``activation_shardings``
  context that models consult (``shard_act``, ``current_state``).
* ``spmd`` — ``shard_map`` over global tensors and the collectives it runs
  on the mesh's sub-groups, with gradients.

The reference's ``compat`` (a jax-version shim for ``shard_map``) has no
counterpart.
"""
from repro_torch.dist import act_sharding, sharding, spmd
from repro_torch.dist.act_sharding import (
    activation_shardings, current_state, shard_act)
from repro_torch.dist.sharding import (
    AbstractMesh, P, Rules, campaign_pspec_tree, distribute,
    input_pspec_tree, named, param_pspec_tree, placements, rules_for_mesh)

__all__ = [
    "AbstractMesh", "P", "Rules", "act_sharding", "activation_shardings",
    "campaign_pspec_tree", "current_state", "distribute", "input_pspec_tree",
    "named", "param_pspec_tree", "placements", "rules_for_mesh", "shard_act",
    "sharding", "spmd",
]
