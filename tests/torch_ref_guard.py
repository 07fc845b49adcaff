"""Keep the reference's ``INF`` constant alive for the port's parity tests.

The JAX package's chunked campaign runner donates its inputs
(``repro/core/campaign.py``, ``_run_chunk_split``, ``donate_argnums=(0,)``),
and some scenario leaves *are* the module constant
``repro.core.entities.INF``.  Once a test of the JAX package runs a chunked
campaign, that array is deleted, and every later reference call in the same
process that reaches ``INF`` raises "Buffer has been deleted or donated".
Which files share a pytest-xdist worker changes from run to run, so the
port's parity tests would fail or pass by the luck of the schedule.

Each port test file that calls the reference imports the fixture::

    from torch_ref_guard import revive_reference_inf  # noqa: F401

It does nothing while ``INF`` is alive.  When it is deleted, it binds a
fresh ``jnp.float32(3.0e38)`` (the reference's own value, so no result
changes) wherever a loaded module held the deleted array, as a module
attribute or as a function's default argument (the ``repro.*`` modules
that import it, and test modules that import it from ``repro.core``), and
clears JAX's caches, whose compiled programs hold the deleted constant as
an argument.
The fixture is module-scoped so that it runs before a test module's own
module-scoped fixtures, which call the reference too.
"""
import inspect
import sys

import pytest


def reference_inf_deleted() -> bool:
    """True when ``repro.core.entities.INF`` has been donated away."""
    ent = sys.modules.get("repro.core.entities")
    return ent is not None and ent.INF.is_deleted()


def revive() -> int:
    """Rebind every deleted reference ``INF`` to one fresh array and clear
    JAX's caches; return how many bindings changed (0 when ``INF`` lives)."""
    if not reference_inf_deleted():
        return 0
    import jax
    import jax.numpy as jnp

    dead = sys.modules["repro.core.entities"].INF
    fresh = jnp.float32(3.0e38)
    n = 0
    for name, mod in list(sys.modules.items()):
        if mod is None:
            continue
        for attr, val in list(vars(mod).items()):
            if val is dead:
                setattr(mod, attr, fresh)
                n += 1
            elif inspect.isfunction(val) and val.__module__ == name:
                n += _revive_defaults(val, dead, fresh)
    jax.clear_caches()
    return n


def _revive_defaults(fn, dead, fresh) -> int:
    n = 0
    if fn.__defaults__ and any(d is dead for d in fn.__defaults__):
        fn.__defaults__ = tuple(fresh if d is dead else d
                                for d in fn.__defaults__)
        n += 1
    kw = fn.__kwdefaults__
    if kw and any(d is dead for d in kw.values()):
        fn.__kwdefaults__ = {k: fresh if d is dead else d
                             for k, d in kw.items()}
        n += 1
    return n


@pytest.fixture(scope="module", autouse=True)
def revive_reference_inf():
    revive()
    yield
