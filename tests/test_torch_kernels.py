"""The port's advance sweep against the JAX package's.

The plain PyTorch version (the CPU path of ``repro_torch.kernels.ops``) is
held against ``repro.kernels.ref.advance_sweep_ref`` and against the Pallas
kernel in interpret mode, on the same numpy inputs: ``dt`` bitwise, ``rem'``
within rtol 1e-6 / atol 1e-5 (the reference's kernel tolerances; XLA may
contract ``rem - rate*dt`` into an FMA, PyTorch never does).  The CUDA
kernel itself runs only on a card: its test is marked ``cuda``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.vm_update import advance_sweep_pallas
from repro_torch.kernels import ops, ref, vm_update
from torch_ref_guard import revive_reference_inf  # noqa: F401

pytestmark = pytest.mark.tier1


def _case(seed: int, b: int | None, c: int, inactive_row: bool = False):
    """rem, rate, active, bound as numpy; ``b=None`` gives rank-1 inputs."""
    rng = np.random.default_rng(seed)
    shape = (c,) if b is None else (b, c)
    rem = rng.uniform(0.1, 100, shape).astype(np.float32)
    rate = rng.uniform(0, 5, shape).astype(np.float32)
    rate[rng.random(shape) < 0.1] = 0.0
    active = rng.random(shape) > 0.3
    if inactive_row:
        active[..., 0, :] = False
    bound = rng.uniform(0.1, 50, () if b is None else (b,)).astype(np.float32)
    return rem, rate, active, bound


def _torch(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def _check(dt, new_rem, dt_ref, rem_ref):
    np.testing.assert_array_equal(np.asarray(dt), np.asarray(dt_ref))
    np.testing.assert_allclose(np.asarray(new_rem), np.asarray(rem_ref),
                               rtol=1e-6, atol=1e-5)


CASES = [
    (None, 1), (None, 7), (None, 300), (None, 4096),
    (1, 500), (3, 1), (4, 300), (5, 1280), (16, 129),
]


@pytest.mark.parametrize("b,c", CASES)
def test_ref_matches_jax_ref(b, c):
    rem, rate, active, bound = _case(c, b, c)
    dt, new_rem = ref.advance_sweep_ref(*_torch(rem, rate, active, bound))
    dt0, rem0 = jref.advance_sweep_ref(
        jnp.asarray(rem), jnp.asarray(rate), jnp.asarray(active),
        jnp.asarray(bound))
    assert dt.shape == tuple(dt0.shape) and dt.dtype == torch.float32
    _check(dt, new_rem, dt0, rem0)


@pytest.mark.parametrize("b,c,block", [
    (None, 300, 128), (2, 300, 128), (3, 1280, 256), (4, 500, 512)])
def test_ref_matches_pallas_interpret(b, c, block):
    rem, rate, active, bound = _case(c + 1, b, c)
    dt, new_rem = ref.advance_sweep_ref(*_torch(rem, rate, active, bound))
    dt1, rem1 = advance_sweep_pallas(
        jnp.asarray(rem), jnp.asarray(rate), jnp.asarray(active),
        jnp.asarray(bound), block=block, interpret=True)
    _check(dt, new_rem, dt1, rem1)


def test_all_inactive_row_takes_the_bound():
    rem, rate, active, bound = _case(3, 4, 50, inactive_row=True)
    dt, new_rem = ref.advance_sweep_ref(*_torch(rem, rate, active, bound))
    dt0, rem0 = jref.advance_sweep_ref(
        jnp.asarray(rem), jnp.asarray(rate), jnp.asarray(active),
        jnp.asarray(bound))
    _check(dt, new_rem, dt0, rem0)
    assert float(dt[0]) == float(bound[0])
    np.testing.assert_array_equal(new_rem[0].numpy(), rem[0])


def test_cpu_tensors_route_to_the_plain_version():
    args = _torch(*_case(5, 3, 200))
    assert ops.resolve_advance("cpu") is ref.advance_sweep_ref
    assert ops.resolve_advance("cuda") is vm_update.advance_sweep_cuda
    launches = vm_update.advance_sweep_cuda.launches
    dt, new_rem = ops.advance_sweep(*args)
    dt0, rem0 = ref.advance_sweep_ref(*args)
    assert torch.equal(dt, dt0) and torch.equal(new_rem, rem0)
    assert vm_update.advance_sweep_cuda.launches == launches
    with pytest.raises(ValueError):
        ops.resolve_advance("meta")


def test_kernel_wrapper_refuses_cpu_tensors():
    """No fallback: the CUDA wrapper raises rather than compute on the CPU."""
    with pytest.raises(ValueError, match="not a CUDA device"):
        vm_update.advance_sweep_cuda(*_torch(*_case(6, 2, 10)))


@pytest.mark.parametrize("b,c,variant", [
    (1024, 500, "fused"), (1, 500, "fused"), (8192, 4096, "fused"),
    (1, 131072, "split"), (1, 3 * 2**17, "split"), (1, 8192, "split"),
    (200, 8192, "fused"), (200, 8193, "split"), (7, 0, "fused"),
    (70000, 8193, "split"),     # rows past the split grid's y: folded
])
def test_kernel_plan(b, c, variant):
    plan = vm_update.kernel_plan(b, c)
    assert plan["variant"] == variant
    assert plan["threads"] % 32 == 0 and plan["threads"] <= 512
    assert plan["items"] in (1, 2, 4, 8, 16)
    covered = plan["threads"] * plan["items"] * plan["nb"]
    assert covered >= c
    if variant == "fused":
        assert plan["grid"] == (b,)
    else:
        assert plan["grid"] == (plan["nb"], min(b, vm_update.MAX_GRID_Y))
        assert (plan["nb"] - 1) * plan["threads"] * plan["items"] < c


@pytest.mark.cuda
@pytest.mark.parametrize("b,c", [(1024, 500), (1, 500), (1, 131072),
                                 (1, 3 * 2**17), (8192, 4096), (3, 7),
                                 (70000, 8193)])
def test_cuda_kernel_matches_plain_version(b, c):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run with python3 chip_smoke.py)")
    args = [x.cuda() for x in _torch(*_case(c, b, c))]
    dt, new_rem = vm_update.advance_sweep_cuda(*args)
    dt0, rem0 = ref.advance_sweep_ref(*args)
    torch.cuda.synchronize()
    assert torch.equal(dt, dt0)
    torch.testing.assert_close(new_rem, rem0, rtol=1e-6, atol=1e-5)
