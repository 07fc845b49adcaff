"""The port's batch-major segment ops against ``repro.core.segments``.

Each row of a ``[B, N]`` batch goes through the JAX op on its own; ids run
over the junk segment (``num_segments`` and beyond, and negative) and repeat
so that ties in row order matter.  Integer-valued sums are exact; float sums
are held within rtol 1e-6 (the order of additions may differ).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import segments as jseg
from repro_torch.core import segments
from torch_ref_guard import revive_reference_inf  # noqa: F401

pytestmark = pytest.mark.tier1

B, N, S = 4, 37, 6


def _ids(seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-2, S + 3, (B, N)).astype(np.int32)


def _values(seed, integer):
    rng = np.random.default_rng(seed + 100)
    if integer:
        return rng.integers(0, 4, (B, N)).astype(np.float32)
    return rng.uniform(0, 10, (B, N)).astype(np.float32)


def _per_row(fn, *arrays):
    return np.stack([np.asarray(fn(*(jnp.asarray(a[b]) for a in arrays)))
                     for b in range(B)])


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("integer", [True, False])
def test_segment_sum(seed, integer):
    v, ids = _values(seed, integer), _ids(seed)
    out = segments.segment_sum(torch.from_numpy(v), torch.from_numpy(ids), S)
    ref = _per_row(lambda x, i: jseg.segment_sum(x, i, S), v, ids)
    assert out.shape == (B, S)
    if integer:
        np.testing.assert_array_equal(out.numpy(), ref)
    else:
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6)


@pytest.mark.parametrize("seed", range(3))
def test_segment_prefix_sum(seed):
    """Exclusive, in row order within each segment (negative ids clip to
    segment 0, large ones to the junk segment, in both packages)."""
    v, ids = _values(seed, True), _ids(seed)
    out = segments.segment_prefix_sum(
        torch.from_numpy(v), torch.from_numpy(ids), S).numpy()
    ref = _per_row(lambda x, i: jseg.segment_prefix_sum(x, i, S), v, ids)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("seed", range(3))
def test_segment_all(seed):
    rng = np.random.default_rng(seed)
    v, ids = rng.random((B, N)) > 0.2, _ids(seed)
    out = segments.segment_all(torch.from_numpy(v), torch.from_numpy(ids), S)
    ref = _per_row(lambda x, i: jseg.segment_all(x, i, S), v, ids)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("seed", range(3))
def test_segment_min(seed):
    v, ids = _values(seed, False), _ids(seed)
    out = segments.segment_min(
        torch.from_numpy(v), torch.from_numpy(ids), S, 3.0e38)
    ref = _per_row(lambda x, i: jseg.segment_min(x, i, S, 3.0e38), v, ids)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_rows_do_not_mix():
    """A row's result is the same whatever else is in the batch."""
    v = torch.from_numpy(_values(9, False))
    ids = torch.from_numpy(_ids(9))
    whole = segments.segment_sum(v, ids, S)
    for b in range(B):
        assert torch.equal(segments.segment_sum(v[b:b + 1], ids[b:b + 1], S)[0],
                           whole[b])


@pytest.mark.parametrize("n", [1, 2, 5, 64, 1000])
def test_row_sum_is_batch_invariant(n):
    x = torch.from_numpy(np.random.default_rng(n).uniform(
        -5, 5, (3, n)).astype(np.float32))
    whole = segments.row_sum(x)
    np.testing.assert_allclose(whole.numpy(), x.double().sum(-1).numpy(),
                               rtol=1e-5, atol=1e-5)
    for b in range(3):
        assert torch.equal(segments.row_sum(x[b:b + 1])[0], whole[b])


def test_min_where_of_an_empty_mask_is_inf():
    x = torch.tensor([[1.0, 2.0], [3.0, -1.0]])
    mask = torch.tensor([[False, False], [True, True]])
    assert torch.equal(segments.min_where(x, mask), torch.tensor([3.0e38, -1.0]))
