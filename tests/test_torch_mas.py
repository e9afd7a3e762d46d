"""The port's MAS (vits_tpu_torch/ops/mas.py) against the JAX package on
the CPU: the plain version, which the wrapper takes for CPU tensors, must be
array-EQUAL to `maximum_path_ref`, `maximum_path_scan` and the Pallas kernel
in interpret mode (the DP is the same f32 adds and maxes in the same order,
so the 0/1 path has no tolerance)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vits_tpu.ops import mas as jmas

from vits_tpu_torch.ops import mas as tmas


def random_case(rng, B, T_y, T_x):
    """tests/test_mas.py's generator: lengths t_x <= t_y."""
    neg = rng.randn(B, T_y, T_x).astype(np.float32)
    t_ys = rng.randint(2, T_y + 1, size=B).astype(np.int32)
    t_xs = np.minimum(rng.randint(1, T_x + 1, size=B), t_ys).astype(np.int32)
    return neg, t_ys, t_xs


def _plain(neg, t_ys, t_xs):
    return tmas.maximum_path_plain(torch.from_numpy(neg), torch.from_numpy(t_ys),
                                   torch.from_numpy(t_xs)).numpy()


@pytest.mark.parametrize("B,T_y,T_x", [(2, 7, 5), (4, 25, 12), (3, 64, 40), (2, 120, 60),
                                       (2, 16, 8), (3, 40, 24)])
def test_plain_equals_ref_scan_and_pallas(B, T_y, T_x):
    rng = np.random.RandomState(B + T_y)
    neg, t_ys, t_xs = random_case(rng, B, T_y, T_x)
    got = _plain(neg, t_ys, t_xs)
    np.testing.assert_array_equal(got, jmas.maximum_path_ref(neg, t_ys, t_xs))
    args = (jnp.asarray(neg), jnp.asarray(t_ys), jnp.asarray(t_xs))
    np.testing.assert_array_equal(got, np.asarray(jmas.maximum_path_scan(*args)))
    np.testing.assert_array_equal(got, np.asarray(jmas.maximum_path_pallas(*args,
                                                                           interpret=True)))


@pytest.mark.parametrize("case", ["diagonal", "one_token", "past_lengths"])
def test_plain_edge_cases(case):
    """t_x == t_y (the pure diagonal), t_x == 1, and rows/columns past the
    lengths (zero rows, a padded neg_cent)."""
    rng = np.random.RandomState(7)
    if case == "diagonal":
        neg = rng.randn(2, 6, 6).astype(np.float32)
        t_ys = t_xs = np.array([6, 4], np.int32)
    elif case == "one_token":
        neg = rng.randn(2, 9, 1).astype(np.float32)
        t_ys, t_xs = np.array([9, 3], np.int32), np.array([1, 1], np.int32)
    else:
        neg = rng.randn(3, 30, 11).astype(np.float32) * 50
        t_ys, t_xs = np.array([30, 17, 2], np.int32), np.array([11, 5, 1], np.int32)
    got = _plain(neg, t_ys, t_xs)
    np.testing.assert_array_equal(got, jmas.maximum_path_ref(neg, t_ys, t_xs))
    np.testing.assert_array_equal(got, np.asarray(jmas.maximum_path_scan(
        jnp.asarray(neg), jnp.asarray(t_ys), jnp.asarray(t_xs))))
    if case == "diagonal":
        for i, t in enumerate(t_ys):
            np.testing.assert_array_equal(got[i, :t, :t], np.eye(t, dtype=np.float32))
    for i in range(len(t_ys)):
        assert got[i, t_ys[i]:].sum() == 0 and got[i, :, t_xs[i]:].sum() == 0


def test_dispatcher_with_mask_and_dtype():
    """maximum_path(neg_cent, mask) on CPU tensors: lengths from the mask,
    equal to the JAX dispatcher; the input dtype is kept (bf16 too)."""
    rng = np.random.RandomState(3)
    B, T_y, T_x = 3, 20, 9
    neg, t_ys, t_xs = random_case(rng, B, T_y, T_x)
    ymask = np.arange(T_y)[None, :] < t_ys[:, None]
    xmask = np.arange(T_x)[None, :] < t_xs[:, None]
    mask = (ymask[:, :, None] & xmask[:, None, :]).astype(np.float32)
    want = np.asarray(jmas.maximum_path(jnp.asarray(neg), jnp.asarray(mask), impl="scan"))
    got = tmas.maximum_path(torch.from_numpy(neg), torch.from_numpy(mask))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    got16 = tmas.maximum_path(torch.from_numpy(neg).bfloat16(), torch.from_numpy(mask).bfloat16())
    assert got16.dtype == torch.bfloat16
    want16 = np.asarray(jmas.maximum_path(jnp.asarray(neg, jnp.bfloat16),
                                          jnp.asarray(mask, jnp.bfloat16), impl="scan"))
    np.testing.assert_array_equal(got16.float().numpy(), want16.astype(np.float32))


def test_wrapper_refuses_other_devices():
    x = torch.zeros(1, 4, 3, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tmas.maximum_path(x, x)
