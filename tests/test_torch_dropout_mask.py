"""PyTorch port vs JAX package: the dropout keep mask, bit for bit.

The plain ``keep_mask_reference`` (int64 arithmetic masked to 32 bits) must
give exactly the bits of ``transformertts_tpu.ops.pallas.dropout_mask.keep_mask``
(uint32 arithmetic), including for seeds and salts whose top bits are set,
where signed arithmetic and arithmetic right shifts would go wrong.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformertts_tpu.ops.pallas.dropout_mask import keep_mask as jax_keep_mask
from transformertts_tpu_torch.ops.dropout_mask import (
    keep_from_index,
    keep_mask,
    keep_mask_reference,
    seed_from_generator,
    threshold_of,
)

SEEDS = [0, 1, 12345, 2**31 - 2, -1, -(2**31), 0x7FFF0000]
SALTS = [0, 7, 8192 * 63 + 5, 2**31 - 1, -3, -(2**31)]


def _jax(shape, p, seed, salt):
    return np.asarray(jax_keep_mask(shape, p, jnp.int32(seed), jnp.int32(salt)))


@pytest.mark.parametrize("shape", [(8, 128), (64, 48), (5, 37), (512, 256)])
@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
def test_keep_mask_bit_equal(shape, p):
    for seed, salt in zip(SEEDS, SALTS + SALTS[:1]):
        ours = keep_mask_reference(shape, p, seed, salt).numpy()
        np.testing.assert_array_equal(ours, _jax(shape, p, seed, salt), err_msg=f"{seed} {salt}")


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("salt", SALTS)
def test_keep_mask_sign_bits(seed, salt):
    shape = (16, 40)
    ours = keep_mask_reference(shape, 0.3, seed, salt).numpy()
    np.testing.assert_array_equal(ours, _jax(shape, 0.3, seed, salt))


def test_salt_tensor_gives_one_block_per_salt():
    salts = torch.tensor([[3, 4], [8192, -1]])
    ours = keep_mask_reference((8, 24), 0.5, 99, salts)
    assert ours.shape == (2, 2, 8, 24)
    for i in range(2):
        for j in range(2):
            np.testing.assert_array_equal(
                ours[i, j].numpy(), _jax((8, 24), 0.5, 99, int(salts[i, j])))


def test_wrapper_on_cpu_is_the_plain_version_and_index_form_agrees():
    a = keep_mask((12, 20), 0.25, 5, 6, device="cpu")
    b = keep_mask_reference((12, 20), 0.25, 5, 6)
    r = torch.arange(12)[:, None]
    c = torch.arange(20)[None, :]
    assert torch.equal(a, b) and torch.equal(a, keep_from_index(r * 20 + c, 6, 5, 0.25))
    assert keep_mask.launches == 0


def test_keep_rate_and_threshold():
    assert threshold_of(0.1) == int(0.1 * 4294967296.0) and threshold_of(0.0) == 0
    m = keep_mask_reference((256, 256), 0.1, 11, 0)
    assert abs(float(m.float().mean()) - 0.9) < 0.01
    assert bool(keep_mask_reference((4, 4), 0.0, 1, 2).all())


def test_seed_from_generator():
    g = torch.Generator().manual_seed(3)
    seeds = [seed_from_generator(0.1, g) for _ in range(4)]
    assert len(set(seeds)) == 4 and all(0 <= s < 2**31 - 1 for s in seeds)
    g.manual_seed(3)
    assert seeds == [seed_from_generator(0.1, g) for _ in range(4)]
    assert seed_from_generator(0.0, None) == 0
    with pytest.raises(ValueError, match="generator"):
        seed_from_generator(0.1, None)
