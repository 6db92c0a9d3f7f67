"""The port's counter-based RNG (imbatracer_torch.core.rng) against the JAX
reference: seeds, PCG states and floats must be bitwise equal, for frame
numbers over the whole 32-bit range (the int64 emulation of uint32
products must keep their low 32 bits exact)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imbatracer_tpu.core import rng as jrng
from imbatracer_torch.core import rng as trng
from torch_threads import cap_torch_threads

cap_torch_threads()

FRAMES = [0, 1, 7919, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1]


def _ids(seed, n=512):
    rs = np.random.RandomState(seed)
    pid = rs.randint(0, 2 ** 31 - 1, n).astype(np.int32)
    sid = rs.randint(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    return pid, sid


@pytest.mark.parametrize("frame", FRAMES)
def test_seed_and_stream_bitwise(frame):
    pid, sid = _ids(frame % 9973)
    js = jrng.seed(jnp.asarray(pid), jnp.asarray(sid), frame)
    ts = trng.seed(torch.from_numpy(pid.astype(np.int64)),
                   torch.from_numpy(sid.astype(np.int64)), frame)
    np.testing.assert_array_equal(np.asarray(js).astype(np.int64), ts.numpy())

    js, jf = jrng.next_floats(js, 5)
    ts, tf = trng.next_floats(ts, 5)
    np.testing.assert_array_equal(np.asarray(js).astype(np.int64), ts.numpy())
    for a, b in zip(jf, tf):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_frame_as_tensor_and_hash():
    pid, sid = _ids(3)
    frame = 2 ** 32 - 5
    a = trng.seed(torch.from_numpy(pid.astype(np.int64)),
                  torch.from_numpy(sid.astype(np.int64)),
                  torch.tensor(frame, dtype=torch.int64))
    b = np.asarray(jrng.seed(jnp.asarray(pid), jnp.asarray(sid),
                             jnp.uint32(frame)))
    np.testing.assert_array_equal(a.numpy(), b.astype(np.int64))

    x = np.random.RandomState(4).randint(0, 2 ** 32, 4096,
                                         dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(
        trng.hash_wang(torch.from_numpy(x.astype(np.int64))).numpy(),
        np.asarray(jrng.hash_wang(jnp.asarray(x))).astype(np.int64))
    state, u = trng.next_float(torch.from_numpy(x.astype(np.int64)))
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert int(state.min()) >= 0 and int(state.max()) < 2 ** 32
