"""linevis_tpu_torch's jax.random stream (ops/threefry.py) vs jax.random on the CPU.

Bar: bit for bit. `PRNGKey`, `split` (n = 2, 3, 4, 1000), `bits` and
`uniform` at shapes (), (2,) and (3,) over a few hundred seeds; the nested
split chain the path tracer walks (`linevis_tpu/render/vpt.py:264, 197,
277`: split(key, 3) per sample, split(kt, N) per ray, split(key,
max_events) per event, split(k, 4) and uniform per key) and the scattering
tracer's (`trace/scattering.py:164-165, 219`). The device header
(`kernels/csrc/threefry.cuh`) is held against this module on the card
(tests/test_torch_cuda_kernels.py::test_threefry_device_matches_torch):
the module runs the same masked int64 arithmetic on CUDA tensors as on
the CPU tensors these tests hold against jax.random.
"""

import jax
import numpy as np
import pytest
import torch

from linevis_tpu_torch.ops import threefry

SEEDS = list(range(0, 200)) + [2**31 - 1, 123456789, 4000000000 % 2**31, -1, -12345]


def _np(x):
    return np.asarray(x).astype(np.int64)


def test_prng_key_and_split_equal_jax():
    for s in SEEDS:
        jk = jax.random.PRNGKey(s)
        tk = threefry.prng_key(s)
        assert np.array_equal(_np(jk), tk.numpy()), s
        for n in (2, 3, 4):
            assert np.array_equal(_np(jax.random.split(jk, n)), threefry.split(tk, n).numpy())
    for s in SEEDS[:5]:
        jk, tk = jax.random.PRNGKey(s), threefry.prng_key(s)
        big = threefry.split(tk, 1000)
        assert np.array_equal(_np(jax.random.split(jk, 1000)), big.numpy())
        assert np.array_equal(big[[0, 7, 999]].numpy(),
                              threefry.split_at(tk, torch.tensor([0, 7, 999])).numpy())


@pytest.mark.parametrize("shape", [(), (2,), (3,)])
def test_bits_and_uniform_equal_jax(shape):
    for s in SEEDS:
        jk, tk = jax.random.PRNGKey(s), threefry.prng_key(s)
        assert np.array_equal(_np(jax.random.bits(jk, shape)), threefry.bits(tk, shape).numpy())
        ju = np.asarray(jax.random.uniform(jk, shape))
        tu = threefry.uniform(tk, shape).numpy()
        assert tu.dtype == np.float32 and tu.shape == ju.shape
        assert np.array_equal(ju.view(np.int32), tu.view(np.int32)), s
        if shape:
            for i in range(shape[0]):
                assert threefry.uniform_at(tk, i).numpy().view(np.int32) == ju.view(np.int32)[i]


def test_batched_keys_equal_jax():
    """Keys in a batch [N, 2] derive as each key alone (the vmapped use)."""
    jkeys = jax.random.split(jax.random.PRNGKey(7), 64)
    tkeys = threefry.split(threefry.prng_key(7), 64)
    assert np.array_equal(_np(jax.vmap(lambda k: jax.random.split(k, 4))(jkeys)),
                          threefry.split(tkeys, 4).numpy())
    ju = np.asarray(jax.vmap(jax.random.uniform)(jkeys))
    assert np.array_equal(ju.view(np.int32), threefry.uniform(tkeys).numpy().view(np.int32))
    ju3 = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (3,)))(jkeys))
    assert np.array_equal(ju3.view(np.int32), threefry.uniform(tkeys, (3,)).numpy().view(np.int32))


def test_path_tracer_key_chain_equals_jax():
    """render_vpt -> vpt_trace_rays -> trace_one -> step, as the JAX
    functions split: (key, kj, kt) = split(key, 3); jitter uniform(kj, (2,));
    ray keys split(kt, N); event keys split(ray, max_events)[j];
    (k1..k4) = split(k, 4); u = uniform(k1); the phase's split(k3) and
    uniform of each half; Stochastic's uniform(k4, (3,))."""
    E, N = 16, 24
    jkey, tkey = jax.random.PRNGKey(5), threefry.prng_key(5)
    for _ in range(2):  # two samples
        jkey, jkj, jkt = jax.random.split(jkey, 3)
        ks = threefry.split(tkey, 3)
        tkey, tkj, tkt = ks[0], ks[1], ks[2]
        ju = np.asarray(jax.random.uniform(jkj, (2,)))
        assert np.array_equal(ju.view(np.int32), threefry.uniform(tkj, (2,)).numpy().view(np.int32))
        jrays = jax.random.split(jkt, N)
        trays = threefry.split(tkt, N)
        assert np.array_equal(_np(jrays), trays.numpy())

        def chain(ray):
            out = []
            for k in jax.random.split(ray, E):
                k1, k2, k3, k4 = jax.random.split(k, 4)
                p1, p2 = jax.random.split(k3)
                out.append(np.concatenate([
                    np.asarray([jax.random.uniform(k1), jax.random.uniform(k2),
                                jax.random.uniform(p1), jax.random.uniform(p2)]),
                    np.asarray(jax.random.uniform(k4, (3,)))]))
            return np.stack(out)

        jall = np.stack([chain(r) for r in jrays[:6]])  # [6, E, 7]
        tall = []
        for j in range(E):
            k = threefry.split_at(trays[:6], j)
            k4 = threefry.split(k, 4)
            u12 = threefry.uniform_at(k4[:, :2])
            p = threefry.uniform_at(threefry.split(k4[:, 2], 2))
            s3 = threefry.uniform(k4[:, 3], (3,))
            tall.append(torch.cat([u12, p, s3], 1))
        tall = torch.stack(tall, 1).numpy()
        assert np.array_equal(jall.astype(np.float32).view(np.int32), tall.view(np.int32))


def test_uniform_range_and_device_of_the_key():
    u = threefry.uniform(threefry.split(threefry.prng_key(1), 4096))
    assert u.dtype == torch.float32 and float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.02

