"""``compressed_psum`` in single-controller form against the reference's
``shard_map`` building block, run under ``jax.vmap(..., axis_name="i")``
over the same 4 seeded shards: equal bit for bit, as the port's
``quantize_int8`` parity test holds the quantizer (the int8 payloads sum
exactly as int32, the float32 scales in shard order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import compression as rcomp
from repro_torch.train import compression as comp


def _shards(seed, shape, n=4, scale=3.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n,) + shape) * scale).astype(np.float32)


@pytest.mark.parametrize("seed,shape", [(0, (1,)), (1, (1023,)),
                                        (2, (4, 1024)), (3, (33, 65)),
                                        (4, (3000,)), (5, (2, 3, 700))])
def test_compressed_psum_equals_reference(seed, shape):
    xs = _shards(seed, shape)
    want = jax.vmap(lambda x: rcomp.compressed_psum(x, "i"),
                    axis_name="i")(jnp.asarray(xs))
    got = comp.compressed_psum([torch.from_numpy(x) for x in xs])
    assert len(got) == 4
    for g, w in zip(got, np.asarray(want)):
        assert g.dtype == torch.float32 and tuple(g.shape) == shape
        np.testing.assert_array_equal(g.numpy(), w)
    # within the int8 bound of the exact sum: 4 shards, each off by at
    # most half its block's step, and the averaged-scale proxy
    assert np.isfinite(got[0].numpy()).all()


def test_compressed_psum_keeps_each_shard_on_its_device_and_type():
    xs = [torch.from_numpy(x).to(torch.bfloat16) for x in _shards(7, (64,))]
    out = comp.compressed_psum(xs)
    assert all(o.dtype == torch.bfloat16 and o.device.type == "cpu"
               for o in out)
    assert all(o is out[0] for o in out)       # one device: one result
    with pytest.raises(ValueError, match="no shards"):
        comp.compressed_psum([])
    with pytest.raises(ValueError, match="shapes differ"):
        comp.compressed_psum([torch.zeros(3), torch.zeros(4)])


def test_compressed_psum_of_one_shard_is_the_round_trip():
    x = torch.from_numpy(_shards(8, (2500,), n=1)[0])
    assert torch.equal(comp.compressed_psum([x])[0],
                       comp.compress_decompress(x))
