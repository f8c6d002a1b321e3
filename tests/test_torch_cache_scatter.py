"""The contiguous caches' writes against the JAX package's, on the CPU.

``_scatter_token``, ``_scatter_chunk`` (GQA's K/V caches, (B, KVH, Smax,
hd)) and ``_scatter_vec``, ``_scatter_vec_chunk`` (MLA's latent caches,
(B, Smax, D)) write in place without a host sync: each row rewrites a
window of ``min(C, Smax)`` slots, keeping the old value where no valid
in-range token lands.  They are held, bit for bit, to JAX's one-hot
writes and to a per-token loop, on positions at and past Smax, chunks
that straddle Smax, chunks longer than the cache and invalid tokens in
the middle of a chunk.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ja
from repro_torch.models import attention as ta

SMAX, KVH, HD, D = 8, 2, 4, 6

# (pos, valid) per row: in range, the last slot, at Smax, past Smax
TOKEN_POS = np.array([0, 3, SMAX - 1, SMAX, SMAX + 5], np.int32)
# chunk of 4: whole, straddling Smax, past Smax, invalid in the middle,
# straddling with an invalid token, nothing valid
CHUNK_POS = np.array([0, SMAX - 2, SMAX + 1, 2, SMAX - 3, 1], np.int32)
CHUNK_VALID = np.array([[1, 1, 1, 1], [1, 1, 1, 1], [1, 1, 1, 1],
                        [1, 0, 0, 1], [1, 0, 1, 1], [0, 0, 0, 0]], bool)
# chunk of 11 > Smax: from 0 with a hole, from 3 (straddling)
LONG_POS = np.array([0, 3], np.int32)
LONG_VALID = np.ones((2, 11), bool)
LONG_VALID[0, 5] = False


def _loop(cache, new, pos, valid, seq_axis):
    """The same write token by token, in numpy."""
    out = cache.copy()
    for b in range(pos.shape[0]):
        for i in range(valid.shape[1]):
            t = pos[b] + i
            if valid[b, i] and t < cache.shape[seq_axis]:
                src = np.take(new[b], i, axis=seq_axis - 1)
                if seq_axis == 2:
                    out[b, :, t] = src
                else:
                    out[b, t] = src
    return out


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("case", ["token", "chunk", "long"])
@pytest.mark.parametrize("layout", ["heads", "vec"])
def test_scatter_matches_jax(layout, case):
    rng = np.random.default_rng(len(layout) * 10 + len(case))
    if case == "token":
        pos, valid = TOKEN_POS, np.ones((TOKEN_POS.shape[0], 1), bool)
    elif case == "chunk":
        pos, valid = CHUNK_POS, CHUNK_VALID
    else:
        pos, valid = LONG_POS, LONG_VALID
    b, c = valid.shape
    if layout == "heads":
        cache, new = _rand(rng, b, KVH, SMAX, HD), _rand(rng, b, KVH, c, HD)
        seq_axis = 2
    else:
        cache, new = _rand(rng, b, SMAX, D), _rand(rng, b, c, D)
        seq_axis = 1
    jargs = (jnp.asarray(cache), jnp.asarray(new), jnp.asarray(pos))
    got = torch.from_numpy(cache.copy())
    targs = (torch.from_numpy(new), torch.from_numpy(pos))
    if layout == "heads" and case == "token":
        want = ja._scatter_token(*jargs)
        out = ta._scatter_token(got, *targs)
    elif layout == "heads":
        want = ja._scatter_chunk(*jargs, jnp.asarray(valid))
        other = torch.zeros_like(got)
        out, _ = ta._scatter_chunk(got, other, targs[0], targs[0], targs[1],
                                   torch.from_numpy(valid))
    elif case == "token":
        want = ja._scatter_vec(*jargs)
        out = ta._scatter_vec(got, *targs)
    else:
        want = ja._scatter_vec_chunk(*jargs, jnp.asarray(valid))
        out = ta._scatter_vec_chunk(got, *targs, torch.from_numpy(valid))
    assert out is got                                    # in place
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(),
                                  _loop(cache, new, pos, valid, seq_axis))


@pytest.mark.parametrize("layout", ["heads", "vec"])
def test_scatter_bf16_cache_matches_loop(layout):
    """A bf16 cache takes float32 tokens rounded once; the other slots
    keep their bits."""
    rng = np.random.default_rng(3)
    b, c = CHUNK_VALID.shape
    shape = (b, KVH, SMAX, HD) if layout == "heads" else (b, SMAX, D)
    nshape = (b, KVH, c, HD) if layout == "heads" else (b, c, D)
    cache = torch.from_numpy(_rand(rng, *shape)).to(torch.bfloat16)
    new = torch.from_numpy(_rand(rng, *nshape))
    want = _loop(cache.float().numpy(), new.to(torch.bfloat16).float().numpy(),
                 CHUNK_POS, CHUNK_VALID, 2 if layout == "heads" else 1)
    pos, valid = torch.from_numpy(CHUNK_POS), torch.from_numpy(CHUNK_VALID)
    if layout == "heads":
        ta._scatter_chunk(cache, cache.clone(), new, new, pos, valid)
    else:
        ta._scatter_vec_chunk(cache, new, pos, valid)
    np.testing.assert_array_equal(cache.float().numpy(), want)


def test_chunk_slots_stay_in_the_cache_and_distinct():
    """Every row's window lies inside the cache and names distinct slots,
    so the in-place write has no colliding targets."""
    pos = torch.arange(0, 3 * SMAX, dtype=torch.int32)
    for c in (1, 3, SMAX, SMAX + 4):
        valid = torch.ones((pos.shape[0], c), dtype=torch.bool)
        _, slots, tok, take = ta._chunk_slots(pos, valid, SMAX)
        assert slots.shape == (pos.shape[0], min(c, SMAX))
        assert int(slots.min()) >= 0 and int(slots.max()) < SMAX
        assert all(len(set(r.tolist())) == r.numel() for r in slots)
        # a slot takes token j - pos exactly where that token is in range
        want = (slots - pos[:, None].long() >= 0)
        assert torch.equal(take, want)
        assert torch.equal((slots - tok)[take], pos[:, None].long().expand(
            slots.shape)[take])
