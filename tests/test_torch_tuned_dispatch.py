"""Tuned-vs-untuned dispatch over every ``KERNEL_DIMS`` op of the port,
mirroring the reference's ``tests/test_tuned_dispatch_matrix.py``.

A tuner persists a winner under one cache key; a dispatcher whose
``None``-knob lookup happens under other dims (SpMV stores at CSR dims,
``dae_spmv`` looks up at the converted BSR dims) would silently run its
analytic default instead.  So:

* one spy case per ``KERNEL_DIMS`` op (a completeness test pins the
  set);
* each case runs the same call twice — empty cache, then with a
  distinctive ``CacheEntry`` planted under the canonical key (the
  ``torch:cpu`` backend) — through ``repro_torch.tune.seam.spied``, and
  asserts at the ``_k.<kernel>`` seam that the planted knobs reach the
  kernel as written here and as ``seam_knobs`` says, that they differ
  from the untuned run, and that the output does not change;
* the SpMV case plants a decoy ``rif`` under the CSR key and the real one
  only under ``measure.alias_keys`` (the BSR mirror).

Then entries shaped like the reference's, carrying knobs that have no
Hopper counterpart (``block_d``, ``bq``/``bk``, ``bf``/``bd``, the
hash walk's ``rif``), dispatch without error and apply the knobs the
port shares; the dispatchers take those knobs by name.

On the CPU the seams run their kernels' plain versions, which take the
same knobs.  Outputs are compared exactly: the plain versions ignore
the knobs, and the kernels on the card are held to them elsewhere.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core.pipeline import plan_rif
from repro_torch.tune import CacheEntry, default_cache, make_key
from repro_torch.tune.runners import KERNEL_DIMS, kernel_runner
from repro_torch.tune.seam import seam_knobs, spied


def _plant(op, dims, dtype, config):
    key = make_key(op, dims, dtype, "torch:cpu", "wallclock")
    default_cache().put(key, CacheEntry(config=dict(config), score=1.0))


def _only(seen):
    """The one wrapper a run called, with its knobs."""
    assert len(seen) == 1, f"expected one wrapper of the seam, got {seen}"
    (name, knobs), = seen.items()
    return name, knobs


def _tuned_untuned(op, call, plant):
    """Run ``call`` on an empty cache, then with ``plant()`` applied;
    return the (wrapper, knobs) each run reached, after checking the two
    outputs are equal."""
    before, untuned = spied(op, call)
    plant()
    after, tuned = spied(op, call)
    torch.testing.assert_close(after, before, rtol=0, atol=0)
    return _only(tuned), _only(untuned)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- one case per op ----------------------------------------------------------
#
# Each case returns (tuned, untuned, expected, planted, dims): the
# (wrapper, knobs) each run reached, the planted knobs as the seam
# receives them, and the planted entry with the dims it is keyed on.


def _case_dae_gather(config=None):
    import repro_torch.kernels.dae_gather.ops as ops
    n, d, m = 112, 128, 48
    r = np.random.default_rng(0)
    table = _t(r.standard_normal((n, d)).astype(np.float32))
    idx = _t(r.integers(0, n, m).astype(np.int32))
    planted = config or {"method": "rif", "chunk": 16, "rif": 5}
    tuned, untuned = _tuned_untuned(
        "dae_gather", lambda: ops.dae_gather(table, idx),
        lambda: _plant("dae_gather", (n, d, m), "float32", planted))
    return (tuned, untuned, ("gather_rif", {"chunk": 16, "rif": 5}),
            planted, (n, d, m))


def _case_dae_merge():
    import repro_torch.kernels.dae_merge.ops as ops
    n, m = 88, 72
    r = np.random.default_rng(0)
    a = torch.sort(_t(r.standard_normal(n).astype(np.float32))).values
    b = torch.sort(_t(r.standard_normal(m).astype(np.float32))).values
    planted = {"tile": 32, "rif": 3}
    tuned, untuned = _tuned_untuned(
        "dae_merge", lambda: ops.merge_sorted(a, b),
        lambda: _plant("dae_merge", (n, m), "float32", planted))
    return (tuned, untuned, ("merge_tiles", {"tile": 32, "rif": 3}),
            planted, (n, m))


def _bf16(r, shape):
    return _t(r.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)


def _case_flash_attention(config=None):
    import repro_torch.kernels.flash_attention.ops as ops
    sq, sk, d = 48, 80, 64
    r = np.random.default_rng(0)
    q, k, v = (_bf16(r, (1, h, s, d)) for h, s in ((4, sq), (2, sk),
                                                   (2, sk)))
    planted = config or {"rif": 3}
    tuned, untuned = _tuned_untuned(
        "flash_attention", lambda: ops.flash_attention(q, k, v),
        lambda: _plant("flash_attention", (sq, sk, d), "bfloat16", planted))
    return tuned, untuned, ("flash", {"rif": 3}), planted, (sq, sk, d)


def _case_flash_decode():
    import repro_torch.kernels.flash_attention.ops as ops
    s, d = 96, 64
    r = np.random.default_rng(0)
    q = _bf16(r, (1, 2, d))
    kc, vc = _bf16(r, (1, 1, s, d)), _bf16(r, (1, 1, s, d))
    lens = torch.tensor([s], dtype=torch.int32)
    planted = {"bk": 32, "rif": 3}
    tuned, untuned = _tuned_untuned(
        "flash_decode", lambda: ops.flash_decode(q, kc, vc, lens),
        lambda: _plant("flash_decode", (s, d), "bfloat16", planted))
    return (tuned, untuned, ("flash_decode", {"bk": 32, "rif": 3}),
            planted, (s, d))


def _case_flash_decode_paged():
    import repro_torch.kernels.flash_attention.ops as ops
    page, d, npb = 32, 64, 2
    r = np.random.default_rng(0)
    q = _bf16(r, (1, 2, d))
    kp = _bf16(r, (npb, 1, page, d))
    vp = kp + 1.0
    pt = torch.arange(npb, dtype=torch.int32).reshape(1, npb)
    lens = torch.tensor([npb * page], dtype=torch.int32)
    planted = {"rif": 3}
    tuned, untuned = _tuned_untuned(
        "flash_decode_paged",
        lambda: ops.flash_decode_paged(q, kp, vp, pt, lens),
        lambda: _plant("flash_decode_paged", (page, d), "bfloat16",
                       planted))
    return (tuned, untuned, ("flash_decode_paged", {"rif": 3}), planted,
            (page, d))


def _case_grouped_matmul(config=None, expected_bn=128):
    import repro_torch.kernels.grouped_matmul.ops as ops
    t, d, f = 128, 256, 256
    r = np.random.default_rng(0)
    x, w = _bf16(r, (t, d)), _bf16(r, (2, d, f))
    blk = torch.zeros((t // 128,), dtype=torch.int32)
    planted = config or {"bf": 128, "rif": 3}
    tuned, untuned = _tuned_untuned(
        "grouped_matmul", lambda: ops.grouped_matmul(x, w, blk),
        lambda: _plant("grouped_matmul", (t, d, f), "bfloat16", planted))
    return (tuned, untuned, ("gmm", {"_bn": expected_bn, "rif": 3}),
            planted, (t, d, f))


def _case_batched_searchsorted():
    import repro_torch.kernels.dae_chase.ops as ops
    n, m = 176, 24
    r = np.random.default_rng(0)
    table = torch.sort(_t(r.integers(0, 1 << 20, n).astype(np.int32))).values
    keys = _t(r.integers(0, 1 << 20, m).astype(np.int32))
    planted = {"block": 32, "chunk": 8, "rif": 3}
    tuned, untuned = _tuned_untuned(
        "batched_searchsorted",
        lambda: ops.batched_searchsorted(table, keys),
        lambda: _plant("batched_searchsorted", (n, m), "int32", planted))
    return (tuned, untuned,
            ("searchsorted_blocks", {"chunk": 8, "rif": 3, "block": 32}),
            planted, (n, m))


def _hash_inputs(n=80, m=16, chain=4):
    r = np.random.default_rng(0)
    nxt = np.arange(1, n + 1, dtype=np.int32)
    nxt[nxt % chain == 0] = -1
    heads = (r.integers(0, n // chain, m) * chain).astype(np.int32)
    keys = heads + r.integers(0, chain, m).astype(np.int32)
    return (_t(np.arange(n, dtype=np.int32)),
            _t(r.integers(0, 1 << 16, n).astype(np.int32)), _t(nxt),
            _t(heads), _t(keys)), chain


def _case_hash_lookup(config=None):
    import repro_torch.kernels.dae_chase.ops as ops
    table, chain = _hash_inputs()
    planted = config or {"chunk": 8}
    tuned, untuned = _tuned_untuned(
        "hash_lookup", lambda: ops.hash_lookup(*table, max_steps=chain),
        lambda: _plant("hash_lookup", (80, 16), "int32", planted))
    return tuned, untuned, ("hash_probe", {"chunk": 8}), planted, (80, 16)


def _case_dae_spmv():
    """The alias-key case: a decoy rif under the CSR key, the real one
    under the alias (BSR) key only."""
    import repro_torch.kernels.dae_spmv.ops as ops
    nrows, ncols, nnz = 16, 256, 64
    best = {"bm": 4, "bk": 128, "rif": 5}
    assert plan_rif(best["bk"] * 4).rif != best["rif"]
    # the construction of runners._spmv_measure (seed 0), so the BSR dims
    # of this data match what measure.alias_keys mirrors
    r = np.random.default_rng(0)
    counts = r.multinomial(nnz, np.ones(nrows) / nrows)
    rows = np.zeros(nrows + 1, np.int64)
    rows[1:] = np.cumsum(counts)
    cols = r.integers(0, ncols, nnz)
    val = r.standard_normal(nnz).astype(np.float32)
    vec = _t(r.standard_normal(ncols).astype(np.float32))

    def call():
        vb, ri, ci, _, nrb = ops.csr_to_bsr(rows, cols, val, ncols,
                                            device="cpu")
        return ops.dae_spmv(_t(vb), _t(ri), _t(ci), vec, nrb)[:nrows]

    want, seen = spied("dae_spmv", call)
    untuned = _only(seen)
    assert untuned[1]["block"] == (8, 128)
    measure, _key, _dims = kernel_runner("dae_spmv", (nrows, ncols, nnz),
                                         device="cpu")
    _plant("dae_spmv", (nrows, ncols, nnz), "float32", {**best, "rif": 9})
    for alias in measure.alias_keys(best):
        default_cache().put(alias, CacheEntry(config=dict(best), score=1.0))
    got, seen = spied("dae_spmv", call)
    tuned = _only(seen)
    assert tuned[1]["rif"] != 9, "rif came from the CSR key (alias-key gap)"
    limit = 1e-5 * float((val.__abs__()).sum())
    torch.testing.assert_close(got, want, rtol=0, atol=limit)
    return (tuned, untuned, ("bsr_spmv", {"rif": best["rif"],
                                          "block": (best["bm"], best["bk"])}),
            best, (nrows, ncols, nnz))


_CASES = {
    "dae_gather": _case_dae_gather,
    "dae_merge": _case_dae_merge,
    "flash_attention": _case_flash_attention,
    "flash_decode": _case_flash_decode,
    "flash_decode_paged": _case_flash_decode_paged,
    "grouped_matmul": _case_grouped_matmul,
    "batched_searchsorted": _case_batched_searchsorted,
    "hash_lookup": _case_hash_lookup,
    "dae_spmv": _case_dae_spmv,
}


def test_every_kernel_dims_op_has_a_dispatch_case():
    """Adding a tunable op without tuned-dispatch coverage fails here."""
    assert set(_CASES) == set(KERNEL_DIMS)


@pytest.mark.parametrize("op", sorted(_CASES))
def test_tuned_knobs_actually_dispatch(op):
    tuned, untuned, expected, planted, dims = _CASES[op]()
    assert tuned == expected, (
        f"{op}: planted cache knobs did not reach the kernel "
        f"(got {tuned}, planted {expected})")
    assert seam_knobs(op, planted, dims) == expected
    assert tuned != untuned, (
        f"{op}: tuned and untuned runs dispatched identically ({tuned})")


# -- entries and calls shaped like the reference's ----------------------------


@pytest.mark.parametrize("op,config,kw", [
    ("dae_gather", {"method": "rif", "chunk": 16, "rif": 5, "block_d": 256},
     {}),
    ("flash_attention", {"bq": 16, "bk": 16, "rif": 3}, {}),
    ("grouped_matmul", {"bf": 64, "bd": 128, "rif": 3}, {}),
    ("grouped_matmul", {"bf": 512, "bd": 1024, "rif": 3},
     {"expected_bn": 256}),
    ("hash_lookup", {"chunk": 8, "rif": 3}, {}),
])
def test_reference_shaped_entries_dispatch(op, config, kw):
    tuned, _untuned, expected, planted, dims = _CASES[op](config=config,
                                                          **kw)
    assert tuned == expected
    assert seam_knobs(op, planted, dims) == expected


def test_knobs_without_a_counterpart_are_accepted_and_checked():
    from repro_torch.kernels.dae_chase.ops import hash_lookup
    from repro_torch.kernels.dae_gather.ops import dae_gather
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.grouped_matmul.ops import grouped_matmul
    r = np.random.default_rng(0)
    table = _t(r.standard_normal((16, 8)).astype(np.float32))
    idx = torch.tensor([3, 1, 2], dtype=torch.int32)
    want = table[idx.long()]
    assert torch.equal(dae_gather(table, idx, block_d=256), want)
    q = _bf16(r, (1, 2, 16, 64))
    ref = flash_attention(q, q, q, method="ref")
    torch.testing.assert_close(flash_attention(q, q, q, bq=128, bk=256), ref,
                               rtol=0, atol=0)
    x, w = _bf16(r, (128, 64)), _bf16(r, (1, 64, 32))
    blk = torch.zeros(1, dtype=torch.int32)
    torch.testing.assert_close(grouped_matmul(x, w, blk, bf=512, bd=1024),
                               grouped_matmul(x, w, blk, method="ref"),
                               rtol=0, atol=0)
    hash_table, chain = _hash_inputs()
    assert torch.equal(hash_lookup(*hash_table, max_steps=chain, rif=64),
                       hash_lookup(*hash_table, max_steps=chain,
                                   method="ref"))
    for call in (lambda: dae_gather(table, idx, block_d=0),
                 lambda: flash_attention(q, q, q, bq=0),
                 lambda: grouped_matmul(x, w, blk, bd=-1),
                 lambda: grouped_matmul(x, w, blk, bf=0)):
        with pytest.raises(ValueError, match="positive"):
            call()
