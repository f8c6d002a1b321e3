"""Chase programs past the register path's widths, shared by
``chip_smoke.py``, ``tools/ring_sweep.py`` and the tests: a B+-tree of
W-word nodes over a sorted table (its layout, its search as a
ChaseSpec's callables and as a DAE program) and a program for any state
and row width that mixes every row word into the state.

The callables use Python operators and ``compile.chase``'s
:func:`~repro_torch.compile.chase.where`, :func:`minimum` and
:func:`clip`, so one source runs on Python ints (a check pass's
pre-run), on tensors of all items (the kernel's plain version) and under
the tracer (the kernel)."""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.compile.chase import clip, minimum, where

__all__ = ["bptree", "bptree_offsets", "bptree_fns", "bptree_state0",
           "bptree_data", "bptree_program", "mix_fns"]


def bptree_offsets(n: int, w: int) -> List[int]:
    """The row each level of :func:`bptree`'s tree over n values starts
    at, root level first: the tree's shape depends on n and w alone."""
    sizes = [n // w]
    while sizes[0] > 1:
        sizes.insert(0, -(-sizes[0] // (w + 1)))
    return [sum(sizes[:i]) for i in range(len(sizes))]


def bptree(table, w: int) -> Tuple[Any, List[int]]:
    """The (w + 1)-way B+-tree over a sorted ``table`` of unique values
    whose length w divides: the leaves are the table's own rows reshaped
    to (n / w, w); each inner node holds the first key of each child
    right of its first (every w-th key of the level below), padded with
    the dtype's largest value.  Returns the rows, root level first, and
    the row each level starts at.  A numpy table gives numpy rows; a
    tensor gives a tensor on its device (the tree is built there)."""
    is_np = isinstance(table, np.ndarray)
    t = torch.from_numpy(np.ascontiguousarray(table)) if is_np else table
    pad = torch.iinfo(t.dtype).max
    f = w + 1
    first = t[::w]
    levels = [t.reshape(-1, w)]
    while first.shape[0] > 1:
        size = -(-first.shape[0] // f)
        node = torch.arange(size, device=t.device)
        idx = node[:, None] * f + torch.arange(1, w + 1,
                                               device=t.device)[None, :]
        levels.insert(0, torch.where(
            idx < first.shape[0], first[idx.clamp(max=first.shape[0] - 1)],
            pad).to(t.dtype))
        first = first[node * f]
    rows = torch.cat(levels)
    return (rows.numpy() if is_np else rows), bptree_offsets(t.shape[0], w)


def bptree_fns(offs: List[int], w: int) -> Tuple[Callable, Callable,
                                                 Callable]:
    """The search of a :func:`bptree` as a ChaseSpec's callables on the
    state (i, key, k, d): at depth d the node k of its level, whose keys
    at most the key count the child (at a leaf, the position), so after
    len(offs) lock-step levels ``out_fn`` gives (i, searchsorted(table,
    key, right=True))."""
    depth, f = len(offs), w + 1

    def addr_fn(st):
        _i, _key, k, d = st
        off = offs[-1]
        for lv in range(depth - 1):
            off = where(d == lv, offs[lv], off)
        return off + k

    def step_fn(st, row):
        i, key, k, d = st
        c = 0
        for j in range(w):
            c = c + (row[j] <= key)
        return i, key, where(d == depth - 1, k * w + c, k * f + c), d + 1

    def out_fn(st):
        return st[0], st[2]

    return addr_fn, step_fn, out_fn


def bptree_state0(keys):
    """The (M, 4) start states (i, key, 0, 0) of a search of ``keys``:
    int32 numpy for a numpy array, a tensor on the keys' device for a
    tensor."""
    if isinstance(keys, torch.Tensor):
        zero = torch.zeros_like(keys, dtype=torch.int32)
        return torch.stack([torch.arange(keys.shape[0], device=keys.device,
                                         dtype=torch.int32),
                            keys.to(torch.int32), zero, zero], 1)
    state0 = np.zeros((len(keys), 4), np.int32)
    state0[:, 0] = np.arange(len(keys))
    state0[:, 1] = keys
    return state0


def bptree_data(w: int, n: int, m: int, seed: int,
                dtype=np.int32) -> Dict[str, Any]:
    """A sorted table of n unique values (seeded gaps 1-15) in ``dtype``,
    its :func:`bptree` of w-word nodes, and m keys: half members, half
    uniform over the table's range and a little past it."""
    rng = np.random.default_rng(seed)
    table = np.cumsum(rng.integers(1, 16, n)).astype(dtype)
    keys = np.concatenate([table[rng.integers(0, n, m // 2)],
                           rng.integers(-5, int(table[-1]) + 16, m - m // 2)])
    rows, offs = bptree(table, w)
    return {"table": table, "keys": keys.astype(np.int64), "rows": rows,
            "offs": offs, "w": w}


def bptree_program(data: Dict[str, Any], *, dae=None, wl=None, ir=None,
                   rif: int = 8):
    """The search of :func:`bptree_data`'s keys as the simulator runs it:
    the round-robin chase that ``workloads._binsearch_phases`` builds
    (per key one node a level from the root down, the last level's count
    the answer), with channels of ``rif + 1``.  Returns a new program
    (a simulation consumes one), its memories and its ChaseSpec.
    ``dae``, ``wl`` and ``ir`` are the modules that build it (by
    default the port's ``core.dae``, ``core.workloads`` and
    ``compile.ir``; a test passes another package's of the same
    interface)."""
    if dae is None:
        from repro_torch.core import dae
    if wl is None:
        from repro_torch.core import workloads as wl
    if ir is None:
        from repro_torch.compile import ir
    rows, offs, keys, w = data["rows"], data["offs"], data["keys"], data["w"]
    depth, f = len(offs), w + 1

    def init_state(i):
        return (i, int(keys[i]), 0, 0), offs[0]

    def step(st, v):
        i, key, k, d = st
        c = int(np.count_nonzero(np.asarray(v) <= key))
        if d == depth - 1:
            return True, i, k * w + c, None, 0
        return False, 0, 0, (i, key, k * f + c, d + 1), offs[d + 1] + k * f + c

    ch = dae.LoadChannel("bt_load", capacity=rif + 1, port="tree")
    st = dae.StreamChannel("bt_state", capacity=rif + 1)
    gen = wl._roundrobin_chase(ch, st, len(keys), init_state, step, "out", rif)
    prog = dae.DaeProgram(f"bptree{w}", [dae.Process("roundrobin", gen)])
    mems = {"tree": list(rows), "out": [None] * len(keys)}
    spec = ir.ChaseSpec("tree", bptree_state0(keys), depth,
                        *bptree_fns(offs, w))
    return prog, mems, spec


def mix_fns(s: int, w: int) -> Tuple[Callable, Callable, Callable]:
    """A program for any S and W: every row word feeds the step (a
    wrapping polynomial hash, a running minimum, a count of words at most
    the state's second word), every state word moves, and floor division
    and modulo see negative operands.  At W 256 the traced program has
    more than 1,300 instructions."""
    def addr_fn(st):
        return clip(st[0] * 7919 + st[s - 1] // 3, 0, 1 << 20)

    def step_fn(st, row):
        acc, lo, n_le = st[0], row[0], 0
        for j in range(w):
            acc = acc * 31 + row[j]
            lo = minimum(lo, row[j])
            n_le = n_le + (row[j] <= st[1 % s])
        nxt = [acc]
        for k in range(1, s):
            x = where(st[k] < row[k % w], st[k - 1] ^ row[(7 * k) % w],
                      st[k] - lo)
            nxt.append(x + n_le * k + (st[k] // (row[k % w] % 7 - 8)))
        return tuple(nxt)

    def out_fn(st):
        total = st[0]
        for k in range(1, s):
            total = total + st[k]
        return st[0] % 1000, total

    return addr_fn, step_fn, out_fn
