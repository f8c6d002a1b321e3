"""The ChaseSpec callables as a register program the CUDA kernel runs.

The TPU kernel ``ring_chase`` traces a :class:`~repro_torch.compile.ir.
ChaseSpec`'s ``addr_fn``/``step_fn``/``out_fn`` into its own body.  A
CUDA kernel cannot call Python, and building one ``.cu`` per spec would
put ``nvcc`` on the call path.  So this module traces the three
callables once, with symbolic int32 values (:class:`Sym`), into a flat
register program that ``csrc/ring_chase.cu`` interprets per item and
level.  One spec then runs in three places:

* on Python or numpy ints, in the check pass's pre-run;
* on torch int32 tensors of all items at once, the kernel's plain
  version;
* under the tracer, for the kernel.

For that the callables use Python operators (``+ - * // % < <= > >= ==
!= & | ^ ~`` and unary ``-``) and this module's :func:`where`,
:func:`minimum`, :func:`maximum` and :func:`clip`, which dispatch on
what they are given.  A Python ``if`` on a traced value raises, as it
does on a jnp tracer.

Semantics are numpy's int32: ``+ - *`` wrap modulo 2^32, ``//`` and
``%`` round toward minus infinity, ``x // 0`` and ``x % 0`` are 0, and a
comparison gives 0 or 1.  ``~`` is logical not on a comparison's result
and bitwise not on an integer, as jnp treats bool and int32.
:func:`run_numpy` executes a program with exactly the kernel's rules.

The program is an int32 vector: a header of :data:`HEADER` words, then
``n_instr`` instructions of 5 words ``(op, dst, a, b, c)`` (opcodes in
:data:`OPS`): ``CONST`` puts the immediate ``a`` in ``dst``, the unary
ops read ``a``, ``WHERE`` sets ``dst = c ? a : b`` and the rest
``dst = a op b``.  Registers ``0..S-1`` hold the item's state and ``S..S+W-1``
its loaded row when a section starts.  The three sections follow each
other: the address program (its result in register ``addr_out``), the
step program (the new state in ``step_out[0..S-1]``) and the output
program (``(store_addr, store_value)`` in ``out_regs``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Sym", "ChaseProgram", "trace_chase", "run_numpy", "where",
           "minimum", "maximum", "clip", "MAX_STATE", "MAX_ROW",
           "MAX_REGS", "MAX_INSTR", "OPS"]

# the limits of csrc/ring_chase.cu (kMaxState, kMaxRow, kMaxRegs,
# kMaxInstr); the tracer raises above them
MAX_STATE = 8
MAX_ROW = 8
MAX_REGS = 64
MAX_INSTR = 512

OPS = {name: i for i, name in enumerate((
    "CONST", "ADD", "SUB", "MUL", "FDIV", "FMOD", "LT", "LE", "GT", "GE",
    "EQ", "NE", "AND", "OR", "XOR", "NOT", "LNOT", "NEG", "WHERE", "MIN",
    "MAX"))}
_UNARY = {OPS["NOT"], OPS["LNOT"], OPS["NEG"]}
_BOOL_OPS = {OPS[k] for k in ("LT", "LE", "GT", "GE", "EQ", "NE", "LNOT")}
# header: S, W, n_regs, n_addr, n_step, n_out, addr_out,
#         step_out[MAX_STATE], out_addr_reg, out_val_reg
HEADER = 7 + MAX_STATE + 2
INT32_MIN, INT32_MAX = -(1 << 31), (1 << 31) - 1


# ---------------------------------------------------------------------------
# Tracing
# ---------------------------------------------------------------------------


class _Trace:
    """Collects one section's instructions in SSA form."""

    def __init__(self, n_inputs: int):
        self.n_values = n_inputs          # values 0..n_inputs-1 are inputs
        self.instrs: List[Tuple[int, int, int, int, int]] = []
        self.consts: Dict[Tuple[int, bool], "Sym"] = {}

    def emit(self, op: int, a: int = 0, b: int = 0, c: int = 0,
             is_bool: bool = False) -> "Sym":
        dst = self.n_values
        self.n_values += 1
        self.instrs.append((op, dst, a, b, c))
        return Sym(self, dst, is_bool)

    def const(self, v) -> "Sym":
        if isinstance(v, (bool, np.bool_)):
            v, is_bool = int(v), True
        else:
            is_bool = False
        if not isinstance(v, (int, np.integer)):
            raise TypeError(f"a chase program computes on int32; got "
                            f"{type(v).__name__} {v!r}")
        v = int(v)
        if not INT32_MIN <= v <= INT32_MAX:
            raise ValueError(f"constant {v} does not fit int32")
        sym = self.consts.get((v, is_bool))
        if sym is None:
            sym = self.consts[v, is_bool] = self.emit(OPS["CONST"], v,
                                                      is_bool=is_bool)
        return sym


class Sym:
    """A traced int32 value: the index of its value in one section."""

    __slots__ = ("trace", "value", "is_bool")
    __array_ufunc__ = None       # numpy scalars defer to our reflected ops
    __hash__ = None

    def __init__(self, trace: _Trace, value: int, is_bool: bool = False):
        self.trace, self.value, self.is_bool = trace, value, is_bool

    def _lift(self, other) -> "Sym":
        if isinstance(other, Sym):
            if other.trace is not self.trace:
                raise ValueError("values of two traces mixed")
            return other
        return self.trace.const(other)

    def _bin(self, op: str, other, swap: bool = False) -> "Sym":
        o = self._lift(other)
        a, b = (o, self) if swap else (self, o)
        code = OPS[op]
        is_bool = code in _BOOL_OPS or (
            op in ("AND", "OR", "XOR") and a.is_bool and b.is_bool)
        return self.trace.emit(code, a.value, b.value, is_bool=is_bool)

    def __add__(self, o): return self._bin("ADD", o)
    def __radd__(self, o): return self._bin("ADD", o, True)
    def __sub__(self, o): return self._bin("SUB", o)
    def __rsub__(self, o): return self._bin("SUB", o, True)
    def __mul__(self, o): return self._bin("MUL", o)
    def __rmul__(self, o): return self._bin("MUL", o, True)
    def __floordiv__(self, o): return self._bin("FDIV", o)
    def __rfloordiv__(self, o): return self._bin("FDIV", o, True)
    def __mod__(self, o): return self._bin("FMOD", o)
    def __rmod__(self, o): return self._bin("FMOD", o, True)
    def __lt__(self, o): return self._bin("LT", o)
    def __le__(self, o): return self._bin("LE", o)
    def __gt__(self, o): return self._bin("GT", o)
    def __ge__(self, o): return self._bin("GE", o)
    def __eq__(self, o): return self._bin("EQ", o)
    def __ne__(self, o): return self._bin("NE", o)
    def __and__(self, o): return self._bin("AND", o)
    def __rand__(self, o): return self._bin("AND", o, True)
    def __or__(self, o): return self._bin("OR", o)
    def __ror__(self, o): return self._bin("OR", o, True)
    def __xor__(self, o): return self._bin("XOR", o)
    def __rxor__(self, o): return self._bin("XOR", o, True)

    def __invert__(self):
        if self.is_bool:
            return self.trace.emit(OPS["LNOT"], self.value, is_bool=True)
        return self.trace.emit(OPS["NOT"], self.value)

    def __neg__(self):
        return self.trace.emit(OPS["NEG"], self.value)

    def __pos__(self):
        return self

    def __bool__(self):
        raise TypeError("a traced chase value has no truth value: use "
                        "repro_torch.compile.chase.where instead of a "
                        "Python if")

    def __index__(self):
        raise TypeError("a traced chase value cannot be used as a Python "
                        "int")

    __int__ = __index__


def _sym_of(args) -> Any:
    for a in args:
        if isinstance(a, Sym):
            return a
    return None


def _is_scalar(x) -> bool:
    return isinstance(x, (int, bool, np.integer, np.bool_))


def where(c, a, b):
    """``a`` where ``c`` holds, else ``b``: jnp.where for every kind of
    value a ChaseSpec meets."""
    s = _sym_of((c, a, b))
    if s is not None:
        c, a, b = (s._lift(x) for x in (c, a, b))
        return s.trace.emit(OPS["WHERE"], a.value, b.value, c.value,
                            is_bool=a.is_bool and b.is_bool)
    if _is_scalar(c) and _is_scalar(a) and _is_scalar(b):
        return a if c else b
    t = next((x for x in (c, a, b) if isinstance(x, torch.Tensor)), None)
    if t is not None:
        cond = _tensor(c, t)
        if cond.dtype != torch.bool:
            cond = cond != 0
        return torch.where(cond, _tensor(a, t), _tensor(b, t))
    return np.where(c, a, b)


def _minmax(op: str, a, b):
    s = _sym_of((a, b))
    if s is not None:
        a, b = s._lift(a), s._lift(b)
        return s.trace.emit(OPS[op], a.value, b.value)
    if _is_scalar(a) and _is_scalar(b):
        return min(a, b) if op == "MIN" else max(a, b)
    t = next((x for x in (a, b) if isinstance(x, torch.Tensor)), None)
    if t is not None:
        fn = torch.minimum if op == "MIN" else torch.maximum
        return fn(_tensor(a, t), _tensor(b, t))
    return (np.minimum if op == "MIN" else np.maximum)(a, b)


def minimum(a, b):
    return _minmax("MIN", a, b)


def maximum(a, b):
    return _minmax("MAX", a, b)


def clip(x, lo, hi):
    """``minimum(maximum(x, lo), hi)``, as jnp.clip."""
    return minimum(maximum(x, lo), hi)


def _tensor(x, like: torch.Tensor) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, (bool, np.bool_)):
        return torch.tensor(bool(x), device=like.device)
    return torch.tensor(int(x), dtype=torch.int32, device=like.device)


@dataclasses.dataclass(eq=False)
class ChaseProgram:
    """A ChaseSpec's callables traced for ``S`` state words and rows of
    ``W`` words.  ``words`` is what the kernel runs (``staged`` keeps a
    copy per device, made at the first launch); the callables stay for
    the plain version."""

    words: np.ndarray             # int32, HEADER + 5 * n_instr
    s_width: int
    row_width: int
    addr_fn: Callable
    step_fn: Callable
    out_fn: Callable
    staged: Dict[Any, torch.Tensor] = dataclasses.field(
        default_factory=dict, repr=False)

    @property
    def n_instr(self) -> int:
        return (len(self.words) - HEADER) // 5

    @property
    def n_regs(self) -> int:
        return int(self.words[2])


def _allocate(instrs, n_inputs: int, outputs: Sequence[int]):
    """Map SSA values onto a small register file: a value's register is
    freed after its last use (outputs live to the end).  Inputs keep
    registers 0..n_inputs-1.  Returns (instructions, output registers,
    registers used)."""
    last = {}
    for i, (op, _dst, a, b, c) in enumerate(instrs):
        reads = (a,) if op in _UNARY else \
            () if op == OPS["CONST"] else \
            (a, b, c) if op == OPS["WHERE"] else (a, b)
        for v in reads:
            last[v] = i
    for v in outputs:
        last[v] = len(instrs)
    reg = {v: v for v in range(n_inputs)}
    free = sorted((v for v in range(n_inputs) if v not in last),
                  reverse=True)
    top = n_inputs
    out = []
    for i, (op, dst, a, b, c) in enumerate(instrs):
        if op == OPS["CONST"]:
            ra, rb, rc = a, 0, 0
        else:
            ra = reg[a]
            rb = 0 if op in _UNARY else reg[b]
            rc = reg[c] if op == OPS["WHERE"] else 0
        # free the operands that die here before choosing dst
        for v in {a, b, c} if op != OPS["CONST"] else ():
            if v in reg and last.get(v) == i:
                free.append(reg[v])
        if free:
            free.sort(reverse=True)
            rd = free.pop()
        else:
            rd, top = top, top + 1
        reg[dst] = rd
        if dst not in last:                       # never read
            free.append(rd)
        out.append((op, rd, ra, rb, rc))
    return out, [reg[v] for v in outputs], top


def _section(fn: Callable, args, n_inputs: int, n_out: int, what: str):
    tr = args[0][0].trace if args and args[0] else None
    res = fn(*args)
    if n_out == 1:
        res = (res,)
    res = tuple(res)
    if len(res) != n_out:
        raise ValueError(f"{what} returned {len(res)} values, expected "
                         f"{n_out}")
    outs = []
    for v in res:
        if isinstance(v, Sym):
            if v.trace is not tr:
                raise ValueError(f"{what} returned a value of another trace")
            outs.append(v.value)
        else:
            outs.append(tr.const(v).value)
    return _allocate(tr.instrs, n_inputs, outs)


def trace_chase(addr_fn: Callable, step_fn: Callable, out_fn: Callable,
                s_width: int, row_width: int) -> ChaseProgram:
    """Trace a ChaseSpec's callables into a :class:`ChaseProgram`.
    Raises ``ValueError`` above the kernel's limits: ``S <= MAX_STATE``,
    ``W <= MAX_ROW``, ``MAX_REGS`` registers, ``MAX_INSTR`` instructions."""
    if not 1 <= s_width <= MAX_STATE:
        raise ValueError(f"chase state width {s_width} outside "
                         f"[1, {MAX_STATE}] (ring_chase.cu kMaxState)")
    if not 1 <= row_width <= MAX_ROW:
        raise ValueError(f"chase port row width {row_width} outside "
                         f"[1, {MAX_ROW}] (ring_chase.cu kMaxRow)")
    s, w = s_width, row_width

    def state(tr):
        return tuple(Sym(tr, j) for j in range(s))

    tr = _Trace(s)
    addr, (addr_out,), r_addr = _section(addr_fn, (state(tr),), s, 1,
                                         "addr_fn")
    tr = _Trace(s + w)
    row = tuple(Sym(tr, s + j) for j in range(w))
    step, step_out, r_step = _section(step_fn, (state(tr), row), s + w, s,
                                      "step_fn")
    tr = _Trace(s)
    out, out_regs, r_out = _section(out_fn, (state(tr),), s, 2, "out_fn")

    n_regs = max(r_addr, r_step, r_out)
    n_instr = len(addr) + len(step) + len(out)
    if n_regs > MAX_REGS:
        raise ValueError(f"chase program needs {n_regs} registers, more "
                         f"than the kernel's {MAX_REGS}")
    if n_instr > MAX_INSTR:
        raise ValueError(f"chase program has {n_instr} instructions, more "
                         f"than the kernel's {MAX_INSTR}")
    header = [s, w, n_regs, len(addr), len(step), len(out), addr_out,
              *step_out, *[0] * (MAX_STATE - s), *out_regs]
    words = np.asarray(header + [x for ins in addr + step + out
                                 for x in ins], dtype=np.int64)
    return ChaseProgram(words.astype(np.int32), s, w, addr_fn, step_fn,
                        out_fn)


# ---------------------------------------------------------------------------
# The kernel's interpreter, in numpy
# ---------------------------------------------------------------------------


def _floordiv(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a64, b64 = a.astype(np.int64), b.astype(np.int64)
    safe = np.where(b64 == 0, 1, b64)
    q = np.where(b64 == 0, 0, np.floor_divide(a64, safe))
    return _wrap_arr(q)


def _floormod(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a64, b64 = a.astype(np.int64), b.astype(np.int64)
    safe = np.where(b64 == 0, 1, b64)
    return np.where(b64 == 0, 0, np.mod(a64, safe)).astype(np.int32)


def _wrap_arr(x: np.ndarray) -> np.ndarray:
    return ((x.astype(np.int64) + (1 << 31)) % (1 << 32)
            - (1 << 31)).astype(np.int32)


def _exec(instrs: np.ndarray, regs: List[np.ndarray]) -> None:
    for op, d, a, b, c in instrs.tolist():
        if op == OPS["CONST"]:
            regs[d] = np.full_like(regs[0], a)
            continue
        x = regs[a]
        y = regs[b]
        if op == OPS["ADD"]:
            v = _wrap_arr(x.astype(np.int64) + y)
        elif op == OPS["SUB"]:
            v = _wrap_arr(x.astype(np.int64) - y)
        elif op == OPS["MUL"]:
            v = _wrap_arr(x.astype(np.int64) * y)
        elif op == OPS["FDIV"]:
            v = _floordiv(x, y)
        elif op == OPS["FMOD"]:
            v = _floormod(x, y)
        elif op == OPS["LT"]:
            v = x < y
        elif op == OPS["LE"]:
            v = x <= y
        elif op == OPS["GT"]:
            v = x > y
        elif op == OPS["GE"]:
            v = x >= y
        elif op == OPS["EQ"]:
            v = x == y
        elif op == OPS["NE"]:
            v = x != y
        elif op == OPS["AND"]:
            v = x & y
        elif op == OPS["OR"]:
            v = x | y
        elif op == OPS["XOR"]:
            v = x ^ y
        elif op == OPS["NOT"]:
            v = ~x
        elif op == OPS["LNOT"]:
            v = x == 0
        elif op == OPS["NEG"]:
            v = _wrap_arr(-x.astype(np.int64))
        elif op == OPS["WHERE"]:
            v = np.where(regs[c] != 0, x, y)
        elif op == OPS["MIN"]:
            v = np.minimum(x, y)
        elif op == OPS["MAX"]:
            v = np.maximum(x, y)
        else:
            raise ValueError(f"unknown chase opcode {op}")
        regs[d] = np.asarray(v).astype(np.int32)


def _sections(words: np.ndarray):
    n_addr, n_step, n_out = (int(x) for x in words[3:6])
    body = words[HEADER:].reshape(-1, 5)
    return (body[:n_addr], body[n_addr:n_addr + n_step],
            body[n_addr + n_step:n_addr + n_step + n_out])


def run_numpy(prog: ChaseProgram, port: np.ndarray, state0: np.ndarray,
              max_steps: int) -> Tuple[np.ndarray, np.ndarray]:
    """The kernel's computation in numpy: every item walks ``max_steps``
    levels (address, clipped row load, step), then the output program.
    ``port`` (N, W) int32, ``state0`` (M, S) int32."""
    w = prog.words
    s, rw, n_regs = (int(x) for x in w[:3])
    addr_out = int(w[6])
    step_out = [int(x) for x in w[7:7 + s]]
    out_regs = [int(x) for x in w[7 + MAX_STATE:9 + MAX_STATE]]
    addr_p, step_p, out_p = _sections(w)
    st = [state0[:, j].astype(np.int32) for j in range(s)]
    zero = np.zeros(state0.shape[0], np.int32)
    n = port.shape[0]

    def regs_with(extra=()):
        regs = [zero] * max(n_regs, s + rw)
        regs[:s] = st
        for j, v in enumerate(extra):
            regs[s + j] = v
        return regs

    for _ in range(max_steps):
        regs = regs_with()
        _exec(addr_p, regs)
        a = np.clip(regs[addr_out], 0, n - 1)
        row = port[a]
        regs = regs_with([row[:, j].astype(np.int32) for j in range(rw)])
        _exec(step_p, regs)
        st = [regs[r] for r in step_out]
    regs = regs_with()
    _exec(out_p, regs)
    return regs[out_regs[0]], regs[out_regs[1]]
