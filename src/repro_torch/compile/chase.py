"""The ChaseSpec callables as straight-line C++ the CUDA kernel runs.

The TPU kernel ``ring_chase`` traces a :class:`~repro_torch.compile.ir.
ChaseSpec`'s ``addr_fn``/``step_fn``/``out_fn`` into its own body.  A
CUDA kernel cannot call Python.  So this module traces the three
callables once, with symbolic int32 values (:class:`Sym`), into a flat
register program, and :func:`emit_program` writes that program as three
straight-line C++ functions over ``int32_t`` values in registers, with
constants as literals.  :meth:`ChaseProgram.source` wraps them into a
``.cu`` that includes ``csrc/ring_chase.cuh``; the kernel wrapper builds
it with ``nvcc`` at the program's first launch (cached by a hash of the
source, see ``kernels/common.py::load_generated``).  One spec then runs
in three places:

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
The emitted C++ keeps them: ``+ - *`` and unary ``-`` through
``uint32_t``, ``//`` and ``%`` through ``chase::fdiv``/``chase::fmod``
(``ring_chase.cuh``), folded to a shift or a mask where the divisor is a
constant power of two.

A spec may have any state width S and row width W, and its program any
length, as the TPU kernel's (its state in SMEM, its rows through a VMEM
ring): the emitted functions stay straight-line, so a long program costs
``nvcc`` time only.  ``csrc/ring_chase.cuh`` runs a program of at most 8
state and 8 row words on its register path and any other on its
shared-memory path (``kernels/compiled/kernel.py::chase_register_path``);
each emitted function reads an input word where it first uses it, so a
step that reads a few words of a wide row loads only those.

The program is an int32 vector: a header of :func:`header_words` (S)
words, then ``n_instr`` instructions of 5 words ``(op, dst, a, b, c)``
(opcodes in :data:`OPS`): ``CONST`` puts the immediate ``a`` in ``dst``,
the unary ops read ``a``, ``WHERE`` sets ``dst = c ? a : b`` and the
rest ``dst = a op b``.  Registers ``0..S-1`` hold the item's state and
``S..S+W-1`` its loaded row when a section starts.  The three sections
follow each other: the address program (its result in register
``addr_out``), the step program (the new state in ``step_out[0..S-1]``)
and the output program (``(store_addr, store_value)`` in ``out_regs``).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import common as _common
from repro_torch.kernels.compiled.kernel import (WINDOW_WORDS,
                                                 chase_register_path)

__all__ = ["Sym", "ChaseProgram", "trace_chase", "run_numpy",
           "emit_program", "where", "minimum", "maximum", "clip",
           "header_words", "OPS"]

OPS = {name: i for i, name in enumerate((
    "CONST", "ADD", "SUB", "MUL", "FDIV", "FMOD", "LT", "LE", "GT", "GE",
    "EQ", "NE", "AND", "OR", "XOR", "NOT", "LNOT", "NEG", "WHERE", "MIN",
    "MAX"))}
_UNARY = {OPS["NOT"], OPS["LNOT"], OPS["NEG"]}
_BOOL_OPS = {OPS[k] for k in ("LT", "LE", "GT", "GE", "EQ", "NE", "LNOT")}
INT32_MIN, INT32_MAX = -(1 << 31), (1 << 31) - 1


def header_words(s_width: int) -> int:
    """Words of a program's header: S, W, n_regs, n_addr, n_step, n_out,
    addr_out, step_out[S], out_addr_reg, out_val_reg."""
    return 7 + s_width + 2


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
    ``W`` words.  ``words`` is what the kernel is generated from
    (:meth:`source`); the callables stay for the plain version."""

    words: np.ndarray             # int32, header_words(S) + 5 * n_instr
    s_width: int
    row_width: int
    addr_fn: Callable
    step_fn: Callable
    out_fn: Callable
    # source() and library_name() (by compiler flags), made once: every
    # launch asks for both
    _memo: Dict[Any, str] = dataclasses.field(default_factory=dict,
                                              init=False, repr=False)

    @property
    def n_instr(self) -> int:
        return (len(self.words) - header_words(self.s_width)) // 5

    @property
    def n_regs(self) -> int:
        return int(self.words[2])

    def op_counts(self) -> Tuple[int, int, int]:
        """Instructions of the address, step and output sections that
        compute at run time: a ``CONST`` is a literal of the emitted C++
        and costs nothing."""
        return tuple(int((sec[:, 0] != OPS["CONST"]).sum())
                     for sec in _sections(self.words))

    def source(self) -> str:
        """The CUDA source of this program's kernel library: the emitted
        functions, ``csrc/ring_chase.cuh``'s kernel and its C entry."""
        if "source" not in self._memo:
            self._memo["source"] = (
                f"// The chase kernel of one traced program, generated by "
                f"repro_torch.compile.chase.\n"
                f"#include \"exports.cuh\"\n#include \"ring_chase.cuh\"\n\n"
                f"{emit_program(self.words)}\nREPRO_CHASE_ENTRY(Program)\n")
        return self._memo["source"]

    def library_name(self) -> str:
        """``chase_<hash>``: a hash of :meth:`source`, the headers it
        includes and the compiler flags, so an edit to any of them names
        a new library."""
        key = ("name", _common.NVCC_FLAGS)
        if key not in self._memo:
            h = hashlib.sha256(self.source().encode())
            for header in ("ring_chase.cuh", "ring.cuh", "exports.cuh"):
                h.update((_common.CSRC / header).read_bytes())
            h.update(" ".join(_common.NVCC_FLAGS).encode())
            self._memo[key] = f"chase_{h.hexdigest()[:20]}"
        return self._memo[key]


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
    if n_out == 1 and not isinstance(res, (tuple, list)):
        res = (res,)                  # addr_fn's value; a 1-wide state
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
    """Trace a ChaseSpec's callables into a :class:`ChaseProgram` of any
    state width, row width and length.  Raises ``TypeError`` on a
    Python truth value of a traced value, ``ValueError`` on a constant
    outside int32 or a callable that returns the wrong number of
    values."""
    if s_width < 1 or row_width < 1:
        raise ValueError(f"a chase needs a state and a row, got S={s_width}"
                         f", W={row_width}")
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
    header = [s, w, n_regs, len(addr), len(step), len(out), addr_out,
              *step_out, *out_regs]
    words = np.asarray(header + [x for ins in addr + step + out
                                 for x in ins], dtype=np.int64)
    return ChaseProgram(words.astype(np.int32), s, w, addr_fn, step_fn,
                        out_fn)


# ---------------------------------------------------------------------------
# The kernel's arithmetic, in numpy
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
    body = words[header_words(int(words[0])):].reshape(-1, 5)
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
    out_regs = [int(x) for x in w[7 + s:9 + s]]
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


# ---------------------------------------------------------------------------
# The program as straight-line C++
# ---------------------------------------------------------------------------


def _literal(v: int) -> str:
    if v == INT32_MIN:
        return "(-2147483647 - 1)"
    return f"({v})" if v < 0 else str(v)


def _pow2(v: Optional[int]) -> Optional[int]:
    """log2 of a positive power of two, else None."""
    if v is None or v <= 0 or v & (v - 1):
        return None
    return v.bit_length() - 1


def _expr(op: int, x: str, y: str, z: str, y_const: Optional[int]) -> str:
    """One instruction's value: ``x``, ``y``, ``z`` the operands (a
    register or a literal), ``y_const`` the divisor when it is one."""
    name = _OP_NAMES[op]
    if name in ("ADD", "SUB", "MUL"):
        return f"chase::{name.lower()}({x}, {y})"
    if name == "FDIV":
        k = _pow2(y_const)
        if y_const == 0:
            return "0"
        if y_const == -1:
            return f"chase::neg({x})"
        if k is not None:
            return x if k == 0 else f"({x} >> {k})"     # floor, as //
        return f"chase::fdiv({x}, {y})"
    if name == "FMOD":
        k = _pow2(y_const)
        if y_const in (0, -1, 1):
            return "0"
        if k is not None:
            return f"({x} & {(1 << k) - 1})"           # floor, as %
        return f"chase::fmod({x}, {y})"
    cmp = {"LT": "<", "LE": "<=", "GT": ">", "GE": ">=", "EQ": "==",
           "NE": "!="}
    if name in cmp:
        return f"(int32_t)({x} {cmp[name]} {y})"
    bit = {"AND": "&", "OR": "|", "XOR": "^"}
    if name in bit:
        return f"({x} {bit[name]} {y})"
    if name == "NOT":
        return f"(~{x})"
    if name == "LNOT":
        return f"(int32_t)({x} == 0)"
    if name == "NEG":
        return f"chase::neg({x})"
    if name == "WHERE":
        return f"({z} != 0 ? {x} : {y})"
    if name == "MIN":
        return f"({x} < {y} ? {x} : {y})"
    if name == "MAX":
        return f"({x} > {y} ? {x} : {y})"
    raise ValueError(f"unknown chase opcode {op}")


def _input_reads(instrs: np.ndarray, n_inputs: int,
                  results: Sequence[int]) -> set:
    """The inputs a section reads: a register below ``n_inputs`` read
    before any instruction writes it."""
    written, read = set(), set()
    for op, d, a, b, c in instrs.tolist():
        if op != OPS["CONST"]:
            regs = (a,) if op in _UNARY else \
                (a, b, c) if op == OPS["WHERE"] else (a, b)
            read.update(r for r in regs
                        if r < n_inputs and r not in written)
        written.add(d)
    read.update(r for r in results if r < n_inputs and r not in written)
    return read


def _emit_section(instrs: np.ndarray, n_regs: int, inputs: Sequence[str],
                  results: Sequence[Tuple[str, int]],
                  stream: Optional[Tuple[int, int, List[int]]] = None
                  ) -> List[str]:
    """The body of one emitted function: registers ``r0..`` (0 until
    set, as in :func:`run_numpy`), an input read into its register just
    before its first use (an input no instruction reads is never
    loaded), one assignment per instruction with constant operands as
    literals, then ``results`` (target, register) assignments.  Every
    input a result names is read before the first result is stored, so
    a target may alias an input (``step`` may write the state in
    place).

    ``stream`` = (S, W, windows) emits the streamed path's step: the row
    words are inputs S .. S + W - 1, and the first use of one loads its
    whole 16-byte unit (every word of it the section reads) through
    ``row.template unit<U>()``, after ``row.template window<I>()`` where
    the unit lies in another window of :data:`WINDOW_WORDS` words than
    the last one loaded; ``windows`` receives the window of each
    ``window<I>``.  A word loaded early keeps its register: an input's
    register is not reused before the input's last use."""
    lines = [f"    int32_t r{i} = 0;" for i in range(n_regs)]
    const: Dict[int, int] = {}
    set_regs = set()                 # inputs loaded, or registers written
    if stream is not None:
        s, w, windows = stream
        reads = _input_reads(instrs, len(inputs), [r for _t, r in results])

    def load_unit(q: int) -> None:
        u = q // 4
        window = 4 * u // WINDOW_WORDS
        if not windows or windows[-1] != window:
            lines.append(f"    row.template window<{len(windows)}>();")
            windows.append(window)
        lines.append(f"    {{ const chase::Unit u = row.template unit<{u}>();")
        for k, field in enumerate("xyzw"):
            r = s + 4 * u + k
            if 4 * u + k < w and r in reads and r not in set_regs:
                lines.append(f"      r{r} = u.{field};")
                set_regs.add(r)
        lines.append("    }")
        if s + q not in set_regs:
            raise AssertionError(f"row word {q} read but not loaded")

    def use(r: int) -> str:
        if r in const:
            return _literal(const[r])
        if r < len(inputs) and r not in set_regs:
            if stream is not None and r >= s:
                load_unit(r - s)
            else:
                lines.append(f"    r{r} = {inputs[r]};")
                set_regs.add(r)
        return f"r{r}"

    for op, d, a, b, c in instrs.tolist():
        if op == OPS["CONST"]:
            lines.append(f"    r{d} = {_literal(a)};")
            const[d] = a
            set_regs.add(d)
            continue
        unary = op in _UNARY
        value = _expr(op, use(a), "" if unary else use(b),
                      use(c) if op == OPS["WHERE"] else "",
                      None if unary else const.get(b))
        lines.append(f"    r{d} = {value};")
        const.pop(d, None)
        set_regs.add(d)
    values = [use(r) for _target, r in results]
    lines += [f"    {target} = {v};"
              for (target, _r), v in zip(results, values)]
    return lines


def emit_program(words: np.ndarray) -> str:
    """A traced program (``ChaseProgram.words``) as the C++ struct
    ``Program`` that ``csrc/ring_chase.cuh``'s kernel is instantiated
    on: ``S`` and ``W``, and ``addr``, ``step`` and ``out`` as
    ``REPRO_CHASE_FN`` function templates, straight-line over
    ``int32_t`` registers.  The state and the row are anything indexable
    by a word number (an array in registers, a pointer into shared
    memory); ``step``'s ``next`` may be its state.  The functions compile
    for the host too."""
    w = np.asarray(words).astype(np.int64)
    s, rw, n_regs = (int(x) for x in w[:3])
    n = max(n_regs, s + rw)
    addr_out = int(w[6])
    step_out = [int(x) for x in w[7:7 + s]]
    out_regs = [int(x) for x in w[7 + s:9 + s]]
    addr_p, step_p, out_p = _sections(w)
    state = [f"s[{j}]" for j in range(s)]
    row = [f"row[{j}]" for j in range(rw)]
    step_results = [(f"next[{j}]", r) for j, r in enumerate(step_out)]
    stream: List[str] = []
    if not chase_register_path(s, rw):
        windows: List[int] = []
        body = _emit_section(step_p, n, state + row, step_results,
                             (s, rw, windows))
        stream = [
            f"  static constexpr int kNumWindows = {len(windows)};",
            "  static constexpr int kWindows[] = "
            f"{{{', '.join(map(str, windows or [0]))}}};",
            "  template <class St, class Row, class Next>",
            "  REPRO_CHASE_FN static void stream_step(const St& s, Row& row,",
            "                                         Next& next) {",
            *body,
            "  }"]
    return "\n".join([
        "struct Program {",
        f"  static constexpr int S = {s};",
        f"  static constexpr int W = {rw};",
        "  template <class St>",
        "  REPRO_CHASE_FN static int32_t addr(const St& s) {",
        "    int32_t a;",
        *_emit_section(addr_p, n, state, [("a", addr_out)]),
        "    return a;",
        "  }",
        "  template <class St, class Row, class Next>",
        "  REPRO_CHASE_FN static void step(const St& s, const Row& row,",
        "                                  Next& next) {",
        *_emit_section(step_p, n, state + row, step_results),
        "  }",
        *stream,
        "  template <class St>",
        "  REPRO_CHASE_FN static void out(const St& s, int32_t& store_addr,",
        "                                 int32_t& store_value) {",
        *_emit_section(out_p, n, state, [("store_addr", out_regs[0]),
                                         ("store_value", out_regs[1])]),
        "  }",
        "};",
        ""])


_OP_NAMES = {v: k for k, v in OPS.items()}
