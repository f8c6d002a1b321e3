"""repro_torch.compile — a staged DAE → CUDA compiler, the port of
``repro.compile``.

The paper's dynamic-HLS arm *compiles* explicitly-decoupled programs
into hardware; this package closes the same loop for the port: any
rebuildable :class:`~repro_torch.core.dae.DaeProgram` lowers onto the
three ring kernels of :mod:`repro_torch.kernels.compiled` (CUDA on the
``csrc/ring.cuh`` ring) through a staged pass group, with the
event-driven simulator as the differential oracle.  ``elaborate``,
``infer`` and ``check`` are host code; ``codegen`` stages the ports on
the device once, and :class:`CompiledKernel` runs the rings there.

Pass group (the pymtl3 ``PassGroup`` shape — each pass a pure function
from the previous pass's artifact):

  ``elaborate``  DaeProgram + memories  ->  :class:`DaeIR`
  ``infer``      DaeIR  ->  per-channel :class:`ChannelPlan` (chunk/RIF)
  ``check``      DaeIR  ->  :class:`CheckResult` or :class:`CompileError`
  ``codegen``    DaeIR + plans  ->  :class:`CompiledKernel`

See ``docs/compiler.md`` for the pipeline diagram, the staging
semantics (what honestly compiles vs. what needs a
:class:`ChaseSpec`), and the add-a-workload-without-a-kernel
walkthrough.  A ChaseSpec for the port writes its callables with
:mod:`repro_torch.compile.chase`'s ``where``/``minimum``/``maximum``/
``clip``, which the CUDA kernel runs as a traced register program.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

from repro_torch.compile.check import CheckResult, CompileError, check
from repro_torch.compile.codegen import CompiledKernel, codegen
from repro_torch.compile.elaborate import ElaborationError, elaborate
from repro_torch.compile.infer import (ChannelPlan, infer_plans,
                                      program_key_parts)
from repro_torch.compile.ir import (ChannelIR, ChaseSpec, DaeIR, PortArray,
                              StoreIR, StreamKind)

__all__ = [
    "compile_program", "PASSES",
    "CompiledKernel", "CompileError", "ElaborationError",
    "ChaseSpec", "DaeIR", "ChannelIR", "StoreIR", "PortArray",
    "StreamKind", "ChannelPlan", "CheckResult",
    "elaborate", "infer_plans", "check", "codegen",
    "program_key_parts",
]

#: The staged pass group, in execution order.
PASSES = ("elaborate", "infer", "check", "codegen")


def compile_program(prog, memories: Optional[Dict[str, Any]] = None, *,
                    chase: Optional[ChaseSpec] = None,
                    rif: Optional[int] = None,
                    chunk: Optional[int] = None,
                    device=None,
                    max_steps: int = 1_000_000) -> CompiledKernel:
    """Compile ``prog`` into a runnable :class:`CompiledKernel`.

    ``memories`` maps port name -> indexable data (plain lists/arrays,
    or simulator ``MemoryModel`` objects — their ``.data`` is used).
    ``chase`` supplies the loop semantics for DEPENDENT access streams
    (see :class:`ChaseSpec`); ``rif``/``chunk`` override the inference
    pass (else: tune cache under the ``compiled:<name>`` key for
    ``device``'s backend, else ``plan_rif``).  ``device`` ``None`` means
    the card; pass ``"cpu"`` to run the kernels' plain versions here.  Raises
    :class:`CompileError` with per-finding diagnostics for programs the
    ring scaffolds cannot express.  The kernel's ``pass_seconds`` holds
    each pass's host seconds, keyed as :data:`PASSES`.
    """
    from repro_torch.kernels.common import resolve_device

    dev = resolve_device(device)
    mems = {port: getattr(data, "data", data)
            for port, data in (memories or {}).items()}
    clock = [time.perf_counter()]
    try:
        ir = elaborate(prog, mems, max_steps=max_steps)
    except ElaborationError as e:
        raise CompileError("elaborate", [str(e)]) from e
    clock.append(time.perf_counter())
    plans = infer_plans(ir, rif=rif, chunk=chunk, device=dev, chase=chase)
    clock.append(time.perf_counter())
    chk = check(prog, ir, chase=chase)
    clock.append(time.perf_counter())
    ck = codegen(ir, chk, plans, chase=chase, device=dev)
    clock.append(time.perf_counter())
    ck.pass_seconds = {p: b - a for p, a, b in
                       zip(PASSES, clock, clock[1:])}
    return ck
