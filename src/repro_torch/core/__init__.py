"""The port's counterparts of ``repro.core``: RIF planning, tracing, the
explicitly-decoupled programming model (``dae``), its cycle-level
simulator (``simulator``, ``waveform``) and the paper's benchmark
programs (``workloads``).  The decoupled ops live in
``repro_torch.core.decouple``, which this ``__init__`` does not import
(the kernel layer imports ``core.pipeline``)."""
