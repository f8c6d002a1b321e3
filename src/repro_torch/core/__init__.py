"""The port's counterparts of ``repro.core``: RIF planning and tracing."""
