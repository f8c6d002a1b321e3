"""The dense GQA decoder of the first slice, module by module after
``repro.models``."""
