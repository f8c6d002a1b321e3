"""Step functions the launchers run: the counterpart of
``repro.launch`` (only ``make_prefill_step`` so far)."""
