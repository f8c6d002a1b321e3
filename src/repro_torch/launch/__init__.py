"""Step functions the launchers run: the counterpart of
``repro.launch`` (``make_train_step``, ``default_optimizer``,
``make_prefill_step`` and ``make_serve_step``)."""
