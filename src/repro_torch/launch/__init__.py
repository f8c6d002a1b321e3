"""Step functions the launchers run: the counterpart of
``repro.launch`` (``make_train_step``, ``default_optimizer`` and
``make_prefill_step``)."""
