"""Step functions the launchers run and the device meshes they place
on: the counterpart of ``repro.launch`` (``steps.py``:
``make_train_step``, ``default_optimizer``, ``make_prefill_step`` and
``make_serve_step``; ``mesh.py``: ``make_serve_meshes`` and the
debug and production meshes)."""
