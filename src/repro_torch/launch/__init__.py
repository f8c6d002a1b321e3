"""Step functions the launchers run and the device meshes they place
on: the counterpart of ``repro.launch`` (``steps.py``:
``make_train_step``, ``default_optimizer``, ``make_prefill_step``,
``make_serve_step`` and their sharded wrappers ``shard_train_step``,
``shard_prefill_step`` and ``shard_serve_step``; ``specs.py``: the
steps' inputs on the ``meta`` device; ``mesh.py``: ``make_serve_meshes``
and the debug and production meshes)."""
