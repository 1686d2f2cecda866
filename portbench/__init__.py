"""The benchmark of feastkit_tpu_torch (the PyTorch and CUDA port).

``run.py`` runs one cell of ``BENCHMARK.json`` once. Everything that
belongs to one configuration, traffic mix, per-layer metric or kernel
family is a file of its own here, found by its name: ``configs/``,
``traffic/``, ``metrics/``, ``kernels/``; ``generators/`` build the
problems a configuration names and ``reference/`` holds their plain NumPy
references. Nothing here imports jax, jaxlib or the JAX package.
"""
