"""The benchmark of ``pavenet_tpu_torch``: see ``benchmark/README.md``."""
