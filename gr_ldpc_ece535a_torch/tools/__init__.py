"""The kernel study scripts: counterparts of the JAX package's TPU
prototypes under ``tools/``, run with ``python -m``."""
