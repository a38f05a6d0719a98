"""Command-line entry points (port of ``mbd_tpu/cli``)."""
