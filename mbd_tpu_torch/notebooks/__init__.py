"""The 1-D demo of MBD (port of ``mbd_tpu/notebooks``)."""
