"""Black-box optimization with MBD (port of ``mbd_tpu/blackbox``):
``bbo`` on the test functions, ``mnist`` on an MLP's weights."""
