"""Profiling hooks and the fault-tolerant sweep launcher (port of
``mbd_tpu/utils``; its ``platform.py`` is TPU machinery and has no
counterpart here)."""
