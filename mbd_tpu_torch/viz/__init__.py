"""The HTML trajectory viewer (port of ``mbd_tpu/viz``)."""

from .html import render, render_states  # noqa: F401
