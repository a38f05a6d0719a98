"""The yardstick's arithmetic: the work a plan needs, its bytes and the
least time an H100 could take for them (``count``)."""
