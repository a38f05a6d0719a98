"""The harness: finds a cell's files by name (``spec``), runs its plans in
a window (``window``, ``cell``), reduces a trace (``trace``) and writes
the result (``report``)."""
