"""plan_s: the time to a plan, the window's span over the plans it
completed (host clock; rank 0's span between two barriers on a mesh)."""


def read(record):
    return record["span_s"] / record["plans"]
