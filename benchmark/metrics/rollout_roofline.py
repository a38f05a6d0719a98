"""rollout_roofline (%): the least time the plans' rollouts need (Σ over
their launches of the larger of operations over the float32 peak and
bytes over the memory rate, ``benchmark/work``) over the cards' busy
time in the traced window, summed over the ranks. The divisor is every
device operation, not one kernel by name, so a change that splits,
renames or replaces the kernel reads the same work."""


def read(record):
    busy = sum(r["busy_s"] for r in record["ranks"])
    if busy <= 0:
        return None
    return 100.0 * record["work"]["least_s"] / busy
