"""idle_share: 1 − the card's busy time (the union of its operations'
intervals) over the traced window; on a mesh, the largest over the
ranks."""


def read(record):
    ranks = [r for r in record["ranks"] if r["window_s"] > 0]
    if not ranks:
        return None
    return max(1.0 - r["busy_s"] / r["window_s"] for r in ranks)
