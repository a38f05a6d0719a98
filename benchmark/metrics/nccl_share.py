"""nccl_share: the device time of the operations whose name holds "nccl"
over the traced window, the largest over the ranks; it holds the wait
for the slowest rank. Nothing to read where no rank ran one."""


def read(record):
    ranks = [r for r in record["ranks"] if r["nccl_s"] > 0]
    if not ranks:
        return None
    return max(r["nccl_s"] / r["window_s"] for r in ranks)
