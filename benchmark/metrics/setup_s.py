"""setup_s: from the process's start to the end of the warm-up (host
clock): imports, the card, the env, the kernel's load (its build on a
checkout's first run), the warm-up plan; on a mesh the ranks' start and
NCCL's too."""


def read(record):
    return record["setup_s"]
