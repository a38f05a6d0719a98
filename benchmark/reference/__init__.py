"""The plain reference that decides ``correct``: plain PyTorch, importing
nothing of the program (``mbd_tpu_torch``) nor of the JAX package.

``system`` and ``engine`` are a frozen copy of the port's plain engine,
``rollout`` its batch-last rollout, ``models`` each configuration's reset
and reward, ``planner`` the reverse step and the final selection written
out, and ``check`` the comparison of the program's plans with it.
"""
