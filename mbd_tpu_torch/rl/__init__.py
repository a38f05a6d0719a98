"""RL baselines (port of ``mbd_tpu/rl``): PPO and SAC, their networks and
env wrappers, and the ``train`` CLI. Physics envs step through the CUDA
rollout kernel's state-out mode on the card (``batched_env.py``)."""
