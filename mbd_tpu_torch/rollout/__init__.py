from .fused import rollout_qs, rollout_rewards  # noqa: F401
