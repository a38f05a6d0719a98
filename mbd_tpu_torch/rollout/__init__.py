from .fused import rollout_outputs, rollout_qs, rollout_rewards  # noqa: F401
