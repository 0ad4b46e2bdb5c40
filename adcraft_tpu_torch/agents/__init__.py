"""Learning agents: PPO, A2C and TD3 on the port's batched env.

Counterpart of ``adcraft_tpu/agents`` (the replacement for the
reference's Ray RLlib configs, adcraft/experiment_utils/agent_configs.py):
``networks`` (``torch.nn`` modules whose ``init`` draws flax's parameters
bit for bit), ``optim`` (optax's ``clip_by_global_norm`` and ``adam``),
``ppo``, ``a2c`` and ``td3``.
"""
