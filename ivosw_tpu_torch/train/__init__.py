"""Training stages of the port: AssessNet pretext pretraining, QA data
generation and AssessNet training; the agent's reward production,
pretraining data and Q-learning (``produce_reward`` → ``pretrain_agent`` →
``train_agent``) over the shared rollout loop (``rollout``)."""
