"""Training stages of the port: AssessNet pretext pretraining, QA data
generation and AssessNet training."""
