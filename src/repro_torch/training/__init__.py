"""Training: AdamW, the synthetic data pipeline, the train state and the loop."""
