"""Device-resident training pipeline."""
