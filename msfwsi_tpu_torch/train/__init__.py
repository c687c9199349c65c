"""Training steps, optimizers and weight conversion."""
