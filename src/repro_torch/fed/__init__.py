"""Silo-level federated learning: clients, aggregation, batched scoring."""
