"""Synthetic datasets and silo/client partitioning (numpy only)."""
