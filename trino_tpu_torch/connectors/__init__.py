"""Connectors of the PyTorch engine (the tpch generator so far)."""
