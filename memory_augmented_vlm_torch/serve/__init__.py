"""Serving of the port: the continuous-batching engine (`batch_engine.py`)."""
