"""Evaluation harness of the port (`eval/harness.py`)."""
