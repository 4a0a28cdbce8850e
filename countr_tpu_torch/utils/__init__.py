"""Metrics, visual outputs and tracing of the port's CLIs."""
