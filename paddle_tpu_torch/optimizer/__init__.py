"""Optimizer updates for the port's train steps."""
