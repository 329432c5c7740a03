"""Scenario-axis placement helpers of the port (one card for now)."""
