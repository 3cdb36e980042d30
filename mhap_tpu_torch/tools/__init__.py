"""Validation tools of the port (EstimateROC)."""
