"""Validation and simulation tools of the port (EstimateROC,
KmerStatSimulator, GetHistogramStats, AlignmentTry)."""
