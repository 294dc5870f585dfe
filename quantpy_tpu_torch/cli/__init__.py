"""Console entry points: point estimates and confidence intervals from JSON
records of measured counts (`state_interval`, `process_interval`)."""
