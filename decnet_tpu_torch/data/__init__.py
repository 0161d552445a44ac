"""Demo input/output of the port."""
