"""Device-facing utilities: QPU layouts of the noise models, gate counts,
QASM export, job records and execution backends."""
