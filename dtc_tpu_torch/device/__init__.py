"""Device layouts of the noise models."""
