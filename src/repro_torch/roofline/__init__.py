"""Roofline of the port: the dry run's per-device counter (`count`) and the
report priced with the H100's peaks (`report`)."""
