"""Hand-written GPU kernels. Each one stays only while it beats the plain
XLA version end to end on the card (PERF.md, "Kernel decisions")."""
