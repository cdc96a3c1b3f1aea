"""The benchmark's plain reference: frozen constants and physics, in plain
PyTorch, importing nothing of the system under test."""
