"""Quantum-circuit gate layers as MPOs (QFT so far)."""
