"""Solvers: result types and the fleet engine."""
