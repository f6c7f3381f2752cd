"""Krylov and Newton solvers."""
