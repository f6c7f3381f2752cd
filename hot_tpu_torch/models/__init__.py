"""Constitutive models."""
