"""Particle state, colliders, the implicit objective and the time step."""

from hot_tpu_torch.sim.simulation import Simulation, advance_one_step  # noqa: F401
