"""Inverse problems for the SSA (port of ``pism_tpu/inverse/``): the
design-variable parameterizations, the bounded L-BFGS driver and the tau_c
and hardness inversions with adjoint gradients."""
