"""Measurement tools for the port's kernels: ``kernel_variants`` runs on a CUDA card,
``declared_costs`` anywhere."""
