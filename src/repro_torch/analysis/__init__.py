"""Port of ``repro.analysis``: the plan-time static analyzer
(:mod:`repro_torch.analysis.plancheck`)."""
