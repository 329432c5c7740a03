from repro_torch.kernels.pa_elasticity.ops import pa_elasticity

__all__ = ["pa_elasticity"]
