from .realnvp import RealNVP

__all__ = ["RealNVP"]
