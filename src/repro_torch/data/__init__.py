"""Synthetic token data of the port: the Zipf-ish language stream and the
non-IID Dirichlet client mixes (NumPy only, batches equal to the reference's
bit for bit)."""
from .synthetic import SyntheticLM, dirichlet_client_mixes

__all__ = ["SyntheticLM", "dirichlet_client_mixes"]
